"""Chunk data-model semantics vs the reference (base.cpp)."""

import jax.numpy as jnp
import numpy as np

from ccve.core import chunk as C
import pytest


def _mk(rows):
    return C.from_rows(np.asarray(rows, dtype=np.int64), block_size=8)


def test_roundtrip_rows():
    rows = [[1, 10], [2, 20], [3, 30]]
    ch = _mk(rows)
    np.testing.assert_array_equal(C.to_rows(ch), rows)
    assert ch.n_cols == 2 and ch.block_size == 8


def test_reset_identity_sel():
    ch = _mk([[1, 10], [2, 20]])
    r = C.reset(ch)
    assert int(r.count) == 0
    np.testing.assert_array_equal(np.asarray(r.sel), np.arange(8))


def test_slice_compose():
    # Slice semantics (base.cpp:37-47): sel'[i] = parent.sel[result_vector[i]]
    ch = _mk([[5, 50], [6, 60], [7, 70], [8, 80]])
    # first restrict parent to rows {1,3} via a slice
    rv1 = jnp.asarray([1, 3, 0, 0, 0, 0, 0, 0], jnp.int32)
    s1 = C.slice_compose(ch, rv1, 2)
    np.testing.assert_array_equal(C.to_rows(s1), [[6, 60], [8, 80]])
    # then slice the slice: pick its second live row -> original row 3
    rv2 = jnp.asarray([1, 0, 0, 0, 0, 0, 0, 0], jnp.int32)
    s2 = C.slice_compose(s1, rv2, 1)
    np.testing.assert_array_equal(C.to_rows(s2), [[8, 80]])


def test_compress_indices():
    mask = jnp.asarray([False, True, True, False, True, False, False, False])
    rv, count = C.compress_indices(mask)
    assert int(count) == 3
    np.testing.assert_array_equal(np.asarray(rv)[:3], [1, 2, 4])


def test_append_into_no_overflow():
    dst = jnp.zeros((2, 8), jnp.int64)
    src = _mk([[1, 10], [2, 20], [3, 30]])
    new_dst, cnt, over, over_cnt = C.append_into(dst, jnp.int32(2), src)
    assert int(cnt) == 5 and int(over_cnt) == 0
    np.testing.assert_array_equal(np.asarray(new_dst)[0, 2:5], [1, 2, 3])
    np.testing.assert_array_equal(np.asarray(new_dst)[1, 2:5], [10, 20, 30])


def test_append_into_overflow_split():
    # Mirrors the compactor overflow split (compactor.cpp:22-24): 6 cached +
    # 5 incoming with block 8 -> cache fills to 8, 3 rows wrap into temp.
    dst = jnp.zeros((1, 8), jnp.int64)
    src = C.from_rows(np.asarray([[1], [2], [3], [4], [5]], np.int64), 8)
    new_dst, cnt, over, over_cnt = C.append_into(dst, jnp.int32(6), src)
    assert int(cnt) == 8 and int(over_cnt) == 3
    np.testing.assert_array_equal(np.asarray(new_dst)[0, 6:], [1, 2])
    np.testing.assert_array_equal(np.asarray(over)[0, :3], [3, 4, 5])


def test_append_reads_through_sel():
    # Append must copy through the source's selection vector (base.cpp:15-27).
    parent = _mk([[1, 10], [2, 20], [3, 30], [4, 40]])
    rv = jnp.asarray([2, 0, 0, 0, 0, 0, 0, 0], jnp.int32)
    sliced = C.slice_compose(parent, rv, 1)  # row [3, 30]
    dst = jnp.zeros((2, 8), jnp.int64)
    new_dst, cnt, _, _ = C.append_into(dst, jnp.int32(0), sliced)
    assert int(cnt) == 1
    np.testing.assert_array_equal(np.asarray(new_dst)[:, 0], [3, 30])


def test_gather_rows_masks_dead_lanes():
    ch = _mk([[9, 90]])
    dense = np.asarray(C.gather_rows(ch))
    np.testing.assert_array_equal(dense[:, 0], [9, 90])
    assert (dense[:, 1:] == 0).all()


@pytest.mark.slow
def test_compact_rows_matches_compress_gather():
    """compact_rows (fused masked scatter) == compress_indices followed
    by a dense gather, including the zero tail."""
    import jax.numpy as jnp
    import numpy as np

    from ccve.core.chunk import compact_rows, compress_indices

    rng = np.random.default_rng(5)
    for block, ncols in [(128, 3), (256, 1)]:
        cols = jnp.asarray(
            rng.integers(-(2**40), 2**40, (ncols, block)).astype(np.int64)
        )
        mask = jnp.asarray(rng.random(block) < 0.3)
        dense, cnt = compact_rows(cols, mask)
        sel, cnt2 = compress_indices(mask)
        assert int(cnt) == int(cnt2)
        k = int(cnt)
        expect = np.asarray(cols)[:, np.asarray(sel)[:k]]
        got = np.asarray(dense)
        assert np.array_equal(got[:, :k], expect)
        assert (got[:, k:] == 0).all()
