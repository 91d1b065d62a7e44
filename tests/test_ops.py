"""Filter, hash aggregate, radix sort vs NumPy oracles."""

import jax.numpy as jnp
import numpy as np
import pytest

from ccve.core.chunk import Chunk, from_rows, to_rows
from ccve.core.datagen import gen_zipf_keys
from ccve.ops import filter as flt
from ccve.ops.aggregate import dense_aggregate, hash_aggregate
from ccve.ops.sort import radix_argsort, radix_sort, radix_sort_pairs


def test_filter_chunk_composes_selection():
    block = 128
    rows = np.arange(100, dtype=np.int64).reshape(-1, 1)
    c = from_rows(rows, block)
    out = flt.filter_chunk(c, flt.mod_eq(3, 0), col=0)
    got = to_rows(out)[:, 0]
    np.testing.assert_array_equal(got, np.arange(0, 100, 3))
    # zero-copy: same storage
    assert out.cols is c.cols


def test_filter_on_sliced_chunk():
    block = 128
    rows = np.arange(128, dtype=np.int64).reshape(-1, 1)
    base = from_rows(rows, block)
    first = flt.filter_chunk(base, flt.lt(60), col=0)
    second = flt.filter_chunk(first, flt.ge(50), col=0)
    np.testing.assert_array_equal(to_rows(second)[:, 0], np.arange(50, 60))


def test_hash_aggregate_matches_numpy():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, size=1000).astype(np.int64)
    vals = rng.integers(-100, 100, size=1000).astype(np.int64)
    res = hash_aggregate(jnp.asarray(keys), jnp.asarray(vals))
    ng = int(res.n_groups)
    got = {
        int(res.keys[g]): (
            int(res.count[g]),
            int(res.sum[g]),
            int(res.min[g]),
            int(res.max[g]),
        )
        for g in range(ng)
    }
    uniq = np.unique(keys)
    assert ng == uniq.shape[0]
    for k in uniq:
        m = keys == k
        assert got[int(k)] == (
            int(m.sum()),
            int(vals[m].sum()),
            int(vals[m].min()),
            int(vals[m].max()),
        )


def test_dense_aggregate_matches_hash_aggregate():
    keys = gen_zipf_keys(2000, 64, alpha=1.2)
    vals = np.arange(2000, dtype=np.int64)
    d = dense_aggregate(jnp.asarray(keys), jnp.asarray(vals), 64)
    h = hash_aggregate(jnp.asarray(keys), jnp.asarray(vals))
    assert int(d.n_groups) == int(h.n_groups)
    for g in range(int(h.n_groups)):
        k = int(h.keys[g])
        assert int(d.count[k]) == int(h.count[g])
        assert int(d.sum[k]) == int(h.sum[g])


@pytest.mark.parametrize("n", [512, 4096 * 3 + 17])
def test_radix_sort_matches_numpy(n):
    rng = np.random.default_rng(1)
    keys = rng.integers(-(2**62), 2**62, size=n).astype(np.int64)
    got = np.asarray(radix_sort(jnp.asarray(keys), tile=256, bits=64))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_radix_argsort_stable():
    keys = np.array([3, 1, 3, 1, 2, 2, 3] * 40, dtype=np.int64)
    perm = np.asarray(radix_argsort(jnp.asarray(keys), tile=128, bits=8))
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))


def test_radix_sort_pairs_zipf():
    keys = gen_zipf_keys(3000, 256, alpha=1.3)
    vals = np.arange(3000, dtype=np.int64)
    k, v = radix_sort_pairs(jnp.asarray(keys), jnp.asarray(vals), tile=256, bits=16)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[order])
    np.testing.assert_array_equal(np.asarray(v), vals[order])


def test_join_dense_aggregate_matches_scatter_path():
    """Aggregate pushdown (join_dense_aggregate) == per-probe psum
    scatter aggregate, on the config-4 shape at small scale."""
    from ccve.core.datagen import gen_rhs_table, gen_zipf_keys
    from ccve.ops.aggregate import join_dense_aggregate
    from ccve.ops.sort_merge import build_sorted, sorted_match_stats

    domain = 257
    keys, payloads = gen_rhs_table(domain, 1)
    table = build_sorted(keys, payloads)
    probe = jnp.asarray(gen_zipf_keys(5000, domain, 1.1))

    stats = sorted_match_stats(table, probe)
    ref = dense_aggregate(probe, stats.psum, domain)
    got, total = join_dense_aggregate(table, probe, domain)

    assert int(total) == int(stats.mult.astype(jnp.int64).sum())
    for field in ("keys", "count", "sum", "min", "max"):
        assert np.array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
        ), field
    assert int(got.n_groups) == int(ref.n_groups)


def test_sorted_build_counts_matches_numpy():
    from ccve.ops.sort_merge import build_sorted, sorted_build_counts

    rng = np.random.default_rng(11)
    bk = rng.integers(0, 500, 300)  # duplicate build keys
    pk = rng.integers(-50, 600, 4000)  # some out-of-range probes
    table = build_sorted(bk)
    bc = np.asarray(sorted_build_counts(table, jnp.asarray(pk)))
    sk = np.sort(bk)
    ref = np.array([(pk == k).sum() for k in sk], np.int32)
    assert np.array_equal(bc, ref)


def test_hash_aggregate_int32_values_accumulate_in_int64():
    """Regression: group sums must not wrap in the value dtype."""
    import jax.numpy as jnp
    import numpy as np

    keys = jnp.zeros(4, jnp.int64)
    vals = jnp.full(4, 2**30, jnp.int32)
    res = hash_aggregate(keys, vals)
    assert res.sum.dtype == jnp.int64
    assert int(res.sum[0]) == 4 * 2**30
    assert int(res.count[0]) == 4
