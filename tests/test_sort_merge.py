"""Sort-merge join stats vs the hash paths and the oracle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ccve.config import PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table, gen_zipf_keys
from ccve.exec.bulk import bulk_count, lp_match_stats
from ccve.exec.oracle import OracleBuildTable, oracle_pipeline
from ccve.ops.hash_table import build_lp
from ccve.ops.sort_merge import (
    build_sorted,
    rank_table,
    sorted_build_counts,
    sorted_expand,
    sorted_expand_tiled,
    sorted_match_ranks,
    sorted_match_stats,
    sorted_match_totals,
)


@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_sorted_stats_match_hash_stats(chunk_factor):
    keys, payloads = gen_rhs_table(96, chunk_factor)
    st = build_sorted(keys, payloads)
    lp = build_lp(keys, payloads)
    rng = np.random.default_rng(2)
    probe = jnp.asarray(rng.integers(0, keys.max() + 2, 500).astype(np.int64))
    a = sorted_match_stats(st, probe)
    b = lp_match_stats(lp, probe)
    np.testing.assert_array_equal(np.asarray(a.mult), np.asarray(b.mult))
    np.testing.assert_array_equal(np.asarray(a.psum), np.asarray(b.psum))


def test_sorted_stats_zipf_heavy_hitters():
    keys, payloads = gen_rhs_table(64, 4)  # 4 dups per key
    st = build_sorted(keys, payloads)
    probe = jnp.asarray(gen_zipf_keys(800, 64, alpha=1.4) * (64 // 16))
    lp = build_lp(keys, payloads)
    a = sorted_match_stats(st, probe)
    b = lp_match_stats(lp, probe)
    np.testing.assert_array_equal(np.asarray(a.mult), np.asarray(b.mult))
    np.testing.assert_array_equal(np.asarray(a.psum), np.asarray(b.psum))


def test_bulk_count_with_sorted_tables():
    n_joins = 2
    probe = gen_probe_table(700, n_joins, 80)
    keys, payloads = gen_rhs_table(80, 2)
    tables = [build_sorted(keys, payloads) for _ in range(n_joins)]
    oracles = [OracleBuildTable(keys, payloads)] * n_joins
    expected = oracle_pipeline(probe, oracles, PayloadMode.FULL)
    res = bulk_count(tables, probe)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


def test_sorted_stats_negative_payloads():
    keys = np.array([5, 5, 9, 1], dtype=np.int64)
    payloads = np.array([-10, 3, -7, 2], dtype=np.int64)
    st = build_sorted(keys, payloads)
    probe = jnp.asarray(np.array([5, 9, 1, 4], dtype=np.int64))
    a = sorted_match_stats(st, probe, allow_negative=True)
    np.testing.assert_array_equal(np.asarray(a.mult), [2, 1, 1, 0])
    np.testing.assert_array_equal(np.asarray(a.psum), [-7, -7, 2, 0])


def test_sorted_match_totals():
    keys, payloads = gen_rhs_table(80, 3)
    st = build_sorted(keys, payloads)
    rng = np.random.default_rng(9)
    probe = jnp.asarray(rng.integers(0, keys.max() + 2, 700).astype(np.int64))
    from ccve.ops.sort_merge import sorted_match_totals

    stats = sorted_match_stats(st, probe)
    count, psum = sorted_match_totals(st, probe)
    assert int(count) == int(np.asarray(stats.mult).sum())
    assert int(psum) == int(np.asarray(stats.psum).sum())



def test_packed_totals_path():
    """Range-adaptive single-operand count-side sort (i32 tagged keys)
    must agree with the general two-key path, including out-of-range
    probe keys (clamped)."""
    keys, payloads = gen_rhs_table(200, 2)
    st = build_sorted(keys, payloads)
    assert st.pack32 is not None
    rng = np.random.default_rng(13)
    probe = np.concatenate(
        [
            rng.integers(-50, keys.max() + 60, 1500),
            np.array([keys.min() - 1, keys.max() + 1, 2**40]),
        ]
    ).astype(np.int64)
    pd = jnp.asarray(probe)
    general = dataclasses.replace(st, pack32=None, span62=False)
    c_ref, p_ref = sorted_match_totals(general, pd)
    c_pk, p_pk = sorted_match_totals(st, pd)
    assert int(c_pk) == int(c_ref)
    assert int(p_pk) == int(p_ref)


def test_pack_meta_rejects_wide_ranges():
    keys = np.array([0, 2**61], dtype=np.int64)
    payloads = np.array([5, 6], dtype=np.int64)
    st = build_sorted(keys, payloads)
    assert st.pack32 is None  # falls back to the int64 tagged stream
    assert st.span62
    probe = jnp.asarray(np.array([0, 2**61, 7], dtype=np.int64))
    c, p = sorted_match_totals(st, probe)
    assert int(c) == 2 and int(p) == 11


# ---------------------------------------------------------------------------
# Every route against NumPy: stream lengths odd, below and above a
# power-of-two boundary; negative keys; probes outside the build range
# ---------------------------------------------------------------------------

SIZES = [100, 2048, 4095, 5000, 16385, 33333]

# key span of the build table -> which count-side stream it takes
SPANS = {
    "pack32": (-1000, 5000),  # i32 tagged stream
    "span62": (-(2**40), 2**40),  # int64 tagged stream
    "full": (np.iinfo(np.int64).min + 5, np.iinfo(np.int64).max - 5),
}


def _numpy_setup(n, span, seed):
    """Build table (m ~ n/8, duplicates included) and probes: half drawn
    from the build keys, half uniform over twice the build range (so
    below and above it), plus the int64 extremes."""
    lo, hi = SPANS[span]
    rng = np.random.default_rng(seed)
    m = max(n // 8, 3)
    keys = rng.integers(lo, hi, m, dtype=np.int64)
    keys[: m // 4] = keys[m // 4 : 2 * (m // 4)]  # duplicate runs
    payloads = rng.integers(-(2**40), 2**40, m, dtype=np.int64)
    wide_lo = max(2 * lo, np.iinfo(np.int64).min) if lo < 0 else -hi
    wide_hi = min(2 * hi, np.iinfo(np.int64).max)
    probe = np.concatenate(
        [
            rng.choice(keys, n // 2),
            rng.integers(wide_lo, wide_hi, n - n // 2 - 2, dtype=np.int64),
            np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max]),
        ]
    )
    rng.shuffle(probe)
    table = build_sorted(keys, payloads)
    assert (table.pack32 is not None) == (span == "pack32")
    assert table.span62 == (span != "full")
    return table, keys, payloads, probe


def _numpy_stats(keys, payloads, probe):
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    lo = np.searchsorted(sk, probe, "left")
    hi = np.searchsorted(sk, probe, "right")
    cpay = np.concatenate([[0], np.cumsum(payloads[order])])
    return sk, lo, hi - lo, cpay[hi] - cpay[lo]


@pytest.mark.parametrize("span", list(SPANS))
@pytest.mark.parametrize("n", SIZES)
def test_count_side_matches_numpy(n, span):
    """Per-build-row counts and totals on each count-side route."""
    table, keys, payloads, probe = _numpy_setup(n, span, seed=n)
    sk, _, mult, psum = _numpy_stats(keys, payloads, probe)
    bc = np.asarray(sorted_build_counts(table, jnp.asarray(probe)))
    assert np.array_equal(bc, np.searchsorted(np.sort(probe), sk, "right")
                          - np.searchsorted(np.sort(probe), sk, "left"))
    c, p = sorted_match_totals(table, jnp.asarray(probe))
    assert int(c) == int(mult.sum())
    assert int(p) == int(psum.sum())


@pytest.mark.parametrize("n", SIZES)
def test_stats_matches_numpy(n):
    """Per-probe (mult, psum) in probe order, negative payloads through
    the segmented-scan base recovery."""
    table, keys, payloads, probe = _numpy_setup(n, "span62", seed=n + 1)
    _, _, mult, psum = _numpy_stats(keys, payloads, probe)
    st = sorted_match_stats(table, jnp.asarray(probe), allow_negative=True)
    assert np.array_equal(np.asarray(st.mult), mult)
    assert np.array_equal(np.asarray(st.psum), psum)


@pytest.mark.parametrize("n", SIZES)
def test_ranks_matches_numpy(n):
    """(mult, start) from the rank twin: start is the first matching row
    of the SORTED table."""
    table, keys, payloads, probe = _numpy_setup(n, "pack32", seed=n + 2)
    _, start, mult, _ = _numpy_stats(keys, payloads, probe)
    m_got, s_got = sorted_match_ranks(rank_table(table), jnp.asarray(probe))
    m_got, s_got = np.asarray(m_got), np.asarray(s_got)
    assert np.array_equal(m_got, mult)
    assert np.array_equal(s_got[mult > 0], start[mult > 0])


@pytest.mark.parametrize("n", SIZES)
def test_expand_matches_numpy(n):
    """Every matched (row, key, payload) triple, exactly once, with the
    prefix-count + scatter compaction."""
    table, keys, payloads, probe = _numpy_setup(n, "pack32", seed=n + 3)
    order = np.argsort(keys, kind="stable")
    sk, sp = keys[order], payloads[order]
    lo = np.searchsorted(sk, probe, "left")
    hi = np.searchsorted(sk, probe, "right")
    expected = sorted(
        (i, int(sk[j]), int(sp[j]))
        for i in range(n)
        for j in range(lo[i], hi[i])
    )
    cap = n * table.max_mult
    rows, k, p, total = sorted_expand(table, jnp.asarray(probe), cap)
    rows, k, p = map(np.asarray, (rows, k, p))
    got = sorted(
        (int(r), int(a), int(b)) for r, a, b in zip(rows, k, p) if r >= 0
    )
    assert int(total) == len(expected)
    assert got == expected
    assert (rows[len(expected):] == -1).all()


@pytest.mark.parametrize("probe_dtype", [np.int64, np.int32])
def test_pack32_out_of_range_probes(probe_dtype):
    """Probe keys outside the build range (below kmin, above kmax, the
    column type's extremes) clamp to matchless keys on the i32 stream,
    for a narrow (i32) and a wide (int64) probe column alike."""
    keys = (np.arange(500, dtype=np.int64) * 7) + 1000  # kmin=1000
    payloads = np.arange(500, dtype=np.int64) + 1
    st = build_sorted(keys, payloads)
    assert st.pack32 is not None
    rng = np.random.default_rng(3)
    lo = np.iinfo(probe_dtype).min
    hi = np.iinfo(probe_dtype).max
    probe = np.concatenate(
        [
            rng.choice(keys, 9000),
            np.full(200, lo),
            np.full(200, hi),
            np.array([999, 1000, int(keys[-1]), int(keys[-1]) + 1] * 50),
            rng.integers(-5000, 10000, 500),
        ]
    ).astype(probe_dtype)
    _, _, mult, psum = _numpy_stats(keys, payloads, probe.astype(np.int64))
    c, p = sorted_match_totals(st, jnp.asarray(probe))
    assert int(c) == int(mult.sum())
    assert int(p) == int(psum.sum())


@pytest.mark.slow
def test_sorted_expand_matches_bruteforce():
    """Gather-free materialization: exact multiset of matched
    (probe_row, build_key, build_payload) triples, overflow reported."""
    from ccve.ops.sort_merge import sorted_expand

    rng = np.random.default_rng(5)
    keys = np.repeat(np.arange(40, dtype=np.int64) * 3, 3)  # mult 3
    payloads = np.arange(keys.size, dtype=np.int64) + 500
    st = build_sorted(keys, payloads)
    assert st.max_mult == 3
    probe = rng.integers(0, 125, 300).astype(np.int64)

    expected = sorted(
        (i, int(k), int(p))
        for i, pk in enumerate(probe)
        for k, p in zip(keys, payloads)
        if k == pk
    )

    cap = 4096
    rows, mkeys, mpays, total = sorted_expand(st, jnp.asarray(probe), cap)
    rows, mkeys, mpays = map(np.asarray, (rows, mkeys, mpays))
    got = sorted(
        (int(r), int(k), int(p))
        for r, k, p in zip(rows, mkeys, mpays)
        if r >= 0
    )
    assert int(total) == len(expected)
    assert got == expected

    # tight capacity: truncated but correctly reported
    rows2, _, _, total2 = sorted_expand(st, jnp.asarray(probe), 8)
    assert int(total2) == len(expected)
    assert int((np.asarray(rows2) >= 0).sum()) == 8


@pytest.mark.slow
def test_sorted_match_ranks():
    """(mult, start) recovered from the rank-index twin's payload sums
    vs searchsorted ground truth, duplicates + missing keys included."""
    import numpy as np

    from ccve.ops.sort_merge import rank_table, sorted_match_ranks

    rng = np.random.default_rng(11)
    for m, dom, n in [(100, 60, 500), (64, 64, 64), (1000, 5, 333)]:
        keys = rng.integers(0, dom, m).astype(np.int64)
        st = build_sorted(keys, np.arange(m, dtype=np.int64))
        rt = rank_table(st)
        probe = rng.integers(-3, dom + 3, n).astype(np.int64)
        mult, start = sorted_match_ranks(rt, jnp.asarray(probe))
        mult, start = np.asarray(mult), np.asarray(start)
        sk = np.sort(keys)
        e_start = np.searchsorted(sk, probe, side="left")
        e_mult = np.searchsorted(sk, probe, side="right") - e_start
        assert np.array_equal(mult, e_mult), (m, dom, n)
        live = e_mult > 0
        assert np.array_equal(start[live], e_start[live]), (m, dom, n)



def test_sorted_expand_tiled_matches_monolithic():
    """Capacity auto-tiling (sorted_expand_tiled): the per-tile triple
    multiset with GLOBAL row ids must equal the monolithic expand's,
    including a non-dividing tile size (sentinel-padded last tile) and
    a multiplicity > 1 table."""
    from ccve.ops.sort_merge import sorted_expand, sorted_expand_tiled

    rng = np.random.default_rng(9)
    keys = np.repeat(np.arange(50, dtype=np.int64) * 2 + 7, 2)  # mult 2
    payloads = np.arange(keys.size, dtype=np.int64) + 900
    st = build_sorted(keys, payloads)
    probe = rng.integers(0, 120, 1000).astype(np.int64)

    cap = probe.size * st.max_mult
    r0, k0, p0, t0 = sorted_expand(st, jnp.asarray(probe), cap)
    mono = sorted(
        (int(r), int(k), int(p))
        for r, k, p in zip(np.asarray(r0), np.asarray(k0), np.asarray(p0))
        if r >= 0
    )

    for tile in (1000, 256, 384):  # mono path, dividing, non-dividing
        tiles, total = sorted_expand_tiled(st, probe, tile_rows=tile)
        assert total == int(t0)
        got = sorted(
            (int(r), int(k), int(p))
            for rows, mk, mp, _tt in tiles
            for r, k, p in zip(
                np.asarray(rows), np.asarray(mk), np.asarray(mp)
            )
            if r >= 0
        )
        assert got == mono, f"tile={tile}"
        if tile < probe.size:
            assert len(tiles) == -(-probe.size // tile)



def test_sorted_expand_tiled_empty_table():
    """An empty build table with a probe stream longer than one tile:
    no pad key can be read off the table, nothing matches, every tile
    is empty."""
    st = build_sorted(np.zeros(0, np.int64), np.zeros(0, np.int64))
    probe = np.arange(1000, dtype=np.int64)
    tiles, total = sorted_expand_tiled(st, probe, tile_rows=384)
    assert total == 0
    assert len(tiles) == 3
    for rows, _, _, t in tiles:
        assert int(t) == 0
        assert (np.asarray(rows) == -1).all()
