"""Bulk operator-at-a-time executor vs the scalar oracle."""

import numpy as np
import pytest

from ccve.config import PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table
from ccve.exec.bulk import bulk_count, bulk_materialize
from ccve.exec.oracle import (
    OracleBuildTable,
    assert_same_multiset,
    oracle_pipeline,
)
from ccve.ops.hash_table import build_csr, build_lp


def _workload(n_joins, lhs, rhs, chunk_factor, kind):
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, chunk_factor)
    if kind == "sorted":
        from ccve.ops.sort_merge import build_sorted

        builder = build_sorted
    else:
        builder = build_lp if kind == "lp" else build_csr
    tables = [builder(keys, payloads) for _ in range(n_joins)]
    oracles = [OracleBuildTable(keys, payloads) for _ in range(n_joins)]
    return probe, tables, oracles


@pytest.mark.parametrize("kind", ["lp", "csr"])
@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_bulk_count_matches_oracle(kind, chunk_factor):
    probe, tables, oracles = _workload(2, 900, 80, chunk_factor, kind)
    expected = oracle_pipeline(probe, oracles, PayloadMode.FULL)
    res = bulk_count(tables, probe)
    assert int(res.count) == expected.shape[0]
    # payload checksum per level: sum of the level's payload column
    for l in range(2):
        col = 2 + 2 * l + 1  # n_joins + 2l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


def test_bulk_count_tiled():
    probe, tables, oracles = _workload(3, 700, 64, 2, "lp")
    expected = oracle_pipeline(probe, oracles, PayloadMode.FULL)
    res = bulk_count(tables, probe, tile_rows=128)
    assert int(res.count) == expected.shape[0]


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["lp", "csr", "sorted"])
def test_bulk_materialize_matches_oracle(kind):
    probe, tables, oracles = _workload(2, 300, 48, 2, kind)
    for mode in (PayloadMode.FULL, PayloadMode.REFERENCE):
        expected = oracle_pipeline(probe, oracles, mode)
        got = bulk_materialize(tables, probe, mode)
        assert_same_multiset(got, expected)


def test_lp_match_stats_compacted_lanes():
    """Compacted-lane schedule must agree with the plain full-width path."""
    import jax.numpy as jnp

    from ccve.core.datagen import gen_rhs_table
    from ccve.exec.bulk import lp_match_stats
    from ccve.ops.hash_table import build_lp

    keys, payloads = gen_rhs_table(2048, 2)
    table = build_lp(keys, payloads)
    rng = np.random.default_rng(5)
    probe = jnp.asarray(rng.integers(0, keys.max() + 2, 8192).astype(np.int64))
    a = lp_match_stats(table, probe, compact_lanes=True)
    b = lp_match_stats(table, probe, compact_lanes=False)
    np.testing.assert_array_equal(np.asarray(a.mult), np.asarray(b.mult))
    np.testing.assert_array_equal(np.asarray(a.psum), np.asarray(b.psum))


def test_bulk_variant_tiled_matches_whole():
    """run_bulk_variant(tile_rows=...): tiled LP drain == whole-stream
    counts (counts are additive over tiles)."""
    import jax
    import jax.numpy as jnp

    from ccve.bench.micro import run_bulk_variant
    from ccve.core.datagen import gen_microbench_keys, gen_rhs_table
    from ccve.ops.hash_table import build_lp

    keys = gen_microbench_keys(1 << 12, 128, 1)
    bk, bp = gen_rhs_table(128, 1)
    lp = build_lp(bk, bp)
    kd = jax.device_put(jnp.asarray(keys))
    whole = run_bulk_variant(lp, kd, "w")
    tiled = run_bulk_variant(lp, kd, "t", tile_rows=1 << 10)
    assert whole.tuples == tiled.tuples


def test_lp_match_stats_compact_ladder():
    """The LP drain's survivor-compaction ladder (prefix count +
    scatter between halving stages) must agree exactly with the
    full-width drain."""
    import jax.numpy as jnp

    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import lp_match_stats
    from ccve.ops.hash_table import build_lp

    keys, payloads = gen_rhs_table(2048, 2)
    table = build_lp(keys, payloads)
    probe = gen_probe_table(1 << 16, 1, 2048)[:, 0]
    p = jnp.asarray(probe)
    ref = lp_match_stats(table, p, compact_lanes=False)
    got = lp_match_stats(table, p, compact_lanes=True)
    assert np.array_equal(np.asarray(got.mult), np.asarray(ref.mult))
    assert np.array_equal(np.asarray(got.psum), np.asarray(ref.psum))
