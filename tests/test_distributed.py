"""Distributed hash-partitioned join on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from ccve.config import PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table
from ccve.exec.oracle import OracleBuildTable, oracle_pipeline
from ccve.parallel.distributed import (
    dist_bulk_count,
    make_join_mesh,
    partition_tables,
)


@pytest.mark.parametrize("kind", ["lp", "csr", "sorted"])
@pytest.mark.parametrize("n_devices", [2, 8])
def test_dist_count_matches_oracle(kind, n_devices):
    mesh = make_join_mesh(n_devices)
    n_joins, lhs, rhs = 2, 600, 64
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    ptables = [
        partition_tables(keys, payloads, n_devices, kind, mesh)
        for _ in range(n_joins)
    ]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count(mesh, ptables, probe, cap_slack=8.0)
    assert not bool(res.overflow)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())
    assert float(res.skew) >= 1.0


def test_dist_skew_detection():
    """All-identical probe keys land on one partition: skew ≈ P."""
    mesh = make_join_mesh(4)
    rhs = 32
    keys, payloads = gen_rhs_table(rhs, 1)
    probe = np.full((400, 1), keys[3], dtype=np.int64)
    ptables = [partition_tables(keys, payloads, 4, "lp", mesh)]
    res = dist_bulk_count(mesh, ptables, probe, cap_slack=16.0)
    assert not bool(res.overflow)
    assert int(res.count) == 400
    assert float(res.skew) > 3.0


def test_dist_overflow_flag():
    """cap too small for a skewed shuffle must raise the overflow flag."""
    mesh = make_join_mesh(4)
    keys, payloads = gen_rhs_table(32, 1)
    probe = np.full((512, 1), keys[0], dtype=np.int64)
    ptables = [partition_tables(keys, payloads, 4, "lp", mesh)]
    res = dist_bulk_count(mesh, ptables, probe, cap_slack=0.1)
    assert bool(res.overflow)


def test_dist_ring_matches_oracle():
    from ccve.parallel.distributed import (
        dist_bulk_count_ring,
        partition_tables_block,
    )

    mesh = make_join_mesh(4)
    n_joins, lhs, rhs = 2, 500, 64
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    ptables = [
        partition_tables_block(keys, payloads, 4, kind, mesh)
        for kind in ("lp", "csr")
    ]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count_ring(mesh, ptables, probe)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


def test_dist_ring_chunked_matches_serial():
    """Pipelined ring (n_chunks>1) must agree exactly with the
    serialized ring, including when per-device rows don't divide the
    chunk count (padding path)."""
    from ccve.parallel.distributed import (
        dist_bulk_count_ring,
        partition_tables_block,
    )

    mesh = make_join_mesh(4)
    n_joins, lhs, rhs = 2, 493, 64  # 493: uneven across 4 devs x chunks
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    ptables = [
        partition_tables_block(keys, payloads, 4, "lp", mesh)
        for _ in range(n_joins)
    ]
    a = dist_bulk_count_ring(mesh, ptables, probe, n_chunks=1)
    b = dist_bulk_count_ring(mesh, ptables, probe, n_chunks=4)
    assert int(a.count) == int(b.count)
    assert np.array_equal(
        np.asarray(a.payload_checksums), np.asarray(b.payload_checksums)
    )


def test_dist_hot_split_beats_skew():
    """PRPD heavy-hitter split: a probe stream dominated by one key
    overflows the plain shuffle at tight capacity, while the split path
    keeps the hot key out of the shuffle entirely — correct counts, no
    overflow, low skew."""
    from ccve.parallel.distributed import (
        detect_heavy_hitters,
        partition_tables_split,
    )

    mesh = make_join_mesh(4)
    rhs = 64
    keys, payloads = gen_rhs_table(rhs, 2)
    rng = np.random.default_rng(7)
    cold = rng.choice(keys, 200)
    probe = np.concatenate([np.full(600, keys[5]), cold])
    rng.shuffle(probe)
    probe = probe.reshape(-1, 1).astype(np.int64)

    plain = [partition_tables(keys, payloads, 4, "lp", mesh)]
    res_plain = dist_bulk_count(mesh, plain, probe, cap_slack=1.2)
    assert bool(res_plain.overflow)  # the hot key swamps its owner

    hot = detect_heavy_hitters(probe[:, 0], max_hot=4, min_frac=0.05)
    assert keys[5] in hot
    split = [
        partition_tables_split(keys, payloads, 4, hot, "lp", mesh)
    ]
    res = dist_bulk_count(mesh, split, probe, cap_slack=1.2)
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)], PayloadMode.FULL
    )
    assert not bool(res.overflow)
    assert int(res.count) == expected.shape[0]
    assert int(res.payload_checksums[0]) == int(expected[:, 2].sum())
    assert float(res.skew) < 2.5


def test_dist_hot_split_multilevel_mixed():
    """A HotSplitTables level can coexist with plain partitioned levels
    in one N-way pipeline."""
    from ccve.parallel.distributed import (
        detect_heavy_hitters,
        partition_tables_split,
    )

    mesh = make_join_mesh(4)
    n_joins, lhs, rhs = 2, 500, 64
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    hot = detect_heavy_hitters(probe[:, 0], max_hot=8, min_frac=0.01)
    lv0 = partition_tables_split(keys, payloads, 4, hot, "lp", mesh)
    lv1 = partition_tables(keys, payloads, 4, "csr", mesh)
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count(mesh, [lv0, lv1], probe, cap_slack=8.0)
    assert not bool(res.overflow)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
@pytest.mark.parametrize("kind", ["lp", "sorted"])
def test_dist_hier_matches_oracle(shape, kind):
    """Hierarchical (dcn, ici) 2-hop shuffle vs the oracle — an ICI hop
    to the owner's chip column, then keys cross the dcn axis exactly
    once in host-aggregated grids, landing at their owner."""
    from ccve.parallel.distributed import (
        dist_bulk_count_hier,
        make_join_mesh_2d,
        partition_tables,
    )

    D, I = shape
    mesh = make_join_mesh_2d(D, I)
    n_parts = D * I
    n_joins, lhs, rhs = 2, 600, 64
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    ptables = [
        partition_tables(keys, payloads, n_parts, kind, mesh)
        for _ in range(n_joins)
    ]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count_hier(mesh, ptables, probe, cap_slack=8.0)
    assert not bool(res.overflow)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


def test_dist_hier_overflow_detected():
    """Tight caps must flag overflow rather than silently drop keys."""
    from ccve.parallel.distributed import (
        dist_bulk_count_hier,
        make_join_mesh_2d,
        partition_tables,
    )

    mesh = make_join_mesh_2d(2, 4)
    rhs = 64
    keys, payloads = gen_rhs_table(rhs, 2)
    # every probe is the same key: one owner partition swamps its hops
    probe = np.full((400, 1), int(keys[3]), np.int64)
    ptables = [partition_tables(keys, payloads, 8, "lp", mesh)]
    res = dist_bulk_count_hier(mesh, ptables, probe, cap_slack=1.1)
    assert bool(res.overflow)


@pytest.mark.slow
@pytest.mark.parametrize("n_devices", [2, 8])
def test_dist_expand_matches_single_chip(n_devices):
    """Materialized distributed join == single-chip sorted_expand as a
    triple multiset (the north star's bit-identical-results bar)."""
    import jax.numpy as jnp

    from ccve.ops.sort_merge import build_sorted, sorted_expand
    from ccve.parallel.distributed import dist_bulk_expand

    rng = np.random.default_rng(13)
    mesh = make_join_mesh(n_devices)
    keys, payloads = gen_rhs_table(64, 3)  # multiplicity 3
    probe = rng.integers(0, 70, 500).astype(np.int64)

    st = build_sorted(keys, payloads)
    cap = probe.shape[0] * st.max_mult
    r0, k0, p0, t0 = sorted_expand(st, jnp.asarray(probe), cap)
    ref = sorted(
        (int(a), int(b), int(c))
        for a, b, c in zip(np.asarray(r0), np.asarray(k0), np.asarray(p0))
        if a >= 0
    )

    ptable = partition_tables(keys, payloads, n_devices, "sorted", mesh)
    assert ptable.max_bound == st.max_mult
    res = dist_bulk_expand(mesh, ptable, probe, cap_slack=8.0)
    assert not bool(res.overflow)
    assert int(res.total) == int(t0) == len(ref)
    got = sorted(tuple(t) for t in res.triples().tolist())
    assert got == ref


@pytest.mark.parametrize("payload_mode", ["reference", "full"])
def test_dist_pipeline_expand_matches_oracle(payload_mode):
    """N=3-level distributed MATERIALIZED join == oracle_pipeline as a
    row multiset — the north star's bit-identical-results bar for the
    full N-way pipeline, not one level."""
    from ccve.config import PayloadMode
    from ccve.exec.oracle import (
        OracleBuildTable,
        assert_same_multiset,
        oracle_pipeline,
    )
    from ccve.parallel.distributed import dist_pipeline_expand

    mode = (
        PayloadMode.REFERENCE
        if payload_mode == "reference"
        else PayloadMode.FULL
    )
    rng = np.random.default_rng(29)
    mesh = make_join_mesh(4)
    n_levels = 3
    keys, payloads = gen_rhs_table(48, 2)  # multiplicity 2
    probe = rng.integers(0, 96, (600, n_levels)).astype(np.int64)

    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_levels, mode
    )
    ptables = [
        partition_tables(keys, payloads, 4, "sorted", mesh)
        for _ in range(n_levels)
    ]
    res = dist_pipeline_expand(mesh, ptables, probe, cap_slack=8.0)
    assert not bool(res.overflow)
    assert int(res.total) == expected.shape[0]
    rows = res.materialize(probe, mode)
    assert_same_multiset(rows, expected)


def test_dist_pipeline_expand_level_caps():
    """Bounded per-level carry (level_caps): a 4-level multiplicity-4
    join whose worst-case ladder would multiply state by ~8x/level runs
    with per-shard state <= 2x the true live rows, stays multiset-exact,
    and detects (not drops) a cap violation."""
    from ccve.config import PayloadMode
    from ccve.exec.oracle import (
        OracleBuildTable,
        assert_same_multiset,
        oracle_pipeline,
    )
    from ccve.parallel.distributed import dist_pipeline_expand

    rng = np.random.default_rng(31)
    n_parts = 4
    mesh = make_join_mesh(n_parts)
    n_levels = 4
    keys, payloads = gen_rhs_table(32, 4)  # multiplicity 4 (F=4)
    # ~40% per-level hit rate: live rows stay roughly flat across levels
    probe = rng.integers(0, 80, (400, n_levels)).astype(np.int64)

    oracles = [OracleBuildTable(keys, payloads)] * n_levels
    expected = oracle_pipeline(probe, oracles, PayloadMode.FULL)

    # true live rows after each level (numpy): product of multiplicities
    key_mult = np.zeros(81, np.int64)
    uk, cnt = np.unique(keys, return_counts=True)
    key_mult[uk] = cnt
    live = np.ones(probe.shape[0], np.int64)
    per_level_live = []
    for l in range(n_levels):
        live = live * key_mult[probe[:, l]]
        per_level_live.append(int(live.sum()))

    ptables = [
        partition_tables(keys, payloads, n_parts, "sorted", mesh)
        for _ in range(n_levels)
    ]
    # per-SHARD cap = 2x the global live rows / n_parts (+ slack for
    # shard imbalance: ownership is hashed, not balanced)
    level_caps = [
        max(2 * lv // n_parts + 64, 64) for lv in per_level_live
    ]
    res = dist_pipeline_expand(
        mesh, ptables, probe, cap_slack=8.0, level_caps=level_caps
    )
    assert not bool(res.overflow)
    assert int(res.total) == expected.shape[0]
    # the bounded ladder really is bounded: final state = caps[-1]/shard
    assert res.rid.shape[0] == n_parts * level_caps[-1]
    rows = res.materialize(probe, PayloadMode.FULL)
    assert_same_multiset(rows, expected)

    # a violated cap must raise the overflow flag, never silently drop
    tiny = [max(c // 64, 2) for c in level_caps]
    res2 = dist_pipeline_expand(
        mesh, ptables, probe, cap_slack=8.0, level_caps=tiny
    )
    assert bool(res2.overflow)


# ---------------------------------------------------------------------------
# Broadcast (replicated-build) tier — the shuffle amortization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lp", "csr", "sorted"])
@pytest.mark.parametrize("n_devices", [2, 8])
def test_dist_bcast_matches_oracle(kind, n_devices):
    from ccve.parallel.distributed import (
        dist_bulk_count_bcast,
        replicate_tables,
    )

    mesh = make_join_mesh(n_devices)
    n_joins, lhs, rhs = 2, 600, 64
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    rtables = [
        replicate_tables(keys, payloads, kind, mesh) for _ in range(n_joins)
    ]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count_bcast(mesh, rtables, probe)
    assert not bool(res.overflow)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())
    assert float(res.skew) == 1.0


def test_dist_bcast_2d_mesh():
    """The broadcast count runs unchanged on a 2D (dcn, ici) mesh —
    psum over both axes, probe row-sharded over the full device grid."""
    from ccve.parallel.distributed import (
        dist_bulk_count_bcast,
        make_join_mesh_2d,
        replicate_tables,
    )

    mesh = make_join_mesh_2d(2, 4)
    n_joins, lhs, rhs = 3, 777, 32
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 1)
    rtables = [
        replicate_tables(keys, payloads, "sorted", mesh)
        for _ in range(n_joins)
    ]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.FULL
    )
    res = dist_bulk_count_bcast(mesh, rtables, probe)
    assert int(res.count) == expected.shape[0]
    for l in range(n_joins):
        col = n_joins + 2 * l + 1
        assert int(res.payload_checksums[l]) == int(expected[:, col].sum())


def test_dist_bcast_agrees_with_shuffle():
    """Broadcast and radix-shuffle paths are different communication
    plans for the SAME join: their counts/checksums must agree exactly."""
    from ccve.parallel.distributed import (
        dist_bulk_count_bcast,
        replicate_tables,
    )

    mesh = make_join_mesh(4)
    n_joins, lhs, rhs = 2, 900, 128
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 4)
    ptables = [
        partition_tables(keys, payloads, 4, "sorted", mesh)
        for _ in range(n_joins)
    ]
    rtables = [
        replicate_tables(keys, payloads, "sorted", mesh)
        for _ in range(n_joins)
    ]
    shuf = dist_bulk_count(mesh, ptables, probe, cap_slack=8.0)
    bcast = dist_bulk_count_bcast(mesh, rtables, probe)
    assert not bool(shuf.overflow)
    assert int(bcast.count) == int(shuf.count)
    assert np.array_equal(
        np.asarray(bcast.payload_checksums),
        np.asarray(shuf.payload_checksums),
    )
