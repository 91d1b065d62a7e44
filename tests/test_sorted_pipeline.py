"""Sorted-chunk pipelined executor (exec/sorted_pipeline.py) vs the scalar
oracle — same matrix as test_pipeline.py (strategies, payload modes,
multiplicities, prefilter, count-only), both rank modes, and the
count-only drain's scenarios (occupancy, tuner counters, cache splits,
wide keys)."""

import dataclasses

import numpy as np
import pytest

from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table
from ccve.exec.oracle import (
    OracleBuildTable,
    assert_same_multiset,
    oracle_pipeline,
)
from ccve.exec.sorted_pipeline import SortedPipeline
from ccve.ops.sort_merge import build_sorted

BLOCK = 128


def _setup(n_joins, lhs, rhs, chunk_factor, strategy, payload_mode,
           block=BLOCK):
    cfg = EngineConfig(
        block_size=block,
        n_joins=n_joins,
        lhs_size=lhs,
        rhs_size=rhs,
        chunk_factor=chunk_factor,
        strategy=strategy,
        payload_mode=payload_mode,
        collect_tuples=True,
    )
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, chunk_factor)
    tables = [build_sorted(keys, payloads) for _ in range(n_joins)]
    oracles = [OracleBuildTable(keys, payloads) for _ in range(n_joins)]
    expected = oracle_pipeline(probe, oracles, payload_mode)
    return cfg, probe, tables, expected


@pytest.mark.parametrize(
    "strategy",
    [
        CompactionStrategy.NONE,
        CompactionStrategy.FULL,
        CompactionStrategy.BINARY,
    ],
)
def test_sorted_pipeline_matches_oracle(strategy):
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=700, rhs=96, chunk_factor=2,
        strategy=strategy, payload_mode=PayloadMode.FULL,
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


def test_sorted_pipeline_reference_mode():
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=400, rhs=64, chunk_factor=1,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=4096)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    assert (out["rows"][:, cfg.n_joins] == 0).all()


def test_sorted_pipeline_dynamic_strategy():
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=600, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, threshold_arms=(0, 32, 64, 128), tuner_segment_chunks=2
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)


def test_sorted_pipeline_three_way_high_multiplicity():
    cfg, probe, tables, expected = _setup(
        n_joins=3, lhs=220, rhs=32, chunk_factor=4,
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 17)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


@pytest.mark.parametrize(
    "strategy", [CompactionStrategy.NONE, CompactionStrategy.FULL]
)
def test_sorted_pipeline_branchy_descend(strategy):
    """The lax.cond skip of the deeper static subtree on empty emissions
    (EngineConfig.branchy_descend) must be observationally identical to
    the branch-free recursion."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=700, rhs=96, chunk_factor=2,
        strategy=strategy, payload_mode=PayloadMode.FULL,
    )
    outs = []
    for branchy in (False, True):
        c = dataclasses.replace(cfg, branchy_descend=branchy)
        pipe = SortedPipeline(tables, c, result_capacity=8192)
        out = pipe.run(probe)
        assert out["count"] == expected.shape[0]
        assert_same_multiset(out["rows"], expected)
        outs.append(out)
    assert outs[0]["count"] == outs[1]["count"]


def test_sorted_pipeline_per_level_thresholds():
    """compact_threshold_per_level: level thresholds (0, block, 0) —
    level 1 compacts fully, levels 0/2 pass through at trace time —
    must still match the oracle multiset exactly."""
    cfg, probe, tables, expected = _setup(
        n_joins=3, lhs=500, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, compact_threshold_per_level=(0, BLOCK, 0)
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 15)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


def test_sorted_pipeline_dynamic_cond_compact():
    """DYNAMIC + branchy: the lax.cond around the compactor (threshold 0
    skips it at runtime) must keep the result multiset oracle-exact."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=600, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, branchy_descend=True, threshold_arms=(0, BLOCK)
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)


def test_sorted_pipeline_device_tuner():
    """DYNAMIC with the ON-DEVICE bandit on the sorted executor: the
    inherited _run_device_dynamic drives the overridden _one_chunk and
    the cost-aware stream-efficiency reward; result stays oracle-exact
    and greedy thresholds are read back."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, device_tuner=True, threshold_arms=(0, BLOCK),
        tuner_segment_chunks=2,
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 14)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    assert out["greedy_thresholds"].shape == (2,)
    assert set(out["greedy_thresholds"].tolist()) <= {0, BLOCK}


def test_sorted_pipeline_count_only():
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=500, rhs=64, chunk_factor=1,
        strategy=CompactionStrategy.NONE,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, collect_tuples=False)
    pipe = SortedPipeline(tables, cfg)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]


def test_sorted_pipeline_with_prefilter():
    from ccve.ops import filter as flt

    cfg = EngineConfig(
        block_size=BLOCK, n_joins=2, lhs_size=900, rhs_size=96,
        chunk_factor=2, strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.FULL, collect_tuples=True,
        record_occupancy=True,
    )
    probe = gen_probe_table(900, 2, 96)
    keys, payloads = gen_rhs_table(96, 2)
    tables = [build_sorted(keys, payloads) for _ in range(2)]
    kept = probe[probe[:, 0] % 8 == 0]
    expected = oracle_pipeline(
        kept, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL
    )
    pipe = SortedPipeline(
        tables, cfg, result_capacity=8192,
        prefilter=flt.mod_eq(8, 0), prefilter_col=0,
    )
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    assert out["occupancy"].sum() > 0


def test_chunk_rank_matches_searchsorted():
    """Unit: per-chunk (mult, start) vs NumPy, tables around the block
    size, partial counts, out-of-range keys, duplicates."""
    import jax.numpy as jnp

    from ccve.exec.sorted_pipeline import chunk_rank

    rng = np.random.default_rng(0)
    block = 256
    for m, dom, count in [
        (500, 400, 256), (30, 400, 170), (256, 256, 0), (700, 10, 256),
    ]:
        tk = np.sort(rng.integers(0, dom, m).astype(np.int64))
        keys = rng.integers(-5, dom + 5, block).astype(np.int64)
        valid = np.arange(block) < count
        mult, start = chunk_rank(
            jnp.asarray(tk), jnp.asarray(keys), jnp.asarray(valid)
        )
        mult, start = np.asarray(mult), np.asarray(start)
        e_start = np.searchsorted(tk, keys, side="left")
        e_mult = np.where(
            valid, np.searchsorted(tk, keys, side="right") - e_start, 0
        )
        assert np.array_equal(mult, e_mult), (m, dom, count)
        live = e_mult > 0
        assert np.array_equal(start[live], e_start[live]), (m, dom, count)


@pytest.mark.parametrize("rank_mode", ["batched", "chunk"])
def test_sorted_pipeline_rank_modes_agree(rank_mode):
    """Both rank engines — segment-batched rank columns and the
    per-chunk probe (xla fallback here) — produce the oracle multiset
    on a duplicate-heavy 3-way join with FULL compaction."""
    cfg, probe, tables, expected = _setup(
        n_joins=3, lhs=300, rhs=48, chunk_factor=3,
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 17,
                          rank_mode=rank_mode)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


def test_sorted_pipeline_batched_wide_keys():
    """Batched rank mode with keys far outside the i32 pack range —
    the stats path falls back to the int64 XLA merge, the executor
    must stay oracle-exact (the table-size/key-span bounds that gated
    the per-chunk kernel do NOT gate the batched mode)."""
    cfg = EngineConfig(
        block_size=BLOCK, n_joins=2, lhs_size=400, rhs_size=64,
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
        collect_tuples=True,
    )
    rng = np.random.default_rng(3)
    shift = np.int64(1) << 40
    keys = np.sort(rng.integers(0, 1 << 45, 64).astype(np.int64))
    payloads = np.arange(64, dtype=np.int64) + 7
    probe = np.stack(
        [
            np.concatenate([keys[rng.integers(0, 64, 200)],
                            rng.integers(0, shift, 200)]),
            np.concatenate([keys[rng.integers(0, 64, 200)],
                            rng.integers(0, shift, 200)]),
        ],
        axis=1,
    )
    rng.shuffle(probe, axis=0)
    tables = [build_sorted(keys, payloads) for _ in range(2)]
    assert tables[0].pack32 is None  # key span really is unpackable
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL
    )
    pipe = SortedPipeline(tables, cfg, result_capacity=1 << 15)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)


@pytest.mark.parametrize(
    "strategy",
    [CompactionStrategy.NONE, CompactionStrategy.FULL,
     CompactionStrategy.BINARY],
)
def test_sorted_pipeline_count_collapse(strategy):
    """The final-level count collapse (count-only static runs fold the
    whole drain + compaction into one sum(mult) reduction) must equal
    the collecting run's count on a duplicate-heavy multi-level join."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=64, chunk_factor=3,
        strategy=strategy, payload_mode=PayloadMode.REFERENCE,
    )
    collecting = SortedPipeline(tables, cfg, result_capacity=1 << 15)
    r1 = collecting.run(probe)
    assert r1["count"] == expected.shape[0]
    cfg2 = dataclasses.replace(cfg, collect_tuples=False)
    counting = SortedPipeline(tables, cfg2)
    r2 = counting.run(probe)
    assert r2["count"] == expected.shape[0]




# ---------------------------------------------------------------------------
# Count-only drain scenarios (the XLA drain every backend runs)
# ---------------------------------------------------------------------------


def _count_only_expected(probe, tables, payload_mode=PayloadMode.REFERENCE):
    oracles = [
        OracleBuildTable(np.asarray(t.keys), np.asarray(t.payloads))
        for t in tables
    ]
    return oracle_pipeline(probe, oracles, payload_mode).shape[0]


@pytest.mark.parametrize(
    "strategy",
    [
        CompactionStrategy.NONE,
        CompactionStrategy.FULL,
        CompactionStrategy.BINARY,
    ],
)
@pytest.mark.parametrize("n_joins,chunk_factor", [(1, 1), (2, 2), (3, 1)])
def test_drain_count_matches_oracle(strategy, n_joins, chunk_factor):
    """Count-only runs (final-level count collapse) equal the oracle's
    row count exactly, for every static strategy and level count."""
    cfg, probe, tables, expected = _setup(
        n_joins=n_joins, lhs=700, rhs=96, chunk_factor=chunk_factor,
        strategy=strategy, payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, collect_tuples=False)
    out = SortedPipeline(tables, cfg).run(probe)
    assert out["count"] == expected.shape[0]


def test_drain_prefilter_and_uneven_tail():
    """Prefilter masking + a last chunk with count < block."""
    from ccve.ops import filter as flt

    cfg, probe, tables, _ = _setup(
        n_joins=1, lhs=701, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, collect_tuples=False)
    kept = probe[probe[:, 0] % 3 == 0]
    pipe = SortedPipeline(tables, cfg, prefilter=flt.mod_eq(3, 0))
    out = pipe.run(probe)
    assert out["count"] == _count_only_expected(kept, tables)


def test_drain_device_dynamic_count():
    """DYNAMIC with the on-device tuner (traced thresholds, work
    counters) — counts stay oracle-exact."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=96, chunk_factor=1,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(
        cfg, collect_tuples=False, device_tuner=True,
        tuner_segment_chunks=2,
    )
    out = SortedPipeline(tables, cfg).run(probe)
    assert out["count"] == expected.shape[0]


def test_drain_sustained_mode():
    """run(sustain=N) chains N full runs in one dispatch; per-run count
    must equal the oracle's."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=600, rhs=96, chunk_factor=1,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, collect_tuples=False)
    r = SortedPipeline(tables, cfg).run(probe, preload=True, sustain=3)
    assert r["count"] == expected.shape[0]
    assert r["sustained"] == 3


@pytest.mark.parametrize("threshold_frac", [2, 4])
def test_drain_cache_split_paths(threshold_frac):
    """Mid thresholds + fanout 2 produce emissions of varying size that
    repeatedly fill and split the compactor cache (emit the filled
    cache, keep the remainder). Counts must stay oracle-exact."""
    block = 128
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=1500, rhs=64, chunk_factor=2,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE, block=block,
    )
    cfg = dataclasses.replace(
        cfg, collect_tuples=False,
        compact_threshold_per_level=(block // threshold_frac,) * 2,
    )
    out = SortedPipeline(tables, cfg).run(probe)
    assert out["count"] == expected.shape[0]


def test_drain_work_counters_account_every_row():
    """The work counters feed the device tuner's reward: level 0 sees
    every input row once, deeper levels never see more rows than their
    parent emitted, and one segment scan + flush equals the oracle."""
    import jax.numpy as jnp

    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=96, chunk_factor=2,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(
        cfg, collect_tuples=False, device_tuner=True
    )
    pipe = SortedPipeline(tables, cfg)
    block = cfg.block_size
    n = probe.shape[0]
    S = -(-n // block)
    cols = np.zeros((S * block, 2), np.int64)
    cols[:n] = probe
    chunk_cols = jnp.asarray(
        np.ascontiguousarray(np.swapaxes(cols.reshape(S, block, 2), 1, 2))
    )
    counts = jnp.asarray(
        np.r_[np.full(S - 1, block), [block - (S * block - n)]],
        jnp.int32,
    )
    thr = jnp.asarray([block, block // 2], jnp.int32)
    ps = pipe._scan_chunks(pipe.fresh_state(), chunk_cols, counts, thr)
    ps = pipe._flush_all(ps, thr)
    assert int(ps.result_count) == expected.shape[0]
    assert int(ps.level_rows[0]) == n
    assert int(ps.level_steps[0]) >= S  # entries + compact executions
    assert int(ps.level_rows[1]) <= expected.shape[0]


def test_drain_device_dynamic_preload_single_dispatch():
    """Preloaded DYNAMIC runs the whole tuned stream as ONE lax.scan
    dispatch (bandit state carried); counts must stay oracle-exact and
    match the streamed path's."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=96, chunk_factor=1,
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(
        cfg, collect_tuples=False, device_tuner=True,
        tuner_segment_chunks=2,
    )
    pipe = SortedPipeline(tables, cfg)
    out = pipe.run(probe, preload=True)
    assert out["count"] == expected.shape[0]
    out2 = pipe.run(probe)  # streamed path
    assert out2["count"] == expected.shape[0]


@pytest.mark.parametrize(
    "strategy",
    [CompactionStrategy.NONE, CompactionStrategy.FULL,
     CompactionStrategy.BINARY],
)
def test_drain_occupancy_matches_collecting_run(strategy):
    """record_occupancy keeps the final level's real compactor in the
    count-only run (no count collapse); its Zebra histograms must equal
    a collecting run's BIN FOR BIN, and counts stay oracle-exact."""
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=700, rhs=96, chunk_factor=2,
        strategy=strategy, payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, record_occupancy=True)
    counting = dataclasses.replace(cfg, collect_tuples=False)
    out = SortedPipeline(tables, counting).run(probe)
    assert out["count"] == expected.shape[0]
    out2 = SortedPipeline(tables, cfg, result_capacity=1 << 14).run(probe)
    assert out2["count"] == expected.shape[0]
    occ_c = np.asarray(out["occupancy"])
    occ_m = np.asarray(out2["occupancy"])
    assert np.array_equal(occ_c, occ_m), (occ_c.nonzero(), occ_m.nonzero())
    assert occ_c.sum() > 0


def test_drain_support_matrix():
    """The COMPONENTS.md drain matrix, executable: every workload axis
    runs on the one XLA drain and stays oracle-exact."""
    def run(capacity=0, occupancy=False, chunk_factor=1,
            strategy=CompactionStrategy.FULL, rank_mode="batched",
            n_joins=2):
        cfg = EngineConfig(
            block_size=BLOCK, n_joins=n_joins, lhs_size=256, rhs_size=64,
            chunk_factor=chunk_factor, strategy=strategy,
            payload_mode=PayloadMode.REFERENCE,
            collect_tuples=capacity > 0, record_occupancy=occupancy,
        )
        probe = gen_probe_table(256, n_joins, 64)
        keys, payloads = gen_rhs_table(64, chunk_factor)
        tables = [build_sorted(keys, payloads) for _ in range(n_joins)]
        out = SortedPipeline(
            tables, cfg, result_capacity=capacity or None,
            rank_mode=rank_mode,
        ).run(probe)
        assert out["count"] == _count_only_expected(probe, tables)

    run()
    run(strategy=CompactionStrategy.DYNAMIC)
    run(strategy=CompactionStrategy.NONE)
    run(occupancy=True)
    run(chunk_factor=8)
    run(capacity=1 << 15)
    run(rank_mode="chunk")
    run(chunk_factor=9, n_joins=3)  # 81 drain paths


def test_drain_wide_keys_count_only():
    """Wide (>2^30-span) keys × {FULL, DYNAMIC} count-only: the batched
    rank pass serves mult from the int64 stats path; oracle-exact."""
    for strategy in (CompactionStrategy.FULL, CompactionStrategy.DYNAMIC):
        cfg = EngineConfig(
            block_size=BLOCK, n_joins=2, lhs_size=400, rhs_size=64,
            strategy=strategy, payload_mode=PayloadMode.REFERENCE,
            collect_tuples=False,
        )
        rng = np.random.default_rng(3)
        shift = np.int64(1) << 40
        keys = np.sort(rng.integers(0, 1 << 45, 64).astype(np.int64))
        payloads = np.arange(64, dtype=np.int64) + 7
        probe = np.stack(
            [
                np.concatenate([keys[rng.integers(0, 64, 200)],
                                rng.integers(0, shift, 200)]),
                np.concatenate([keys[rng.integers(0, 64, 200)],
                                rng.integers(0, shift, 200)]),
            ],
            axis=1,
        )
        rng.shuffle(probe, axis=0)
        tables = [build_sorted(keys, payloads) for _ in range(2)]
        assert tables[0].pack32 is None and tables[0].span62
        out = SortedPipeline(tables, cfg).run(probe)
        assert out["count"] == _count_only_expected(probe, tables), strategy
