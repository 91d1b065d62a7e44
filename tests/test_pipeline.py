"""End-to-end N-way join pipeline vs the scalar oracle, across hash-table
types, compaction strategies, payload modes, and duplicate multiplicities
(the test layer the reference lacks, SURVEY.md §4)."""

import numpy as np
import pytest

from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table
from ccve.exec.oracle import (
    OracleBuildTable,
    assert_same_multiset,
    oracle_pipeline,
)
from ccve.exec.pipeline import JoinPipeline
from ccve.ops.hash_table import build_csr, build_lp

BLOCK = 128


def _setup(n_joins, lhs, rhs, chunk_factor, table_kind, strategy, payload_mode):
    cfg = EngineConfig(
        block_size=BLOCK,
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
    builder = build_lp if table_kind == "lp" else build_csr
    tables = [builder(keys, payloads) for _ in range(n_joins)]
    oracles = [OracleBuildTable(keys, payloads) for _ in range(n_joins)]
    expected = oracle_pipeline(probe, oracles, payload_mode)
    return cfg, probe, tables, expected


@pytest.mark.parametrize("table_kind", ["lp", "csr"])
@pytest.mark.parametrize(
    "strategy",
    [
        CompactionStrategy.NONE,
        CompactionStrategy.FULL,
        CompactionStrategy.BINARY,
    ],
)
def test_pipeline_matches_oracle(table_kind, strategy):
    cfg, probe, tables, expected = _setup(
        n_joins=2,
        lhs=700,
        rhs=96,
        chunk_factor=2,
        table_kind=table_kind,
        strategy=strategy,
        payload_mode=PayloadMode.FULL,
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


def test_pipeline_reference_payload_mode():
    cfg, probe, tables, expected = _setup(
        n_joins=2,
        lhs=400,
        rhs=64,
        chunk_factor=1,
        table_kind="csr",
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=4096)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    # REFERENCE mode: col n_joins+2l is always 0 (never written,
    # chaining_ht.cpp:60-80,126-136)
    assert (out["rows"][:, cfg.n_joins] == 0).all()


@pytest.mark.slow
def test_pipeline_dynamic_strategy():
    cfg, probe, tables, expected = _setup(
        n_joins=2,
        lhs=600,
        rhs=64,
        chunk_factor=2,
        table_kind="lp",
        strategy=CompactionStrategy.DYNAMIC,
        payload_mode=PayloadMode.FULL,
    )
    cfg = EngineConfig(
        **{
            **{f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()},
            "threshold_arms": (0, 32, 64, 128),
            "tuner_segment_chunks": 2,
        }
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)


def test_pipeline_three_way_high_multiplicity():
    """chunk_factor 4 → every probe hit fans out 4x per level: the
    tiny-chunk cascade that compaction exists to fix (SURVEY.md §3.1)."""
    cfg, probe, tables, expected = _setup(
        n_joins=3,
        lhs=220,
        rhs=32,
        chunk_factor=4,
        table_kind="csr",
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.FULL,
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=1 << 17)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


def test_pipeline_count_only():
    cfg, probe, tables, expected = _setup(
        n_joins=2,
        lhs=500,
        rhs=64,
        chunk_factor=1,
        table_kind="lp",
        strategy=CompactionStrategy.NONE,
        payload_mode=PayloadMode.REFERENCE,
    )
    cfg = EngineConfig(
        **{
            **{f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()},
            "collect_tuples": False,
        }
    )
    pipe = JoinPipeline(tables, cfg)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]


def test_pipeline_with_prefilter():
    """BASELINE config 2 shape: ~10% selective filter feeding the join —
    under-filled chunks exercised against full compaction."""
    from ccve.ops import filter as flt

    cfg = EngineConfig(
        block_size=BLOCK,
        n_joins=2,
        lhs_size=900,
        rhs_size=96,
        chunk_factor=2,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.FULL,
        collect_tuples=True,
        record_occupancy=True,
    )
    probe = gen_probe_table(900, 2, 96)
    keys, payloads = gen_rhs_table(96, 2)
    tables = [build_csr(keys, payloads) for _ in range(2)]
    kept = probe[probe[:, 0] % 8 == 0]  # ~12.5% selectivity
    expected = oracle_pipeline(
        kept, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.FULL
    )
    pipe = JoinPipeline(
        tables,
        cfg,
        result_capacity=8192,
        prefilter=flt.mod_eq(8, 0),
        prefilter_col=0,
    )
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    # occupancy histogram must show under-filled level-0 emissions
    occ = out["occupancy"]
    assert occ.sum() > 0


def test_occupancy_exported_to_zebra(tmp_path):
    import dataclasses

    from ccve.utils.profiler import ZebraProfiler

    ZebraProfiler.get().clear()
    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=300, rhs=64, chunk_factor=1, table_kind="lp",
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.REFERENCE,
    )
    cfg = dataclasses.replace(cfg, record_occupancy=True)
    pipe = JoinPipeline(tables, cfg, result_capacity=4096)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    zebra = ZebraProfiler.get()
    hist = zebra.histogram("level0_full_compaction")
    assert sum(calls for _, calls in hist.values()) > 0
    zebra.to_csv(str(tmp_path))
    assert any(p.suffix == ".csv" for p in tmp_path.iterdir())
    zebra.clear()


@pytest.mark.parametrize("strategy", [CompactionStrategy.NONE, CompactionStrategy.FULL])
def test_pipeline_multilane_matches_oracle(strategy):
    """vmap'd K-lane executor must produce the same multiset as 1-lane."""
    cfg, probe, tables, expected = _setup(
        n_joins=2,
        lhs=900,
        rhs=96,
        chunk_factor=2,
        table_kind="csr",
        strategy=strategy,
        payload_mode=PayloadMode.FULL,
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=8192, lanes=4)
    out = pipe.run(probe, segment_chunks=2)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


@pytest.mark.parametrize("strategy", [CompactionStrategy.NONE, CompactionStrategy.FULL])
def test_pipeline_branchy_descend(strategy):
    """The lax.cond descend A/B (EngineConfig.branchy_descend) must be
    observationally identical to the branch-free work loop."""
    import dataclasses

    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=700, rhs=96, chunk_factor=2, table_kind="csr",
        strategy=strategy, payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(cfg, branchy_descend=True)
    pipe = JoinPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)


def test_pipeline_per_level_thresholds():
    """compact_threshold_per_level on the cursor executor: heterogeneous
    static thresholds per level stay oracle-exact."""
    import dataclasses

    cfg, probe, tables, expected = _setup(
        n_joins=3, lhs=500, rhs=64, chunk_factor=2, table_kind="csr",
        strategy=CompactionStrategy.FULL, payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, compact_threshold_per_level=(0, cfg.block_size, 32)
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=1 << 15)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert not out["overflowed"]
    assert_same_multiset(out["rows"], expected)


@pytest.mark.slow
@pytest.mark.parametrize("branchy", [False, True])
@pytest.mark.parametrize("lanes", [1, 3])
def test_pipeline_interaction_matrix(branchy, lanes):
    """Stress the executor feature interactions the configs combine:
    prefilter x FULL compaction x count-only x branchy x lanes."""
    import dataclasses

    from ccve.ops import filter as flt

    cfg = EngineConfig(
        block_size=BLOCK,
        n_joins=2,
        lhs_size=1100,
        rhs_size=96,
        chunk_factor=2,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
        collect_tuples=False,
        branchy_descend=branchy,
    )
    probe = gen_probe_table(1100, 2, 96)
    keys, payloads = gen_rhs_table(96, 2)
    tables = [build_csr(keys, payloads) for _ in range(2)]
    kept = probe[probe[:, 0] % 4 == 0]
    expected = oracle_pipeline(
        kept, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.REFERENCE
    )
    pipe = JoinPipeline(
        tables, cfg, prefilter=flt.mod_eq(4, 0), prefilter_col=0,
        lanes=lanes,
    )
    out = pipe.run(probe, segment_chunks=2)
    assert out["count"] == expected.shape[0]


@pytest.mark.slow
def test_pipeline_device_tuner_matches_oracle():
    """DYNAMIC with the ON-DEVICE bandit (zero host syncs) must stay
    oracle-exact and report per-level bandit state."""
    import dataclasses

    cfg, probe, tables, expected = _setup(
        n_joins=2, lhs=900, rhs=64, chunk_factor=2, table_kind="csr",
        strategy=CompactionStrategy.DYNAMIC, payload_mode=PayloadMode.FULL,
    )
    cfg = dataclasses.replace(
        cfg, device_tuner=True, threshold_arms=(0, 32, 64, 128),
        tuner_segment_chunks=2,
    )
    pipe = JoinPipeline(tables, cfg, result_capacity=8192)
    out = pipe.run(probe)
    assert out["count"] == expected.shape[0]
    assert_same_multiset(out["rows"], expected)
    assert out["bandit_est"].shape == (2, 4)
    assert out["bandit_n_sel"].sum() > 0
    # step counters recorded work at both levels
    assert out["greedy_thresholds"].shape == (2,)


def test_pipeline_preload_matches_streamed():
    """preload=True (device-resident chunk batch, bulk-engine timing
    convention) must be observationally identical to the streamed feed."""
    import numpy as np

    from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.pipeline import JoinPipeline
    from ccve.exec.sorted_pipeline import SortedPipeline
    from ccve.ops.hash_table import build_csr
    from ccve.ops.sort_merge import build_sorted

    cfg = EngineConfig(
        block_size=128, n_joins=2, lhs_size=700, rhs_size=96,
        chunk_factor=2, strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.FULL, collect_tuples=True,
    )
    probe = gen_probe_table(700, 2, 96)
    keys, payloads = gen_rhs_table(96, 2)
    for pipe in (
        JoinPipeline([build_csr(keys, payloads)] * 2, cfg,
                     result_capacity=8192),
        SortedPipeline([build_sorted(keys, payloads)] * 2, cfg,
                       result_capacity=8192),
    ):
        streamed = pipe.run(probe)
        pre = pipe.run(probe, preload=True)
        assert pre["preloaded"] and not streamed["preloaded"]
        assert pre["count"] == streamed["count"]
        a = np.asarray(sorted(map(tuple, pre["rows"])))
        b = np.asarray(sorted(map(tuple, streamed["rows"])))
        assert np.array_equal(a, b)


def test_pipeline_zebra_profile_segments():
    """zebra_profile: per-SEGMENT measured attribution — each segment's
    wall time lands on its own occupancy deltas (>= several independent
    timings), totals match the plain occupancy histogram, and the count
    stays exact."""
    import numpy as np

    from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.pipeline import JoinPipeline
    from ccve.ops.hash_table import build_csr
    from ccve.utils.profiler import ZebraProfiler

    cfg = EngineConfig(
        block_size=128, n_joins=2, lhs_size=2000, rhs_size=96,
        chunk_factor=2, strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE, collect_tuples=False,
        record_occupancy=True, tuner_segment_chunks=2,
    )
    probe = gen_probe_table(2000, 2, 96)
    keys, payloads = gen_rhs_table(96, 2)
    pipe = JoinPipeline([build_csr(keys, payloads)] * 2, cfg)

    zebra = ZebraProfiler.get()
    zebra.clear()
    out = pipe.run(probe, zebra_profile=True)
    assert out["zebra_segments"] >= 8  # independent timings
    # every recorded step got attributed once, with nonzero time
    total_calls = 0
    total_time = 0.0
    for level in range(2):
        hist = zebra.histogram(f"level{level}_full_compaction")
        total_calls += sum(c for _, c in hist.values())
        total_time += sum(t for t, _ in hist.values())
    assert total_calls == int(out["occupancy"].sum())
    assert total_time > 0
    # sanity vs a plain run: same result
    plain = pipe.run(probe)
    assert plain["count"] == out["count"]
    zebra.clear()
