"""BASELINE benchmark configs at CI sizes (every config self-validates
its counts against the oracle or the single-device reference)."""

import pytest

from ccve.bench import configs


def test_config1_tiny():
    r = configs.config1_single_join(n_build=2048, n_probe=16384)
    assert r["count"] > 0 and r["rows_per_s"] > 0


@pytest.mark.parametrize("engine", ["hash_lp", "hash_csr"])
def test_config1_engines_agree(engine):
    a = configs.config1_single_join(2048, 16384, engine="sort_merge")
    b = configs.config1_single_join(2048, 16384, engine=engine)
    assert a["count"] == b["count"]


def test_config2_tiny():
    r = configs.config2_filtered_join(lhs=4000, rhs=512, block=256)
    assert r["full_compaction"]["seconds"] > 0
    assert r["dynamic_compaction"]["seconds"] > 0


@pytest.mark.slow
def test_config3_tiny():
    r = configs.config3_four_way(lhs=3000, rhs=256, block=256)
    assert r["bulk"]["seconds"] > 0
    assert r["no_compaction"]["seconds"] > 0
    assert r["full_compaction"]["seconds"] > 0


def test_config4_tiny():
    r = configs.config4_zipf_pipeline(n_probe=40_000, domain=512, alpha=1.3)
    assert r["matches"] > 0
    assert r["n_groups"] <= 512
    assert r["partition_skew_16"] >= 1.0


def test_config5_tiny():
    r = configs.config5_distributed(n_build=2048, n_probe=20_000, n_devices=4)
    assert not r["overflow"]
    assert r["scaling_efficiency"] > 0


@pytest.mark.slow
def test_config7_tiny():
    r = configs.config7_heterogeneous_levels(
        lhs=8000, rhs=256, block=256, segment_chunks=2
    )
    for k in (
        "no_compaction",
        "full_compaction",
        "mixed_static",
        "dynamic_compaction_device",
    ):
        assert r[k]["seconds"] > 0
    assert r["dynamic_compaction_device"]["greedy_thresholds"]
    assert r["dynamic_vs_best_static"] > 0


@pytest.mark.slow
def test_config6_tiny(tmp_path):
    r = configs.config6_mixed_selectivity(
        lhs=8000, rhs=256, block=256, phase_chunks=8, mod=4,
        segment_chunks=2, log_dir=str(tmp_path),
    )
    assert r["no_compaction"]["seconds"] > 0
    assert r["full_compaction"]["seconds"] > 0
    assert r["dynamic_compaction"]["seconds"] > 0
    # counts already asserted inside; bandit history CSV written
    assert any(p.suffix == ".csv" for p in tmp_path.iterdir())


def test_config1_materialize_tiny():
    """Materializing axis: tuples-out with checksum + sampled-triple
    verification (the asserts live inside the config function)."""
    from ccve.bench.configs import config1_materialize

    out = config1_materialize(n_build=4096, n_probe=65536)
    assert out["payload_checksum_ok"] and out["tuples_out"] > 0


def test_config1_wide_tiny():
    """Wide-key config axis: numpy-verified count and checksum (the
    asserts live inside the config function)."""
    out = configs.config1_wide(
        n_build=4096, n_probe=1 << 15, span_bits=40, niter=2
    )
    assert out["checksum_ok"] and out["count"] > 0
