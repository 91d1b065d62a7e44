"""CLI drivers end-to-end (small workloads, CPU)."""

import numpy as np

from ccve import cli
from ccve.bench.micro import run_micro_bench
from ccve.config import EngineConfig, PayloadMode
from ccve.core.datagen import gen_probe_table, gen_rhs_table
from ccve.exec.oracle import OracleBuildTable, oracle_pipeline


def test_cli_pipeline_smoke(capsys):
    rc = cli.main(
        [
            "pipeline",
            "--join-num", "2",
            "--chunk-factor", "2",
            "--lhs-size", "600",
            "--rhs-size", "128",
            "--block-size", "128",
            "--strategy", "binary",
            "--table", "lp",
            "--collect-tuples",
        ]
    )
    assert rc == 0
    err = capsys.readouterr().err
    # result count printed must match the oracle
    probe = gen_probe_table(600, 2, 128)
    keys, payloads = gen_rhs_table(128, 2)
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.REFERENCE
    )
    assert f"[Result Rows] {expected.shape[0]}" in err


def test_cli_bulk_executor_smoke(capsys):
    rc = cli.main(
        [
            "pipeline",
            "--join-num", "2",
            "--chunk-factor", "1",
            "--lhs-size", "500",
            "--rhs-size", "64",
            "--executor", "bulk",
            "--table", "csr",
        ]
    )
    assert rc == 0
    probe = gen_probe_table(500, 2, 64)
    keys, payloads = gen_rhs_table(64, 1)
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * 2, PayloadMode.REFERENCE
    )
    assert f"[Result Rows] {expected.shape[0]}" in capsys.readouterr().err


def test_micro_bench_variants_agree():
    results = run_micro_bench(scale=0, hit_freq=1, chunk_factor=1, n_keys=1 << 13)
    assert len(results) == 6
    counts = {r.tuples for r in results}
    assert len(counts) == 1
    # the phased variants carry the reference CycleProfiler's 4 slots
    # (hash / match / gather / advance, profiler.h:285-289) with nonzero
    # time in each
    phased = [r for r in results if r.phase_profiler is not None]
    assert len(phased) == 2
    for r in phased:
        stats = r.phase_profiler.stats()
        assert set(stats) == {"hash", "match", "gather", "advance"}
        assert all(s.seconds > 0 for s in stats.values())
        assert "ns/item" in r.phase_profiler.report(total_items=r.n_keys)



def test_baseline_refuses_cpu_without_flag(capsys):
    import pytest

    with pytest.raises(SystemExit, match="measures the GPU"):
        cli.main(["baseline", "--config", "1", "--tiny"])


def test_baseline_cpu_flag_names_device(capsys):
    import json

    assert cli.main(["--cpu", "baseline", "--config", "1", "--tiny"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu" and out["count"] > 0
