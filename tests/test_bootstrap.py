"""Multi-host bootstrap (parallel/bootstrap.py + `cli dist`): a REAL
2-process CPU launch through `jax.distributed.initialize` — psum /
all_to_all ride Gloo across process boundaries, so the radix shuffle and
the materializing pipeline are exercised cross-PROCESS (the
cross-HOST-shaped path SURVEY §5 mandates), not just across the
in-process device mesh the other distributed tests use."""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = [
    "--n-build", "2000", "--n-probe", "30000", "--n-joins", "2",
    "--pipeline-levels", "2",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(args, n_local_devices, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}"
    )
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "ccve.cli", "--cpu", "dist"] + args,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        cwd=REPO,
    )


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out, err[-2000:])
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.slow
@pytest.mark.parametrize("shuffle", ["hier", "flat", "bcast"])
def test_dist_two_process_launch_matches_single(shuffle):
    """2 processes x 2 devices vs one 4-device single-process run (which
    itself cross-checks against the single-device bulk count): identical
    join counts and pipeline row totals. 'hier' routes the radix shuffle
    over the 2D (process, local) mesh — the key hop crosses the REAL
    process boundary once, host-aggregated (dist_bulk_count_hier);
    'flat' is the 1D all_to_all; 'bcast' replicates the builds across
    the REAL process boundary and never shuffles the probe stream."""
    # single-process degenerate run (no coordinator): 4 local devices
    single = _result(_run(COMMON, n_local_devices=4))
    assert single["initialized"] is False
    assert single["cross_checked"] is True
    assert single["hierarchical"] is False

    coord = f"localhost:{_free_port()}"
    pair = [
        _run(
            COMMON
            + [
                "--coordinator", coord,
                "--num-processes", "2",
                "--process-id", str(pid),
                "--shuffle", shuffle,
            ],
            n_local_devices=2,
        )
        for pid in (0, 1)
    ]
    results = [_result(p) for p in pair]
    for r in results:
        assert r["initialized"] is True
        assert r["num_processes"] == 2
        assert r["n_devices"] == 4
        assert r["hierarchical"] is (shuffle == "hier")
        assert r["overflow"] is False
        assert r["count"] == single["count"]
        assert r["pipeline_rows"] == single["pipeline_rows"]
    assert results[0]["count"] == results[1]["count"]


def test_init_distributed_env_plumbing(monkeypatch):
    """Arg/env resolution (no cluster): the degenerate path must not
    touch jax.distributed, and env vars must round-trip into the
    initialize call (captured via monkeypatch)."""
    from ccve.parallel import bootstrap

    monkeypatch.delenv("CCVE_COORDINATOR", raising=False)
    monkeypatch.delenv("CCVE_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("CCVE_PROCESS_ID", raising=False)
    info = bootstrap.init_distributed()
    assert info == {
        "initialized": False, "process_id": 0, "num_processes": 1
    }

    calls = {}

    class FakeDistributed:
        @staticmethod
        def initialize(coordinator_address, num_processes, process_id):
            calls.update(
                coordinator=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )

    import jax

    monkeypatch.setattr(jax, "distributed", FakeDistributed)
    monkeypatch.setattr(jax, "process_index", lambda: 3, raising=False)
    monkeypatch.setattr(jax, "process_count", lambda: 4, raising=False)
    monkeypatch.setenv("CCVE_COORDINATOR", "node0:1234")
    monkeypatch.setenv("CCVE_NUM_PROCESSES", "4")
    monkeypatch.setenv("CCVE_PROCESS_ID", "3")
    info = bootstrap.init_distributed()
    assert calls == {
        "coordinator": "node0:1234", "num_processes": 4, "process_id": 3
    }
    assert info == {
        "initialized": True, "process_id": 3, "num_processes": 4
    }


def test_init_distributed_local_device_ids(monkeypatch):
    """Several processes on one host: each names its own cards, and the
    list reaches jax.distributed.initialize unchanged."""
    import jax

    from ccve.parallel import bootstrap

    calls = {}

    class FakeDistributed:
        @staticmethod
        def initialize(**kwargs):
            calls.update(kwargs)

    monkeypatch.setattr(jax, "distributed", FakeDistributed)
    monkeypatch.setattr(jax, "process_index", lambda: 1, raising=False)
    monkeypatch.setattr(jax, "process_count", lambda: 2, raising=False)
    bootstrap.init_distributed("localhost:9999", 2, 1, local_device_ids=[1])
    assert calls == {
        "coordinator_address": "localhost:9999", "num_processes": 2,
        "process_id": 1, "local_device_ids": [1],
    }


def test_dist_zipf_prpd_single_process():
    """`cli dist --zipf-alpha`: the skewed-workload path (Zipf probe +
    heavy-hitter replication masked out of the shuffle) through the
    bootstrap harness, cross-checked against the single-device count."""
    r = _result(
        _run(
            [
                "--n-build", "2000", "--n-probe", "40000",
                "--n-joins", "1", "--zipf-alpha", "1.2",
            ],
            n_local_devices=4,
        )
    )
    assert r["cross_checked"] is True
    assert r["overflow"] is False
    assert r["hierarchical"] is False
    assert r["count"] > 0
    # PRPD keeps the cold shuffle balanced despite the Zipf head
    assert r["skew"] < 2.5


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_dist_table_kinds_single_process(kind):
    """The bootstrap harness over the hash-table partition kinds (the
    sorted kind is covered by every other test here)."""
    r = _result(
        _run(
            ["--n-build", "1500", "--n-probe", "20000", "--n-joins", "1",
             "--kind", kind],
            n_local_devices=4,
        )
    )
    assert r["cross_checked"] is True
    assert r["overflow"] is False
    assert r["count"] > 0
