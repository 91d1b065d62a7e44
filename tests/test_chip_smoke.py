"""chip_smoke.py's phases at tiny sizes on the CPU (every phase checks
itself against NumPy), the four-device phase on four virtual CPU
devices, and the script's refusals: no GPU, no package beside it."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _check(res):
    assert res.pop("match"), res


def test_phase_count_tiny():
    _check(chip_smoke.phase_count(n_build=4096, n_probe=65536))


def test_phase_pipeline_tiny():
    _check(chip_smoke.phase_pipeline(
        lhs=6000, rhs=600, cursor_lhs=3000, cursor_rhs=256))


def test_phase_materialize_tiny():
    _check(chip_smoke.phase_materialize(
        n_build=4096, n_probe=65536, n_sample=256))


def test_phase_wide_tiny():
    _check(chip_smoke.phase_wide(n_build=4096, n_probe=1 << 15))


def test_phase_zipf_tiny():
    _check(chip_smoke.phase_zipf(n_probe=40_000, domain=512, alpha=1.3))


def test_phase_dist_four_virtual_devices():
    res = chip_smoke.phase_dist(
        n_devices=4, n_build=2048, n_probe=20_000, n_levels=2)
    assert set(res["bytes_in_use_per_device"]) == {"0", "1", "2", "3"}
    _check(res)


def test_np_join_matches_bruteforce():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 20, 30)
    payloads = rng.integers(-5, 100, 30)
    probe = rng.integers(-2, 22, (50, 2))
    count, chks = chip_smoke.np_join(keys, payloads, probe)
    rows = [(a, b) for i in range(50)
            for a in np.nonzero(keys == probe[i, 0])[0]
            for b in np.nonzero(keys == probe[i, 1])[0]]
    assert count == len(rows)
    assert chks == [int(sum(payloads[a] for a, _ in rows)),
                    int(sum(payloads[b] for _, b in rows))]


def test_failed_phase_exits_nonzero(capsys):
    def boom():
        raise RuntimeError("phase failed")

    import jax

    dev = jax.devices()[0]
    assert chip_smoke.run_phases(
        [("ok", lambda: {"match": True}), ("boom", boom),
         ("wrong", lambda: {"match": False})], dev) == 2
    out = capsys.readouterr().out
    assert "[boom]" in out and "match=False" in out


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_without_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("devices", ["1", "4"])
def test_refuses_without_package(tmp_path, devices):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", "--devices", devices],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not next to chip_smoke.py" in r.stderr
