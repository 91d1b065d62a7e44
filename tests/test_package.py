"""Package-level invariants: the compile-cache rule (both branches), no
Mosaic (Pallas for the old accelerator) code and no backend predicate
anywhere in the program, and bench.py's refusal of the CPU."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = "import jax, ccve; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(
        tmp_path
    )


def test_compile_cache_defaults_into_checkout():
    got = pathlib.Path(_cache_dir({}))
    assert got == REPO / ".jax_cache"
    ignored = REPO.joinpath(".gitignore").read_text().split()
    assert ".jax_cache/" in ignored, ".jax_cache must be git-ignored"


# `[t]pu` keeps these patterns from matching this file's own text
FORBIDDEN = [
    r"jax\.experimental\.pallas\s+import\s+[t]pu",
    r"jax\.experimental\.pallas\.[t]pu",
    r"pl[t]pu",
    r"default_backend\(\)\s*!=\s*[\"']cpu[\"']",
    r"==\s*[\"'][t]pu[\"']",
]


def test_no_mosaic_code_or_backend_predicate():
    files = [*REPO.joinpath("ccve").rglob("*.py"),
             REPO / "bench.py", REPO / "chip_smoke.py",
             *REPO.joinpath("tests").glob("*.py")]
    hits = [
        f"{f.relative_to(REPO)}: {pat}"
        for f in files
        for pat in FORBIDDEN
        if re.search(pat, f.read_text())
    ]
    assert not hits, hits


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 2
    assert r.stdout.strip() == ""
