"""Chip smoke test: the join engine's main path on the GPU at the sizes
its users run, every result checked exactly against NumPy.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --devices 4   # four cards: the distributed tier
                                       # against one card, nothing else

Phases (one process; the card tests run inside it through pytest, since a
second JAX process would find the card's memory already reserved):

 1. device: platform, kind, count, `nvidia-smi` name and power limit, JAX
    version, compile-cache directory;
 2. count: config 1 (1M build ⋈ 16M probe) through `bulk_count` over the
    sorted, linear-probing and chaining tables;
 3. pipeline: the reference driver's defaults (20M probe rows × 3 joins ×
    2M build) through `cli pipeline` on the bulk and sorted executors,
    and the cursor executor at config-3 size (1M rows × 4 joins);
 4. materialize: `sorted_expand_tiled` at 1M ⋈ 16M, total, checksum and
    2048 sampled triples;
 5. wide: keys spanning 2^40 at 1M ⋈ 16.8M;
 6. zipf: config 4, Zipf join + aggregate pushdown + ORDER BY at 4M;
 7. card tests: `pytest -m card`.

Each phase prints one line: its wall seconds (a smoke time, not a
benchmark number), the device's peak bytes in use so far, and whether
every result matched. A failed phase makes the script exit non-zero with
no result line. The last line of stdout is the JSON result.

It exits non-zero and prints no result when JAX finds no GPU, or when the
`ccve` package is not next to it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# NumPy truth
# ---------------------------------------------------------------------------


def np_level_stats(keys, payloads, probe_col):
    """Per-probe (mult, psum) against one build table, by binary search
    on the sorted keys — independent of the engine's code."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    cpay = np.concatenate([[0], np.cumsum(payloads[order])])
    lo = np.searchsorted(sk, probe_col, "left")
    hi = np.searchsorted(sk, probe_col, "right")
    return hi - lo, cpay[hi] - cpay[lo]


def np_join(keys, payloads, probe):
    """(count, per-level payload checksums) of the N-way join of
    `probe` (int64[n, L]) against the same table at every level."""
    stats = [np_level_stats(keys, payloads, probe[:, l])
             for l in range(probe.shape[1])]
    prod = np.ones(probe.shape[0], np.int64)
    for mult, _ in stats:
        prod = prod * mult
    chks = []
    for mult, psum in stats:
        others = np.where(mult > 0, prod // np.maximum(mult, 1), 0)
        chks.append(int((psum * others).sum()))
    return int(prod.sum()), chks


# ---------------------------------------------------------------------------
# phases: each returns a dict with "match" and what it compared
# ---------------------------------------------------------------------------


def phase_count(n_build=1_000_000, n_probe=16_000_000):
    import jax
    import jax.numpy as jnp

    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.ops.hash_table import build_csr, build_lp
    from ccve.ops.sort_merge import build_sorted

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)
    want = np_join(keys, payloads, probe)
    probe64 = jax.device_put(jnp.asarray(probe))
    # the benchmark's narrow probe column (keys <= n_build < 2^31)
    probe32 = jax.device_put(jnp.asarray(probe.astype(np.int32)))
    got = {}
    for name, builder, p in (
        ("sorted_i32", build_sorted, probe32),
        ("sorted", build_sorted, probe64),
        ("lp", build_lp, probe64),
        ("csr", build_csr, probe64),
    ):
        r = jax.block_until_ready(bulk_count([builder(keys, payloads)], p))
        got[name] = (int(r.count), [int(c) for c in r.payload_checksums])
    match = all(g == (want[0], want[1]) for g in got.values())
    return {"match": match, "count": want[0], "checksum": want[1][0],
            "engines": got if not match else sorted(got)}


def _cli_rows(argv):
    """Run `cli.main(argv)`, echo its report, return [Result Rows]."""
    from ccve import cli

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    sys.stderr.write(text)
    m = re.search(r"\[Result Rows\] (\d+)", text)
    if rc != 0 or m is None:
        raise RuntimeError(f"cli {argv} returned {rc}")
    return int(m.group(1))


def phase_pipeline(lhs=20_000_000, rhs=2_000_000, n_joins=3,
                   cursor_lhs=1_000_000, cursor_rhs=50_000,
                   cursor_joins=4):
    from ccve.core.datagen import gen_probe_table, gen_rhs_table

    keys, payloads = gen_rhs_table(rhs, 1)
    want = np_join(keys, payloads, gen_probe_table(lhs, n_joins, rhs))[0]
    common = ["pipeline", "--join-num", str(n_joins),
              "--lhs-size", str(lhs), "--rhs-size", str(rhs)]
    got = {
        "bulk_sorted": _cli_rows(
            common + ["--executor", "bulk", "--table", "sorted"]),
        "sorted_sorted": _cli_rows(
            common + ["--executor", "sorted", "--table", "sorted"]),
    }
    ck, cp = gen_rhs_table(cursor_rhs, 1)
    want_c = np_join(
        ck, cp, gen_probe_table(cursor_lhs, cursor_joins, cursor_rhs))[0]
    got_c = _cli_rows(
        ["pipeline", "--join-num", str(cursor_joins),
         "--lhs-size", str(cursor_lhs), "--rhs-size", str(cursor_rhs),
         "--executor", "pipeline", "--table", "csr"])
    match = all(v == want for v in got.values()) and got_c == want_c
    return {"match": match, "count": want, "got": got,
            "cursor_count": want_c, "cursor_got": got_c}


def phase_materialize(n_build=1_000_000, n_probe=16_000_000, n_sample=2048):
    import jax
    import jax.numpy as jnp

    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.ops.sort_merge import build_sorted, sorted_expand_tiled

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)[:, 0]
    mult, psum = np_level_stats(keys, payloads, probe)
    table = build_sorted(keys, payloads)
    tiles, total = sorted_expand_tiled(table, jax.device_put(jnp.asarray(probe)))
    rows = np.concatenate([np.asarray(t[0][: int(t[3])]) for t in tiles])
    mk = np.concatenate([np.asarray(t[1][: int(t[3])]) for t in tiles])
    mp = np.concatenate([np.asarray(t[2][: int(t[3])]) for t in tiles])
    order = np.argsort(keys)
    idx = np.random.default_rng(0).integers(0, max(total, 1), n_sample)
    r, k, p = rows[idx], mk[idx], mp[idx]
    sampled_ok = bool(
        np.array_equal(k, probe[r])
        and np.array_equal(p, payloads[order][np.searchsorted(keys[order], k)])
    )
    match = (total == int(mult.sum()) and rows.shape[0] == total
             and int(mp.sum()) == int(psum.sum()) and sampled_ok)
    return {"match": match, "tuples": total, "tiles": len(tiles),
            "checksum": int(psum.sum()), "sampled_triples_ok": sampled_ok}


def phase_wide(n_build=1_000_000, n_probe=1 << 24, span_bits=40):
    import jax
    import jax.numpy as jnp

    from ccve.ops.sort_merge import build_sorted, sorted_match_totals

    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << span_bits, n_build, dtype=np.int64)
    probe = np.concatenate([
        rng.choice(keys, n_probe // 2),
        rng.integers(0, 1 << span_bits, n_probe - n_probe // 2,
                     dtype=np.int64),
    ])
    rng.shuffle(probe)
    payloads = rng.integers(0, 2**30, n_build, dtype=np.int64)
    mult, psum = np_level_stats(keys, payloads, probe)
    table = build_sorted(keys, payloads)
    assert table.pack32 is None and table.span62
    c, chk = jax.jit(lambda p: sorted_match_totals(table, p))(
        jax.device_put(jnp.asarray(probe)))
    match = int(c) == int(mult.sum()) and int(chk) == int(psum.sum())
    return {"match": match, "count": int(mult.sum()),
            "checksum": int(psum.sum())}


def phase_zipf(n_probe=4_000_000, domain=100_000, alpha=1.1):
    import jax
    import jax.numpy as jnp

    from ccve.core.datagen import gen_rhs_table, gen_zipf_keys
    from ccve.ops.aggregate import join_dense_aggregate
    from ccve.ops.sort import xla_sort_pairs
    from ccve.ops.sort_merge import build_sorted

    keys, payloads = gen_rhs_table(domain, 1)
    probe = gen_zipf_keys(n_probe, domain, alpha)
    table = build_sorted(keys, payloads)

    @jax.jit
    def run(p):
        agg, total = join_dense_aggregate(table, p, domain)
        sk, sv = xla_sort_pairs(agg.sum, agg.keys)
        return agg.count, agg.sum, agg.n_groups, total, sk, sv

    count, sums, n_groups, total, sk, sv = map(
        np.asarray, run(jax.device_put(jnp.asarray(probe))))
    order = np.argsort(keys)
    sp = np.sort(probe)
    bc = (np.searchsorted(sp, keys[order], "right")
          - np.searchsorted(sp, keys[order], "left"))
    want_sums = bc * payloads[order]
    match = bool(
        np.array_equal(count, bc) and np.array_equal(sums, want_sums)
        and int(n_groups) == int((bc > 0).sum())
        and int(total) == int(bc.sum())
        and np.array_equal(sk, np.sort(want_sums))
        and np.array_equal(want_sums[np.searchsorted(keys[order], sv)], sk)
    )
    return {"match": match, "matches": int(bc.sum()),
            "groups": int((bc > 0).sum())}


def phase_card_tests():
    import pytest

    os.environ["CCVE_CARD_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "card", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(HERE, "tests")])
    return {"match": rc == 0, "pytest_rc": int(rc)}


def phase_dist(n_devices=4, n_build=2_000_000, n_probe=20_000_000,
               n_levels=2):
    """The distributed tier on an n-device mesh against one device."""
    import jax

    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.ops.sort_merge import build_sorted
    from ccve.parallel.distributed import (
        dist_bulk_count,
        dist_bulk_count_bcast,
        dist_bulk_expand,
        dist_pipeline_expand,
        make_join_mesh,
        partition_tables,
        replicate_tables,
    )

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, n_levels, n_build)
    want = np_join(keys, payloads, probe)
    want1 = np_join(keys, payloads, probe[:, :1])

    table = build_sorted(keys, payloads, device=jax.devices()[0])
    ref = jax.block_until_ready(bulk_count([table] * n_levels, probe))
    one = (int(ref.count), [int(c) for c in ref.payload_checksums])

    mesh = make_join_mesh(n_devices)
    kinds = ("sorted", "csr")[:n_levels] + ("sorted",) * max(n_levels - 2, 0)
    ptables = [partition_tables(keys, payloads, n_devices, k, mesh)
               for k in kinds]
    rtables = [replicate_tables(keys, payloads, k, mesh) for k in kinds]
    got = {}
    r = dist_bulk_count(mesh, ptables, probe)
    got["flat"] = (int(r.count), [int(c) for c in r.payload_checksums],
                   bool(r.overflow))
    r = dist_bulk_count_bcast(mesh, rtables, probe)
    got["bcast"] = (int(r.count), [int(c) for c in r.payload_checksums],
                    False)
    e = dist_bulk_expand(mesh, ptables[0], probe[:, 0])
    got["expand"] = (int(e.total), [int(np.asarray(e.payloads).sum())],
                     bool(e.overflow))
    levels = [partition_tables(keys, payloads, n_devices, "sorted", mesh)
              for _ in range(n_levels)]
    pe = dist_pipeline_expand(mesh, levels, probe)
    pays = np.asarray(pe.payloads)
    live = np.asarray(pe.rid) >= 0
    got["pipeline"] = (int(pe.total),
                       [int(pays[l][live].sum()) for l in range(n_levels)],
                       bool(pe.overflow))
    per_device = {}
    for d in jax.devices()[:n_devices]:
        stats = d.memory_stats() or {}
        per_device[str(d.id)] = stats.get("bytes_in_use")
    match = (
        one == (want[0], want[1])
        and got["flat"] == (*one, False)
        and got["bcast"] == (*one, False)
        and got["expand"] == (want1[0], want1[1], False)
        and got["pipeline"] == (*one, False)
    )
    return {"match": match, "one_device": one, "mesh": got,
            "bytes_in_use_per_device": per_device}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def card_lines():
    """`nvidia-smi` name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _mem(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use"), stats.get("bytes_in_use")


def run_phases(phases, dev):
    """Run (name, fn) phases in order; print one line each. Returns the
    number of failed phases."""
    failed = 0
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            ok = bool(res.pop("match"))
        except Exception:
            traceback.print_exc()
            res, ok = {"error": traceback.format_exc(limit=1).strip()}, False
        secs = time.perf_counter() - t0
        peak, now = _mem(dev)
        print(f"[{name}] smoke_seconds={secs:.3f} (smoke time, not a "
              f"benchmark number) peak_bytes_in_use={peak} "
              f"bytes_in_use={now} match={ok} {json.dumps(res, default=str)}",
              flush=True)
        failed += not ok
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=[1, 4], default=1)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import ccve  # noqa: F401  (x64 + compile cache)
    except ImportError as exc:
        print(f"the ccve package is not next to chip_smoke.py: {exc}",
              file=sys.stderr)
        return 3
    import jax

    devs = jax.devices()
    dev = devs[0]
    print(f"[device] jax {jax.__version__} devices={devs} "
          f"platform={dev.platform} kind={dev.device_kind} count={len(devs)} "
          f"compile_cache={jax.config.jax_compilation_cache_dir}", flush=True)
    if dev.platform != "gpu":
        print("no GPU: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"--devices {args.devices} needs {args.devices} GPUs, "
              f"found {len(devs)}", file=sys.stderr)
        return 2
    for line in card_lines():
        print(line, flush=True)  # as nvidia-smi gives it

    if args.devices == 4:
        phases = [("dist", lambda: phase_dist(n_devices=4))]
    else:
        phases = [
            ("count", phase_count),
            ("pipeline", phase_pipeline),
            ("materialize", phase_materialize),
            ("wide", phase_wide),
            ("zipf", phase_zipf),
            ("card_tests", phase_card_tests),
        ]
    if run_phases(phases, dev):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
