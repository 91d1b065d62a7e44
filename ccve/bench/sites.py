"""Device time of what XLA makes of each sort-merge site, at the sizes of
config 1 (1M build / 16M probe) and config 3 (1M rows × 4 joins × 50K
build), on the GPU:

 - the 2^24-element i32 and int64 sorts (`lax.sort`, one operand);
 - the count-side chain of `sorted_match_totals` (pack → sort → scans →
   scatter → dot) on the i32 and int64 tagged streams;
 - per-probe stats (`sorted_match_stats`) and materialization
   (`sorted_expand`);
 - one segment of `SortedPipeline`'s drain (64 chunks of 2048 rows);
 - the LP drain with and without survivor compaction, and one
   compaction step (prefix count + scatters) alone.

    python -m ccve.bench.sites [--reps 7]

Each reading is the median of `--reps` `block_until_ready` wall times
after one warm-up call, printed with the device and the card's name and
power limit. Refuses to run (exit 2) when the default device is not a
GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def sites(n_build=1_000_000, n_probe=16_000_000, n_sort=1 << 24,
          c3_rhs=50_000, c3_joins=4, block=2048, seg_chunks=64):
    """{name: (jitted fn, args)} for every site, data made from seeds."""
    from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import compact_survivors, lp_match_stats
    from ccve.exec.sorted_pipeline import SortedPipeline
    from ccve.ops.hash_table import build_lp
    from ccve.ops.sort_merge import (
        build_sorted,
        sorted_expand,
        sorted_match_stats,
        sorted_match_totals,
    )

    rng = np.random.default_rng(0)
    out = {}
    s32 = jnp.asarray(rng.integers(0, 2**31 - 1, n_sort, dtype=np.int32))
    s64 = jnp.asarray(rng.integers(0, 2**62, n_sort, dtype=np.int64))
    sort1 = jax.jit(lambda x: jax.lax.sort(x))
    out["sort_i32"] = (sort1, (s32,))
    out["sort_i64"] = (sort1, (s64,))

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)[:, 0]
    table = build_sorted(keys, payloads)
    p64 = jnp.asarray(probe)
    p32 = jnp.asarray(probe.astype(np.int32))
    totals = jax.jit(sorted_match_totals)
    out["count_side_i32"] = (totals, (table, p32))
    # the same keys spread over 2^40: the int64 tagged stream
    wide = build_sorted(keys << 20, payloads)
    out["count_side_i64"] = (totals, (wide, p64 << 20))
    out["stats"] = (jax.jit(sorted_match_stats), (table, p64))
    out["expand"] = (
        jax.jit(lambda t, p: sorted_expand(t, p, p.shape[0])), (table, p64)
    )

    lp = build_lp(keys, payloads)
    out["lp_drain_compacted"] = (
        jax.jit(lambda t, k: lp_match_stats(t, k, compact_lanes=True)),
        (lp, p64),
    )
    out["lp_drain_full_width"] = (
        jax.jit(lambda t, k: lp_match_stats(t, k, compact_lanes=False)),
        (lp, p64),
    )

    live = jnp.asarray(rng.random(n_probe) < 0.25)
    out["lp_compaction_step"] = (
        jax.jit(lambda live, *cols: compact_survivors(live, n_probe // 2,
                                                      *cols)[1]),
        (live, p64, jnp.zeros(n_probe, jnp.int32),
         jnp.arange(n_probe, dtype=jnp.int32)),
    )

    lhs = seg_chunks * block
    ck, cp = gen_rhs_table(c3_rhs, 1)
    cprobe = gen_probe_table(lhs, c3_joins, 2 * c3_rhs)
    st = build_sorted(ck, cp)
    cfg = EngineConfig(
        block_size=block, n_joins=c3_joins, lhs_size=lhs, rhs_size=c3_rhs,
        strategy=CompactionStrategy.NONE, payload_mode=PayloadMode.REFERENCE,
    )
    pipe = SortedPipeline([st] * c3_joins, cfg)
    chunk_cols = jnp.asarray(np.ascontiguousarray(
        np.swapaxes(cprobe.reshape(seg_chunks, block, c3_joins), 1, 2)))
    counts = jnp.full(seg_chunks, block, jnp.int32)
    thr = jnp.zeros(c3_joins, jnp.int32)
    out["sorted_drain_segment"] = (
        jax.jit(pipe._scan_chunks),
        (pipe.fresh_state(), chunk_cols, counts, thr),
    )
    return out


def median_seconds(fn, args, reps: int) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"sites measures the GPU; the default device is {dev}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for name, (fn, fargs) in sites().items():
        secs = median_seconds(fn, fargs, args.reps)
        print(json.dumps({
            "site": name, "median_ms": secs * 1e3, "reps": args.reps,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
