"""Command-line drivers — the reference's two executables as one CLI.

 - `pipeline`  ⇔ `simd_compaction_sevector` (main.cpp:37-117): the N-way
   join pipeline benchmark. Flags mirror main.cpp:202-243
   (--join-num --chunk-factor --lhs-size --rhs-size) plus the strategy
   axis, which the reference bakes in at compile time via one binary per
   strategy (build_versions.sh) and here is a runtime flag.
 - `microbench` ⇔ `simd_bench_sevector` (simd_micro_bench.cpp:35-73):
   flags --scale --hit-frequency --chunk-factor.

Usage: python -m ccve.cli pipeline --join-num 3 --strategy full ...
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_pipeline(sub):
    p = sub.add_parser("pipeline", help="N-way join pipeline benchmark")
    p.add_argument("--join-num", type=int, default=3)
    p.add_argument("--chunk-factor", type=int, default=1)
    p.add_argument("--lhs-size", type=int, default=20_000_000)
    p.add_argument("--rhs-size", type=int, default=2_000_000)
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument(
        "--strategy",
        choices=["none", "full", "binary", "dynamic"],
        default="none",
    )
    p.add_argument(
        "--table",
        choices=["lp", "csr", "sorted"],
        default="csr",
        help="build-table kind; 'sorted' (the sort-merge probe engine, "
        "ops/sort_merge.py) pairs with --executor bulk or sorted",
    )
    p.add_argument(
        "--executor",
        choices=["pipeline", "bulk", "sorted"],
        default="pipeline",
        help="'pipeline': chunk-at-a-time cursor executor (the parity "
        "engine); 'bulk': operator-at-a-time; 'sorted': chunk-at-a-time "
        "over sorted tables with batched sort-merge ranks "
        "(exec/sorted_pipeline.py)",
    )
    p.add_argument("--payload", choices=["reference", "full"], default="reference")
    p.add_argument("--collect-tuples", action="store_true")
    p.add_argument(
        "--record-occupancy",
        action="store_true",
        help="record per-level chunk-occupancy histograms on device "
        "(the ZebraProfiler data; off by default like the reference's "
        "kEnableProfiling=0, profiler.h:170)",
    )
    p.add_argument("--segment-chunks", type=int, default=64)
    p.add_argument(
        "--preload",
        action="store_true",
        help="upload the whole chunk batch before the timed window "
        "(the bulk engine's timing convention) instead of streaming "
        "host chunk batches per segment",
    )
    p.add_argument(
        "--zebra-profile",
        action="store_true",
        help="MEASURED Zebra latency: sync + time each segment and "
        "attribute its wall time to its own occupancy deltas, then "
        "export CSVs to ./zebra_log_0x<rand>/ (the reference's "
        "ZebraProfiler output, profiler.h:216-237); implies "
        "--record-occupancy and is a profiling mode, not a timing mode",
    )
    p.set_defaults(func=cmd_pipeline)


def _add_micro(sub):
    p = sub.add_parser("microbench", help="single-join probe micro-benchmark")
    p.add_argument("--scale", type=int, default=0)
    p.add_argument("--hit-frequency", type=int, default=1)
    p.add_argument("--chunk-factor", type=int, default=1)
    p.add_argument("--n-keys", type=int, default=1 << 24)
    p.add_argument(
        "--variants",
        default="bulk,staged,phased",
        help="comma list from {bulk,staged,phased}; at the reference's"
        " full 134M-key stream use bulk,staged (the phased host loop's"
        " per-round dispatch triple doesn't amortize at that scale)",
    )
    p.set_defaults(func=cmd_micro)


def _add_matrix(sub):
    """The build_versions.sh axis (one binary per compaction strategy,
    build_versions.sh:17-43) as a runtime sweep."""
    p = sub.add_parser(
        "strategy-matrix",
        help="run the pipeline benchmark under every compaction strategy",
    )
    p.add_argument("--join-num", type=int, default=3)
    p.add_argument("--chunk-factor", type=int, default=2)
    p.add_argument("--lhs-size", type=int, default=1_000_000)
    p.add_argument("--rhs-size", type=int, default=100_000)
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument("--table", choices=["lp", "csr"], default="csr")
    p.set_defaults(func=cmd_matrix)


def cmd_matrix(args) -> int:
    import argparse as _ap

    results = {}
    for strategy in ("none", "full", "binary", "dynamic"):
        sub_args = _ap.Namespace(
            join_num=args.join_num,
            chunk_factor=args.chunk_factor,
            lhs_size=args.lhs_size,
            rhs_size=args.rhs_size,
            block_size=args.block_size,
            strategy=strategy,
            table=args.table,
            executor="pipeline",
            payload="reference",
            collect_tuples=False,
            segment_chunks=64,
        )
        print(f"\n==== strategy: {strategy} ====", file=sys.stderr)
        cmd_pipeline(sub_args)
    return 0


def cmd_pipeline(args) -> int:
    from ccve.config import CompactionStrategy, EngineConfig, PayloadMode
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.ops.hash_table import build_csr, build_lp
    from ccve.utils.profiler import BeeProfiler

    strategy = {
        "none": CompactionStrategy.NONE,
        "full": CompactionStrategy.FULL,
        "binary": CompactionStrategy.BINARY,
        "dynamic": CompactionStrategy.DYNAMIC,
    }[args.strategy]
    cfg = EngineConfig(
        block_size=args.block_size,
        n_joins=args.join_num,
        lhs_size=args.lhs_size,
        rhs_size=args.rhs_size,
        chunk_factor=args.chunk_factor,
        strategy=strategy,
        payload_mode=(
            PayloadMode.REFERENCE if args.payload == "reference" else PayloadMode.FULL
        ),
        collect_tuples=args.collect_tuples,
        record_occupancy=getattr(args, "record_occupancy", False)
        or getattr(args, "zebra_profile", False),
        tuner_segment_chunks=args.segment_chunks,
    )
    print(
        f" [Settings] #joins: {cfg.n_joins}, strategy: {strategy.value}, "
        f"table: {args.table}, executor: {args.executor}, "
        f"|LHS|: {cfg.lhs_size}, |RHS|: {cfg.rhs_size}, "
        f"chunk_factor: {cfg.chunk_factor}, block: {cfg.block_size}",
        file=sys.stderr,
    )

    if args.table == "sorted" and args.executor == "pipeline":
        print(
            "--table sorted pairs with --executor bulk or sorted (the "
            "pipelined executor's ScanStructure is a hash-table cursor)",
            file=sys.stderr,
        )
        return 2
    if args.executor == "sorted" and args.table != "sorted":
        print("--executor sorted requires --table sorted", file=sys.stderr)
        return 2

    bee = BeeProfiler.get()
    with bee.time("[Generate Data]"):
        probe = gen_probe_table(cfg.lhs_size, cfg.n_joins, cfg.rhs_size)
        keys, payloads = gen_rhs_table(cfg.rhs_size, cfg.chunk_factor)
    if args.table == "sorted":
        from ccve.ops.sort_merge import build_sorted

        builder = build_sorted
    else:
        builder = build_lp if args.table == "lp" else build_csr
    with bee.time("[Build Hash Tables]"):
        tables = [builder(keys, payloads) for _ in range(cfg.n_joins)]

    if args.executor == "bulk":
        from ccve.exec.bulk import bulk_count

        t0 = time.perf_counter()
        res = bulk_count(tables, probe)
        count = int(res.count)
        elapsed = time.perf_counter() - t0
    else:
        if args.executor == "sorted":
            from ccve.exec.sorted_pipeline import SortedPipeline

            pipe = SortedPipeline(tables, cfg)
        else:
            from ccve.exec.pipeline import JoinPipeline

            pipe = JoinPipeline(tables, cfg)
        zebra_profile = getattr(args, "zebra_profile", False)
        out = pipe.run(
            probe,
            segment_chunks=args.segment_chunks,
            preload=getattr(args, "preload", False),
            zebra_profile=zebra_profile,
        )
        count, elapsed = out["count"], out["seconds"]
        if zebra_profile:
            import random

            from ccve.utils.profiler import ZebraProfiler

            log_dir = f"./zebra_log_0x{random.getrandbits(32):08x}"
            ZebraProfiler.get().to_csv(log_dir)
            print(
                f" [Zebra] {out['zebra_segments']} measured segments "
                f"-> {log_dir}/",
                file=sys.stderr,
            )

    print(f" [Total Time] {elapsed:.4f} s", file=sys.stderr)
    print(
        f" [Throughput] {cfg.lhs_size / elapsed / 1e6:.2f}M probe rows/s",
        file=sys.stderr,
    )
    print(f" [Result Rows] {count}", file=sys.stderr)
    bee.end_profiling()
    return 0


def cmd_micro(args) -> int:
    from ccve.bench.micro import report, run_micro_bench

    results = run_micro_bench(
        scale=args.scale,
        hit_freq=args.hit_frequency,
        chunk_factor=args.chunk_factor,
        n_keys=args.n_keys,
        variants=tuple(args.variants.split(",")),
    )
    print(report(results), file=sys.stderr)
    return 0


def _add_baseline(sub):
    p = sub.add_parser(
        "baseline", help="run a BASELINE.json benchmark configuration"
    )
    p.add_argument(
        "--config", type=int, required=True, choices=[1, 2, 3, 4, 5, 6, 7]
    )
    p.add_argument(
        "--tiny", action="store_true", help="CI-sized workload (CPU-friendly)"
    )
    p.add_argument(
        "--engine",
        choices=["sort_merge", "hash_lp", "hash_csr"],
        default=None,
        help="probe engine for config 1 (default sort_merge); the hash "
        "engines time the reference-shaped gather-probe formulations "
        "at full scale",
    )
    p.add_argument(
        "--wide-span",
        type=int,
        default=None,
        metavar="BITS",
        help="config 1 only: keys spanning ~2^BITS (> pack32's 2^30) — "
        "runs the limb-key wide-domain engine with numpy-verified "
        "count/checksum (bench.configs.config1_wide)",
    )
    p.add_argument(
        "--materialize",
        action="store_true",
        help="config 1 only: time the MATERIALIZING join (sorted_expand "
        "emits every matched triple — the reference's collect_tuples "
        "product, setting.h:31) instead of the count-side engine",
    )
    p.set_defaults(func=cmd_baseline)


def cmd_baseline(args) -> int:
    import json

    import jax

    from ccve.bench.configs import ALL_CONFIGS

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        raise SystemExit(
            f"baseline measures the GPU; the default device is {dev} "
            "(pass --cpu to run on the CPU on purpose)"
        )
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }

    tiny_kwargs = {
        1: dict(n_build=4096, n_probe=65536),
        2: dict(lhs=5000, rhs=512, block=256),
        3: dict(lhs=4000, rhs=256, block=256),
        4: dict(n_probe=50_000, domain=1024),
        5: dict(n_build=2048, n_probe=20_000),
        6: dict(lhs=65536, rhs=2048, block=256, phase_chunks=32,
                segment_chunks=4),
        7: dict(lhs=16384, rhs=512, block=256, segment_chunks=4),
    }
    kwargs = tiny_kwargs[args.config] if args.tiny else {}
    if args.engine is not None:
        if args.config != 1:
            raise SystemExit("--engine applies to --config 1 only")
        kwargs["engine"] = args.engine
    if args.wide_span is not None:
        if args.config != 1:
            raise SystemExit("--wide-span applies to --config 1 only")
        from ccve.bench.configs import config1_wide

        wk = {"span_bits": args.wide_span}
        if args.tiny:
            wk.update(n_build=4096, n_probe=1 << 15)
        print(json.dumps(config1_wide(**wk) | {"device": device},
                         default=str))
        return 0
    if args.materialize:
        if args.config != 1:
            raise SystemExit("--materialize applies to --config 1 only")
        from ccve.bench.configs import config1_materialize

        kwargs.pop("engine", None)
        result = config1_materialize(**kwargs)
        print(json.dumps(result | {"device": device}, default=str))
        return 0
    result = ALL_CONFIGS[args.config](**kwargs)
    print(json.dumps(result | {"device": device}, default=str))
    return 0


def _add_dist(sub):
    p = sub.add_parser(
        "dist",
        help="multi-host distributed join (jax.distributed bootstrap): "
        "one invocation per process; coordinator/process identity from "
        "flags or CCVE_COORDINATOR / CCVE_NUM_PROCESSES / "
        "CCVE_PROCESS_ID (omit everything for a single-process run "
        "over all local devices — the single-host case)",
    )
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--local-device-ids",
        default=None,
        help="comma list of this process's local devices, for several "
        "processes on one host (each needs its own cards)",
    )
    p.add_argument("--n-build", type=int, default=100_000)
    p.add_argument("--n-probe", type=int, default=1_000_000)
    p.add_argument("--n-joins", type=int, default=1)
    p.add_argument("--kind", choices=["sorted", "lp", "csr"],
                   default="sorted")
    p.add_argument(
        "--pipeline-levels", type=int, default=0,
        help="also run the materializing dist_pipeline_expand over this "
        "many levels on a probe subset",
    )
    p.add_argument(
        "--zipf-alpha",
        type=float,
        default=None,
        help="Zipf-skewed probe keys with this exponent + PRPD: the "
        "detected Zipf head is replicated to every shard and masked "
        "out of the radix shuffle (flat shuffle only)",
    )
    p.add_argument(
        "--shuffle",
        choices=["auto", "flat", "hier", "bcast"],
        default="auto",
        help="distribution plan: 'hier' = 2D (process, local) mesh "
        "with the 2-hop shuffle (keys cross the process boundary once, "
        "host-aggregated); 'bcast' = replicated builds, zero per-key "
        "crossings (the amortized plan for small builds); 'auto' picks "
        "hier for multi-process launches with >1 local device",
    )
    p.set_defaults(func=cmd_dist)


def cmd_dist(args) -> int:
    import json

    from ccve.parallel.bootstrap import init_distributed, run_dist_join

    if args.zipf_alpha is not None and args.shuffle == "hier":
        raise SystemExit(
            "error: --shuffle hier cannot be combined with --zipf-alpha: "
            "the PRPD skew path runs on the flat shuffle only. Drop one "
            "of the two flags (--shuffle auto maps to flat under "
            "--zipf-alpha)."
        )
    info = init_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=(
            [int(i) for i in args.local_device_ids.split(",")]
            if args.local_device_ids
            else None
        ),
    )
    out = run_dist_join(
        n_build=args.n_build,
        n_probe=args.n_probe,
        n_joins=args.n_joins,
        kind=args.kind,
        pipeline_levels=args.pipeline_levels,
        hierarchical={
            "auto": None, "flat": False, "hier": True, "bcast": False,
        }[args.shuffle]
        if args.zipf_alpha is None
        else False,
        zipf_alpha=args.zipf_alpha,
        shuffle=args.shuffle if args.shuffle != "auto" else None,
    )
    out["initialized"] = info["initialized"]
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ccve")
    ap.add_argument(
        "--cpu",
        action="store_true",
        help="run on the host CPU backend instead of the GPU — an "
        "explicit choice: `baseline` refuses a non-GPU device without "
        "it, and its results name the device they ran on",
    )
    sub = ap.add_subparsers(required=True)
    _add_pipeline(sub)
    _add_micro(sub)
    _add_matrix(sub)
    _add_baseline(sub)
    _add_dist(sub)
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
