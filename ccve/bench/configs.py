"""Runnable BASELINE.json benchmark configurations.

Each `configN_*` function is size-parameterized (tiny sizes for CI on the
CPU mesh, full sizes for the chip) and returns a metrics dict with at
least {name, rows_per_s or seconds, validation fields}. The CLI exposes
them as `python -m ccve.cli baseline --config N`.

 1. Single equi-join, 1M build / 16M probe uniform (the headline; also
    driven by bench.py).
 2. Chaining-HT join behind a ~10%-selective filter — full vs dynamic
    chunk compaction on under-filled chunks (pipelined executor).
 3. 4-way chained join with ~50% per-level hit rate — the shrinking-chunk
    cascade from the parent project.
 4. Join + hash aggregate + radix sort on Zipf-skewed keys, with
    heavy-hitter / partition-skew statistics.
 5. Distributed hash join over a device mesh with the radix shuffle
    (scaling-efficiency harness; CPU mesh in CI, chip mesh when present).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ccve.config import CompactionStrategy, EngineConfig, PayloadMode


def _timed(fn, *args, reps=3):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def _best_run(pipe, probe, reps=3, **kw):
    """Warm up once, then best-of-`reps` pipeline runs (compiles land
    outside the timing)."""
    pipe.run(probe, **kw)  # warm-up: compiles land outside the timing
    r = pipe.run(probe, **kw)
    best = r
    for _ in range(reps - 1):
        r2 = pipe.run(probe, **kw)
        assert r2["count"] == r["count"], (r2["count"], r["count"])
        if r2["seconds"] < best["seconds"]:
            best = r2
    return best


def _executor_entry(pipe, probe, lhs, reps=3, preloaded=True, **kw):
    """Streamed (reference-driver feed, main.cpp:86-95) AND preloaded
    (device-resident batch — the bulk engine's timing convention, which
    device_puts the probe before `_timed`) numbers for one executor. For
    static count-only runs a SUSTAINED number (run(sustain=N): N full
    runs chained in one dispatch — the bulk loop's methodology) is
    added; it is the number to set against bulk's sustained figures."""
    r = _best_run(pipe, probe, reps=reps, **kw)
    out = {
        "seconds": r["seconds"],
        "rows_per_s": lhs / r["seconds"],
    }
    if preloaded:
        rp = _best_run(pipe, probe, reps=reps, preload=True, **kw)
        assert rp["count"] == r["count"], (rp["count"], r["count"])
        out["preloaded_seconds"] = rp["seconds"]
        out["preloaded_rows_per_s"] = lhs / rp["seconds"]
        if (
            pipe.config.strategy is not CompactionStrategy.DYNAMIC
            and pipe.capacity == 0
        ):
            try:
                rs = _best_run(
                    pipe, probe, reps=reps, preload=True, sustain=8, **kw
                )
                assert rs["count"] == r["count"]
                out["sustained_seconds"] = rs["seconds"]
                out["sustained_rows_per_s"] = lhs / rs["seconds"]
            except ValueError:
                pass
    return r, out


def config1_single_join(n_build=1_000_000, n_probe=16_000_000, engine="sort_merge"):
    """Single equi-join; engine in {sort_merge, hash_lp, hash_csr}."""
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.ops.hash_table import build_csr, build_lp
    from ccve.ops.sort_merge import build_sorted

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)
    builder = {
        "sort_merge": build_sorted,
        "hash_lp": build_lp,
        "hash_csr": build_csr,
    }[engine]
    table = builder(keys, payloads)
    # narrow probe column at load time (keys <= n_build < 2^31): the
    # count side packs it into its i32 sort operand (bench.py does the
    # same)
    probe_dev = jax.device_put(jnp.asarray(probe.astype(np.int32)))

    best, res = _timed(lambda p: bulk_count([table], p), probe_dev)
    expected = int((probe[:, 0] < n_build).sum())
    assert int(res.count) == expected, (int(res.count), expected)
    return {
        "name": "config1_single_join",
        "engine": engine,
        "rows_per_s": n_probe / best,
        "seconds": best,
        "count": int(res.count),
    }


def config1_wide(
    n_build=1_000_000, n_probe=1 << 24, span_bits=40, niter=8
):
    """Config-1-shaped join with keys spanning ~2^span_bits — the wide
    key domain the reference's int64 type system implies
    (base.h:54-56) and pack32 cannot cover. Runs the int64 tagged-stream
    count side; count and payload checksum verified against numpy ground
    truth."""
    from ccve.ops.sort_merge import build_sorted, sorted_match_totals

    rng = np.random.default_rng(1)
    span = 1 << span_bits
    keys = rng.integers(0, span, n_build, dtype=np.int64)
    probe = np.concatenate(
        [
            rng.choice(keys, n_probe // 2),
            rng.integers(0, span, n_probe - n_probe // 2, dtype=np.int64),
        ]
    )
    rng.shuffle(probe)
    payloads = rng.integers(0, 2**30, n_build, dtype=np.int64)

    sk = np.sort(keys)
    lo = np.searchsorted(sk, probe, "left")
    hi = np.searchsorted(sk, probe, "right")
    expected = int((hi - lo).sum())
    order = np.argsort(keys, kind="stable")
    cpay = np.concatenate([[0], np.cumsum(payloads[order])])
    expected_chk = int((cpay[hi] - cpay[lo]).sum())

    table = build_sorted(keys, payloads)
    assert table.pack32 is None and table.span62
    probe_dev = jax.device_put(jnp.asarray(probe))

    c1, chk1 = jax.jit(
        lambda p: sorted_match_totals(table, p)
    )(probe_dev)
    assert int(c1) == expected, (int(c1), expected)
    assert int(chk1) == expected_chk, (int(chk1), expected_chk)

    @jax.jit
    def loop(p):
        def body(_, acc):
            bias = jnp.where(acc < 0, 1, 0).astype(p.dtype)
            c, _ = sorted_match_totals(table, p + bias)
            return acc + c

        return jax.lax.fori_loop(0, niter, body, jnp.int64(0))

    assert int(loop(probe_dev)) == niter * expected
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(probe_dev))
        best = min(best, time.perf_counter() - t0)
    per = best / niter
    return {
        "name": "config1_wide",
        "span_bits": span_bits,
        "seconds": per,
        "rows_per_s": n_probe / per,
        "count": expected,
        "checksum_ok": True,
    }


def config1_materialize(n_build=1_000_000, n_probe=16_000_000):
    """Materializing single join at full scale: `sorted_expand` emits
    every matched (probe_row, build_key, build_payload) triple — the
    reference's observable product (GatherResult,
    chaining_ht.cpp:126-136; flag_collect_tuples, setting.h:31) — and
    the artifact records tuples-out rows/s, not just counts.

    Validation: total == the count-side engine's count, payload sum ==
    its checksum, plus an exact host-side check of sampled triples
    against the generators.

    Probe streams above `EXPAND_TILE_ROWS` auto-split into tiles
    (`sorted_expand_tiled`, ops/sort_merge.py): ONE tile-shaped
    compiled program invoked per tile. Timing covers all tiles
    back-to-back; reading the grand total is the sync."""
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.ops.sort_merge import build_sorted, sorted_expand_tiled

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)
    table = build_sorted(keys, payloads)
    probe_dev = jax.device_put(jnp.asarray(probe[:, 0]))

    ref = bulk_count([table], probe)
    expected = int(ref.count)
    chk = int(ref.payload_checksums[0])

    # warm-up/compile + correctness pass
    tiles, total = sorted_expand_tiled(table, probe_dev)
    assert total == expected, (total, expected)
    psum = sum(int(jnp.sum(t[2])) for t in tiles)
    assert psum == chk, (psum, chk)

    # sampled exactness: triple (r, k, p) must reproduce the generators
    rng = np.random.default_rng(0)
    pay_lookup = dict(zip(keys.tolist(), payloads.tolist()))
    sampled = 0
    for rows, ck, cp, t_total in tiles:
        tt = int(t_total)
        if tt == 0:
            continue
        samp = rng.integers(0, tt, 256)
        r_h = np.asarray(rows)[samp]
        k_h = np.asarray(ck)[samp]
        p_h = np.asarray(cp)[samp]
        assert np.array_equal(k_h, probe[r_h, 0]), "sampled keys mismatch"
        assert all(
            pay_lookup[int(k)] == int(p) for k, p in zip(k_h, p_h)
        ), "sampled payloads mismatch"
        sampled += 256

    def run(p):
        ts, total = sorted_expand_tiled(table, p)
        assert total == expected  # reading the total is the sync
        return ts

    best, _ = _timed(run, probe_dev)
    return {
        "name": "config1_materialize",
        "seconds": best,
        "rows_per_s": n_probe / best,
        "tuples_out": expected,
        "tuples_out_per_s": expected / best,
        "tiles": len(tiles),
        "payload_checksum_ok": True,
        "sampled_triples_ok": sampled,
    }


def config2_filtered_join(
    lhs=1_000_000, rhs=100_000, block=2048, selectivity_mod=10
):
    """Filtered chaining join, full vs dynamic compaction."""
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.oracle import OracleBuildTable, oracle_pipeline
    from ccve.ops import filter as flt
    from ccve.ops.hash_table import build_csr
    from ccve.exec.pipeline import JoinPipeline

    n_joins = 1
    probe = gen_probe_table(lhs, n_joins, rhs)
    keys, payloads = gen_rhs_table(rhs, 2)
    table = build_csr(keys, payloads)
    kept = probe[probe[:, 0] % selectivity_mod == 0]
    expected = oracle_pipeline(
        kept, [OracleBuildTable(keys, payloads)], PayloadMode.REFERENCE
    ).shape[0]

    out = {"name": "config2_filtered_join", "expected": expected}
    for strategy in (CompactionStrategy.FULL, CompactionStrategy.DYNAMIC):
        cfg = EngineConfig(
            block_size=block,
            n_joins=n_joins,
            lhs_size=lhs,
            rhs_size=rhs,
            chunk_factor=2,
            strategy=strategy,
            payload_mode=PayloadMode.REFERENCE,
        )
        pipe = JoinPipeline(
            [table], cfg, prefilter=flt.mod_eq(selectivity_mod, 0)
        )
        r = _best_run(pipe, probe)
        assert r["count"] == expected, (strategy, r["count"], expected)
        out[strategy.value] = {
            "seconds": r["seconds"],
            "rows_per_s": lhs / r["seconds"],
        }

    # the sorted chunk-at-a-time executor (exec/sorted_pipeline.py):
    # same chunk/compaction semantics, batched sort-merge ranks
    from ccve.exec.sorted_pipeline import SortedPipeline
    from ccve.ops.sort_merge import build_sorted

    st = build_sorted(keys, payloads)
    cfg = EngineConfig(
        block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
        chunk_factor=2, strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
    )
    spipe = SortedPipeline(
        [st], cfg, prefilter=flt.mod_eq(selectivity_mod, 0)
    )
    r, entry = _executor_entry(spipe, probe, lhs)
    assert r["count"] == expected, ("sorted", r["count"], expected)
    out["sorted_full"] = entry
    return out


def config3_four_way(lhs=1_000_000, rhs=50_000, block=2048, table_kind="csr"):
    """4-way chained join, ~50% per-level hit rate (shrinking chunks)."""
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.exec.oracle import OracleBuildTable, oracle_pipeline
    from ccve.exec.pipeline import JoinPipeline
    from ccve.ops.hash_table import build_csr, build_lp

    n_joins = 4
    probe = gen_probe_table(lhs, n_joins, 2 * rhs)  # keys in [0, 2*rhs]
    keys, payloads = gen_rhs_table(rhs, 1)
    builder = build_csr if table_kind == "csr" else build_lp
    tables = [builder(keys, payloads) for _ in range(n_joins)]
    expected = oracle_pipeline(
        probe, [OracleBuildTable(keys, payloads)] * n_joins, PayloadMode.REFERENCE
    ).shape[0]

    out = {"name": "config3_four_way", "expected": expected}
    # bulk operator-at-a-time on the engine's BULK table kind (sorted —
    # the gather-free path); the executor variants below keep the
    # chunk-pipeline table kind under test
    from ccve.ops.sort_merge import build_sorted

    st = build_sorted(keys, payloads)
    stables = [st] * n_joins
    bres = bulk_count(stables, probe)
    assert int(bres.count) == expected
    probe_dev = jax.device_put(jnp.asarray(probe))
    best, _ = _timed(lambda p: bulk_count(stables, p), probe_dev)

    # sustained: NITER joins in one dispatch (bench.py methodology)
    NITER = 16

    @jax.jit
    def bulk_loop(p):
        def body(_, acc):
            bias = jnp.where(acc < 0, 1, 0).astype(p.dtype)
            r = bulk_count(stables, p + bias)
            return acc + r.count

        return jax.lax.fori_loop(0, NITER, body, jnp.int64(0))

    assert int(bulk_loop(probe_dev)) == NITER * expected
    t0 = time.perf_counter()
    jax.block_until_ready(bulk_loop(probe_dev))
    sustained = (time.perf_counter() - t0) / NITER
    out["bulk"] = {
        "seconds": sustained,
        "single_dispatch_seconds": best,
        "rows_per_s": lhs / sustained,
    }
    for strategy in (CompactionStrategy.NONE, CompactionStrategy.FULL):
        cfg = EngineConfig(
            block_size=block,
            n_joins=n_joins,
            lhs_size=lhs,
            rhs_size=rhs,
            strategy=strategy,
            payload_mode=PayloadMode.REFERENCE,
        )
        pipe = JoinPipeline(tables, cfg)
        r = _best_run(pipe, probe)
        assert r["count"] == expected, (strategy, r["count"], expected)
        out[strategy.value] = {
            "seconds": r["seconds"],
            "rows_per_s": lhs / r["seconds"],
        }

    # sorted chunk-at-a-time executor over the same 4 levels
    from ccve.exec.sorted_pipeline import SortedPipeline

    for strategy in (CompactionStrategy.NONE, CompactionStrategy.FULL):
        cfg = EngineConfig(
            block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
            strategy=strategy, payload_mode=PayloadMode.REFERENCE,
        )
        spipe = SortedPipeline(stables, cfg)
        r, entry = _executor_entry(spipe, probe, lhs)
        assert r["count"] == expected, ("sorted", strategy, r["count"])
        out[f"sorted_{strategy.value}"] = entry
    return out


def config4_zipf_pipeline(n_probe=4_000_000, domain=100_000, alpha=1.1):
    """Zipf join + hash aggregate + radix sort, with skew stats."""
    from ccve.core.datagen import gen_rhs_table, gen_zipf_keys
    from ccve.ops.aggregate import join_dense_aggregate, partition_histogram
    from ccve.ops.sort_merge import build_sorted
    from ccve.ops.sort import xla_sort_pairs

    keys, payloads = gen_rhs_table(domain, 1)  # keys == arange(domain)
    table = build_sorted(keys, payloads)
    probe = jnp.asarray(gen_zipf_keys(n_probe, domain, alpha))

    @jax.jit
    def run(p):
        # aggregate pushdown: group-by key == join key and the table's
        # keys are unique over [0, domain), so the dense aggregate is
        # algebra over the count-side join's per-row counts — no 4M-row
        # scatters (ops/aggregate.join_dense_aggregate; equivalence with
        # the scatter path is asserted in tests/test_aggregate.py)
        agg, total = join_dense_aggregate(table, p, domain)
        # ORDER BY uses XLA's own sort; the LSD radix component
        # (ops/sort.py) is 6 counting passes whose rank one-hots and
        # permutation scatters only pay when digits are reused across
        # queries.
        sk, sv = xla_sort_pairs(agg.sum, agg.keys)
        return total, agg.n_groups, sk[-1], sv[-1]

    best, out = _timed(run, probe)

    # Sustained throughput: NITER queries in ONE device dispatch (the
    # same methodology as bench.py's headline loop). The data-dependent
    # (always-zero) bias defeats loop-invariant motion.
    NITER = 16
    probe_dev = jax.device_put(probe)

    @jax.jit
    def run_loop(p):
        def body(_, acc):
            bias = jnp.where(acc < 0, 1, 0).astype(p.dtype)
            total, _, _, sv_last = run(p + bias)
            return acc + total + sv_last

        return jax.lax.fori_loop(0, NITER, body, jnp.int64(0))

    jax.block_until_ready(run_loop(probe_dev))  # warm-up / compile
    t0 = time.perf_counter()
    jax.block_until_ready(run_loop(probe_dev))
    sustained = (time.perf_counter() - t0) / NITER

    hist = np.asarray(partition_histogram(probe, 16))
    skew = float(hist.max() / max(hist.mean(), 1.0))
    return {
        "name": "config4_zipf_pipeline",
        "seconds": sustained,
        "single_dispatch_seconds": best,
        "rows_per_s": n_probe / sustained,
        "matches": int(out[0]),
        "n_groups": int(out[1]),
        "partition_skew_16": skew,
    }


def config5_distributed(n_build=100_000, n_probe=1_000_000, n_devices=None):
    """Distributed join: radix shuffle on the available mesh + per-device
    scaling efficiency vs the single-device bulk path."""
    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.exec.bulk import bulk_count
    from ccve.ops.sort_merge import build_sorted
    from ccve.parallel.distributed import (
        dist_bulk_count,
        make_join_mesh,
        partition_tables,
    )

    n_devices = n_devices or len(jax.devices())
    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)

    # single-device reference timing (sort-merge engine)
    table = build_sorted(keys, payloads)
    probe_dev = jax.device_put(jnp.asarray(probe))
    t1, ref = _timed(lambda p: bulk_count([table], p), probe_dev)

    mesh = make_join_mesh(n_devices)
    ptables = [partition_tables(keys, payloads, n_devices, "sorted", mesh)]
    tp, res = _timed(lambda p: dist_bulk_count(mesh, ptables, p), probe)
    assert int(res.count) == int(ref.count)
    eff = (n_probe / tp) / (n_devices * (n_probe / t1))

    # broadcast plan (replicated builds, zero per-key crossings — the
    # shuffle amortization) on the same mesh, same count cross-check
    from ccve.parallel.distributed import (
        dist_bulk_count_bcast,
        replicate_tables,
    )

    rtables = [replicate_tables(keys, payloads, "sorted", mesh)]
    tb, resb = _timed(
        lambda p: dist_bulk_count_bcast(mesh, rtables, p), probe
    )
    assert int(resb.count) == int(ref.count)
    effb = (n_probe / tb) / (n_devices * (n_probe / t1))

    return {
        "name": "config5_distributed",
        "n_devices": n_devices,
        "rows_per_s": n_probe / tp,
        "single_device_rows_per_s": n_probe / t1,
        "scaling_efficiency": eff,
        "bcast_rows_per_s": n_probe / tb,
        "bcast_scaling_efficiency": effb,
        "skew": float(res.skew),
        "overflow": bool(res.overflow),
    }


def config6_mixed_selectivity(
    lhs=2_000_000,
    rhs=50_000,
    block=2048,
    phase_chunks=128,
    mod=10,
    segment_chunks=8,
    log_dir=None,
):
    """Phase-alternating selectivity — the adaptive-compaction showcase.

    The probe stream alternates phases every `phase_chunks` chunks: in
    phase A, column 0 holds multiples of `mod` (the prefilter passes
    ~100% → level-0 chunks stay nearly full → compaction is pure
    pass-through); in phase B column 0 is uniform (the filter passes
    ~1/mod → tiny chunks cascade into level 1 → full compaction is
    best). Per-level credit assignment uses coordinate exploration on
    the host path (exec/pipeline.run) and per-level occupancy rewards on
    the device path (exec/pipeline._process_seg_device_dynamic).

    Structure: unlike the parent project's CPU executor — where
    compaction is a real memcpy cost, so NONE wins full-chunk phases and
    a tuned threshold can beat both statics — this executor's work-loop
    step is ONE fixed-shape branch-free op chain whose cost does not
    depend on occupancy, and a full incoming chunk passes through the
    compactor untouched (compactor.cpp:6 semantics). Steps(FULL) <=
    Steps(any threshold) for every stream, so FULL weakly dominates and
    DYNAMIC's ceiling is parity with FULL: the bandit's job is regret,
    not discovery. `dynamic_vs_best_static` reports the regret ratio.
    """
    from ccve.core.datagen import gen_rhs_table
    from ccve.exec.oracle import OracleBuildTable, oracle_pipeline
    from ccve.exec.pipeline import JoinPipeline
    from ccve.control.bandit import CompactTuner
    from ccve.ops import filter as flt
    from ccve.ops.hash_table import build_csr

    n_joins = 2
    rng = np.random.default_rng(7)
    probe = np.empty((lhs, n_joins), np.int64)
    phase_rows = phase_chunks * block
    phase = (np.arange(lhs) // phase_rows) % 2
    n_a = int((phase == 0).sum())
    probe[:, 0] = rng.integers(0, rhs, lhs)
    probe[phase == 0, 0] = (
        rng.integers(0, rhs // mod, n_a) * mod
    )  # phase A: all pass x % mod == 0
    probe[:, 1] = rng.integers(0, rhs, lhs)

    keys, payloads = gen_rhs_table(rhs, 1)
    tables = [build_csr(keys, payloads) for _ in range(n_joins)]
    kept = probe[probe[:, 0] % mod == 0]
    expected = oracle_pipeline(
        kept, [OracleBuildTable(keys, payloads)] * n_joins,
        PayloadMode.REFERENCE,
    ).shape[0]

    out = {
        "name": "config6_mixed_selectivity",
        "expected": expected,
        "phase_chunks": phase_chunks,
    }
    for strategy, device_tuner in (
        (CompactionStrategy.NONE, False),
        (CompactionStrategy.FULL, False),
        (CompactionStrategy.DYNAMIC, False),
        (CompactionStrategy.DYNAMIC, True),
    ):
        cfg = EngineConfig(
            block_size=block, n_joins=n_joins, lhs_size=lhs, rhs_size=rhs,
            strategy=strategy, payload_mode=PayloadMode.REFERENCE,
            tuner_segment_chunks=segment_chunks, device_tuner=device_tuner,
            # 4 coarse block-fraction arms instead of the reference's
            # 9-rung ladder: with a COMMITTING bandit the arm count IS
            # the exploration budget, and the occupancy reward separates
            # 0 / b/2 / 3b/4 / b more clearly than adjacent rungs. The
            # reference's list is still the default elsewhere
            # (resolved_threshold_arms).
            threshold_arms=(0, block // 2, 3 * block // 4, block),
            # with the causally-shifted reward (exec/pipeline.py
            # _process_seg_device_dynamic) the greedy arm separates
            # within a couple of updates
            bandit_commit_after=6,
        )
        pipe = JoinPipeline(
            tables, cfg, prefilter=flt.mod_eq(mod, 0)
        )
        host_dyn = (
            strategy is CompactionStrategy.DYNAMIC and not device_tuner
        )
        tuner = CompactTuner() if host_dyn else None
        # the host bandit pays one host read per segment — give it
        # coarser segments than the sync-free device tuner
        seg = {"segment_chunks": 4 * segment_chunks} if host_dyn else {}
        r = _best_run(pipe, probe, tuner=tuner, **seg)
        assert r["count"] == expected, (strategy, r["count"], expected)
        name = strategy.value + ("_device" if device_tuner else "")
        out[name] = {
            "seconds": r["seconds"],
            "rows_per_s": lhs / r["seconds"],
        }
        if host_dyn and log_dir:
            tuner.reset(enable_log=True, log_dir=log_dir)
            out["bandit_log"] = log_dir
        if device_tuner:
            out[name]["greedy_thresholds"] = r["greedy_thresholds"].tolist()
            out[name]["bandit_committed"] = r["bandit_committed"].tolist()
            out[name]["bandit_commit_round"] = r["bandit_commit_t"].tolist()
    best_static = min(
        out["no_compaction"]["seconds"], out["full_compaction"]["seconds"]
    )
    out["dynamic_vs_best_static"] = (
        best_static / out["dynamic_compaction_device"]["seconds"]
    )
    return out


def config7_heterogeneous_levels(
    lhs=2_000_000, rhs=50_000, block=2048, segment_chunks=16, rounds=3
):
    """Per-level heterogeneous compaction on the sorted executor — the
    rigorous test of whether ANY compaction policy (uniform, per-level
    static, or bandit-tuned) matters on this engine.

    4-level join with per-level hit rates engineered so the per-level
    optimum would differ if the CPU cost model applied: level 0 at 95%
    occupancy (absorbing nearly-full chunks should be wasted copies),
    level 1 at 3% (tiny emissions cascading into a 2-level subtree —
    compaction's best case), levels 2-3 full-hit. Strategies are timed
    in INTERLEAVED rounds, so drift hits all of them alike, and every
    variant is count-checked.

    Structure: with the branchy per-chunk compact (pass-throughs free)
    and the branchy descend (empty emissions skip the whole subtree), a
    drain step's cost does not depend on occupancy and an absorb costs
    about one level-step, so the tiny-chunk cascade that compaction
    exists to fix on CPUs is absent by construction. DYNAMIC's ceiling
    on this executor is parity; the device bandit's job is
    zero-knowledge convergence to a co-optimal arm vector.
    """
    import dataclasses

    from ccve.core.datagen import gen_rhs_table
    from ccve.exec.sorted_pipeline import SortedPipeline
    from ccve.ops.sort_merge import build_sorted

    rng = np.random.default_rng(2)
    hit_rates = (0.95, 0.03, 1.0, 1.0)
    probe = np.stack(
        [
            rng.integers(0, max(int(rhs / h), 1), size=lhs, dtype=np.int64)
            for h in hit_rates
        ],
        axis=1,
    )
    keys, payloads = gen_rhs_table(rhs, 1)
    st = build_sorted(keys, payloads)
    tables = [st] * 4

    base = EngineConfig(
        block_size=block, n_joins=4, lhs_size=lhs, rhs_size=rhs,
        strategy=CompactionStrategy.FULL,
        payload_mode=PayloadMode.REFERENCE,
        threshold_arms=(0, block),
        tuner_segment_chunks=segment_chunks,
    )
    cases = {
        "no_compaction": dataclasses.replace(
            base, strategy=CompactionStrategy.NONE
        ),
        "full_compaction": base,
        "mixed_static": dataclasses.replace(
            base, compact_threshold_per_level=(0, block, 0, 0)
        ),
        "dynamic_compaction_device": dataclasses.replace(
            base, strategy=CompactionStrategy.DYNAMIC, device_tuner=True
        ),
    }
    out = {
        "name": "config7_heterogeneous_levels",
        "hit_rates": hit_rates,
        # self-describing artifact: every variant below is timed with
        # device-resident feeds (NOT the reference driver's streamed
        # convention, main.cpp:86-95), so the host feed does not bound
        # the policy spread the config exists to measure
        "timing_convention": "preloaded",
    }
    pipes = {n: SortedPipeline(tables, c) for n, c in cases.items()}
    expected = None
    best = {}
    for name, pipe in pipes.items():  # warm-up: compiles + count check
        r = pipe.run(probe, preload=True)
        if expected is None:
            expected = r["count"]
        assert r["count"] == expected, (name, r["count"], expected)
        best[name] = r
    for _ in range(rounds):  # interleaved: drift hits all cases alike
        for name, pipe in pipes.items():
            r = pipe.run(probe, preload=True)
            assert r["count"] == expected, (name, r["count"], expected)
            if r["seconds"] < best[name]["seconds"]:
                best[name] = r
    for name, r in best.items():
        out[name] = {
            "seconds": r["seconds"],
            "rows_per_s": lhs / r["seconds"],
        }
        if "greedy_thresholds" in r:
            out[name]["greedy_thresholds"] = r[
                "greedy_thresholds"
            ].tolist()
    best_static = min(
        out["no_compaction"]["seconds"], out["full_compaction"]["seconds"]
    )
    out["dynamic_vs_best_static"] = (
        best_static / out["dynamic_compaction_device"]["seconds"]
    )
    return out


ALL_CONFIGS = {
    1: config1_single_join,
    2: config2_filtered_join,
    3: config3_four_way,
    4: config4_zipf_pipeline,
    5: config5_distributed,
    6: config6_mixed_selectivity,
    7: config7_heterogeneous_levels,
}
