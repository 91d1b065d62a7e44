"""Single-join probe micro-benchmark — the reference's 8-variant matrix.

`simd_micro_bench.cpp:75-362` times {SIMD, scalar} x {staged Next, fused
InOneNext} x {chaining, linear-probing} in cycles/key over a glibc-rand key
stream. Under XLA the {SIMD, scalar} axis is meaningless (XLA vectorizes
everything), and the meaningful execution-style axes are:

 - **bulk fused**   — whole-batch `match_stats` (exec/bulk.py): one fused
   hash+gather+compare+advance stream, the InOneNext analogue;
 - **staged scan**  — chunked probe + scan_next drain (ops/hash_table.py):
   the 4-phase Next analogue, with per-phase device timing via separate
   dispatches (hash/prefilter = probe, match+gather+advance = scan_next).

crossed with {linear-probing, chaining/CSR}, giving the same 2x2(x phases)
coverage. The key stream reproduces simd_micro_bench.cpp:78-79 bit-exactly
(glibc rand() & (rhs_tuples*hit_freq - 1), core/datagen.py) and every
variant reports its matched-tuple count — the reference's cross-check
(simd_micro_bench.cpp:116 et al.) — which must agree across variants.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ccve.core.chunk import iota_sel
from ccve.core.datagen import gen_microbench_keys, gen_rhs_table
from ccve.exec.bulk import match_stats
from ccve.ops.hash_table import (
    build_csr,
    build_lp,
    csr_probe,
    lp_probe,
    scan_advance,
    scan_gather,
    scan_match,
    scan_next,
)


@dataclass
class VariantResult:
    name: str
    seconds: float
    n_keys: int
    tuples: int
    phase_seconds: dict | None = None
    phase_profiler: object = None
    tile_rows: int | None = None  # None = whole-stream dispatch

    @property
    def ns_per_key(self) -> float:
        return self.seconds * 1e9 / self.n_keys


def _time(fn, warmup=1, reps=3):
    for _ in range(warmup):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm = time.perf_counter() - t0
    if warm > 5.0:
        # full-scale (reference 134M-key) regime: extra reps would
        # triple a multi-minute run for no precision gain
        reps = 1
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, out


def run_bulk_variant(
    table, keys_dev, name: str, tile_rows: int | None = None
) -> VariantResult:
    """`tile_rows`: process the stream in fixed tiles inside ONE jitted
    dispatch (lax.map). The LP drain's halving-ladder survivor structure
    does not depend on scale, but at the reference's 134M keys the
    ladder materializes GB-scale compaction buffers; tiling bounds every
    gather/scatter's working set. Counts are additive over tiles."""
    n = keys_dev.shape[0]
    if tile_rows and n > tile_rows:
        # Pad the tail tile so non-divisible streams still tile: counts
        # are additive and the pad key (-1) is outside every generated
        # table domain (all table keys are >= 0), so it contributes 0
        # tuples. The result records tile_rows so artifacts are
        # unambiguous about which regime was measured.
        pad = (-n) % tile_rows
        if pad:
            keys_dev = jnp.concatenate(
                [keys_dev, jnp.full((pad,), -1, keys_dev.dtype)]
            )
        grid = keys_dev.reshape(-1, tile_rows)
        fn = jax.jit(
            lambda g: jax.lax.map(
                lambda k: match_stats(table, k)
                .mult.astype(jnp.int64)
                .sum(),
                g,
            ).sum()
        )
        secs, total = _time(lambda: fn(grid))
        return VariantResult(
            name=name,
            seconds=secs,
            n_keys=n,
            tuples=int(total),
            tile_rows=tile_rows,
        )
    fn = jax.jit(lambda k: match_stats(table, k).mult.astype(jnp.int64).sum())
    secs, total = _time(lambda: fn(keys_dev))
    return VariantResult(
        name=name, seconds=secs, n_keys=n, tuples=int(total)
    )


def run_staged_variant(
    table, keys_dev, block: int, name: str, max_steps: int = 64
) -> VariantResult:
    """Chunked staged probe: probe once per chunk, then scan_next drained a
    bounded number of steps inside one jitted scan per phase-visible stage.
    Phases timed as separate dispatches: 'probe' (hash+prefilter) vs
    'drain' (match+gather+advance loop)."""
    n = keys_dev.shape[0]
    n_chunks = n // block
    keys_grid = keys_dev[: n_chunks * block].reshape(n_chunks, block)
    is_lp = "lp" in name

    prober = lp_probe if is_lp else csr_probe
    sel = iota_sel(block)
    cnt = jnp.asarray(block, jnp.int32)

    @jax.jit
    def probe_all(kg):
        def one(_, k):
            st = prober(table, k, sel, cnt)
            return None, st

        _, states = jax.lax.scan(one, None, kg)
        return states

    @jax.jit
    def drain_all(kg, states):
        def one(_, xs):
            k, st0 = xs

            def body(carry):
                st, total = carry
                res = scan_next(table, k, st)
                return res.state, total + res.result_count.astype(jnp.int64)

            def cond(carry):
                st, _ = carry
                return st.count > 0

            st, total = jax.lax.while_loop(
                cond, body, (st0, jnp.asarray(0, jnp.int64))
            )
            return None, total

        _, totals = jax.lax.scan(one, None, (kg, states))
        return totals.sum()

    p_secs, states = _time(lambda: probe_all(keys_grid))
    d_secs, total = _time(lambda: drain_all(keys_grid, states))
    return VariantResult(
        name=name,
        seconds=p_secs + d_secs,
        n_keys=n_chunks * block,
        tuples=int(total),
        phase_seconds={"probe": p_secs, "drain": d_secs},
    )


def run_phased_variant(
    table, keys_dev, block: int, name: str, max_iters: int = 512
) -> VariantResult:
    """4-phase attribution — the reference's CycleProfiler report
    (profiler.h:264-290; simd_micro_bench.cpp:108-116 prints cycles/key
    for hash / match / gather / advance). rdtsc-around-inner-loops is
    meaningless under XLA fusion, so each phase runs as its OWN jitted
    dispatch over the whole chunk grid (ops/hash_table.scan_match /
    scan_gather / scan_advance), one dispatch triple per drain round,
    each timed to `block_until_ready`. Results accumulate in
    a `utils.profiler.PhaseProfiler` (returned via `.phase_profiler`)
    with approximate byte counts (16 B/item: one 8 B key read +
    one 8 B state touch per live row per phase)."""
    from ccve.utils.profiler import PhaseProfiler

    n = keys_dev.shape[0]
    n_chunks = n // block
    keys_grid = keys_dev[: n_chunks * block].reshape(n_chunks, block)
    is_lp = "lp" in name
    prober = lp_probe if is_lp else csr_probe
    sel = iota_sel(block)
    cnt = jnp.asarray(block, jnp.int32)
    prof = PhaseProfiler()

    @jax.jit
    def hash_all(kg):
        def one(_, k):
            return None, prober(table, k, sel, cnt)

        _, states = jax.lax.scan(one, None, kg)
        return states

    @jax.jit
    def match_all(kg, states):
        def one(_, xs):
            k, st = xs
            rv, rc = scan_match(table, k, st)
            return None, (rv, rc)

        _, (rvs, rcs) = jax.lax.scan(one, None, (kg, states))
        return rvs, rcs, rcs.astype(jnp.int64).sum()

    @jax.jit
    def gather_all(states, rvs):
        def one(_, xs):
            st, rv = xs
            mk, mp = scan_gather(table, st, rv)
            return None, mk[0] + mp[0]

        _, checks = jax.lax.scan(one, None, (states, rvs))
        return checks.sum()

    @jax.jit
    def advance_all(states):
        def one(_, st):
            return None, scan_advance(table, st)

        _, new_states = jax.lax.scan(one, None, states)
        return new_states, new_states.count.astype(jnp.int64).sum()

    t0 = time.perf_counter()
    states = jax.block_until_ready(hash_all(keys_grid))
    prof.record("hash", time.perf_counter() - t0, n, 16 * n)

    tuples = 0
    live = int(states.count.astype(jnp.int64).sum())
    iters = 0
    while live > 0 and iters < max_iters:
        t0 = time.perf_counter()
        rvs, rcs, total = match_all(keys_grid, states)
        matched = int(total)  # readback = the sync
        prof.record("match", time.perf_counter() - t0, live, 16 * live)
        tuples += matched

        t0 = time.perf_counter()
        chk = int(gather_all(states, rvs))  # checksum keeps it live
        prof.record("gather", time.perf_counter() - t0, matched,
                    16 * matched)

        t0 = time.perf_counter()
        states, nlive = advance_all(states)
        live = int(nlive)
        prof.record("advance", time.perf_counter() - t0, live + matched,
                    16 * (live + matched))
        iters += 1

    return VariantResult(
        name=name,
        seconds=sum(s.seconds for s in prof.stats().values()),
        n_keys=n_chunks * block,
        tuples=tuples,
        phase_seconds={p: s.seconds for p, s in prof.stats().items()},
        phase_profiler=prof,
    )


def run_micro_bench(
    scale: int = 0,
    hit_freq: int = 1,
    chunk_factor: int = 1,
    n_keys: int | None = None,
    variants: tuple[str, ...] = ("bulk", "staged", "phased"),
) -> list[VariantResult]:
    """The full matrix. Geometry mirrors simd_micro_bench.cpp:62-63:
    block = 256 << scale (rounded up to a multiple of 128), rhs_tuples =
    128 << scale; key stream = glibc rand masked (simd_micro_bench.cpp:78-79).
    The reference streams 1024<<17 keys; default here is 2^24 (tunable)."""
    block = max(256 << scale, 128)
    rhs_tuples = 128 << scale
    n_keys = n_keys or (1 << 24)
    keys = gen_microbench_keys(n_keys, rhs_tuples, hit_freq)
    build_keys, build_payloads = gen_rhs_table(rhs_tuples, chunk_factor)

    lp = build_lp(build_keys, build_payloads)
    csr = build_csr(build_keys, build_payloads)
    keys_dev = jax.device_put(jnp.asarray(keys))
    jax.block_until_ready(keys_dev)

    results = []
    if "bulk" in variants:
        # LP tiles above 2^24 keys (see run_bulk_variant docstring);
        # CSR held 84.1 ns/key whole-stream at 134M — left untiled
        lp_tile = (1 << 21) if n_keys > (1 << 24) else None
        results += [
            run_bulk_variant(lp, keys_dev, "bulk_fused_lp",
                             tile_rows=lp_tile),
            run_bulk_variant(csr, keys_dev, "bulk_fused_csr"),
        ]
    if "staged" in variants:
        results += [
            run_staged_variant(lp, keys_dev, block, "staged_scan_lp"),
            run_staged_variant(csr, keys_dev, block, "staged_scan_csr"),
        ]
    if "phased" in variants:
        results += [
            run_phased_variant(lp, keys_dev, block, "phased_lp"),
            run_phased_variant(csr, keys_dev, block, "phased_csr"),
        ]
    counts = {r.tuples for r in results}
    assert len(counts) == 1, f"variant tuple counts disagree: {counts}"
    return results


def report(results: list[VariantResult]) -> str:
    lines = []
    for r in results:
        phases = ""
        if r.phase_seconds:
            phases = "  (" + ", ".join(
                f"{k} {v * 1e9 / r.n_keys:.2f} ns/key"
                for k, v in r.phase_seconds.items()
            ) + ")"
        lines.append(
            f" {r.name:18s} {r.ns_per_key:8.3f} ns/key  "
            f"#tuples {r.tuples}{phases}"
        )
        if r.phase_profiler is not None:
            # the reference's CycleProfiler table
            # (simd_micro_bench.cpp:108-116), ns/key instead of cycles
            lines.append(r.phase_profiler.report(total_items=r.n_keys))
    return "\n".join(lines)
