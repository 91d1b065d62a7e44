"""Bulk operator-at-a-time executor — the single-chip throughput path.

The chunk-at-a-time executor (exec/pipeline.py) reproduces the reference's
pipelined traversal (main.cpp:119-191) chunk for chunk; this module is the
bulk alternative: process the WHOLE probe batch per operator, with no
per-chunk control flow, so XLA sees one huge fused gather/compare stream
per join level — the shape the hardware actually wants.

The N-way pipeline factorizes. Level l always probes ORIGINAL probe column
l (main.cpp:131: `join_key = input.data_[level]`), so a probe row that
matches m_l build rows at level l emits Π_l m_l output rows in total, and

    total rows  = Σ_i Π_l  mult(i, l)
    Σ payload_l = Σ_i psum(i, l) · Π_{k≠l} mult(i, k)

where mult(i, l) is row i's match count at level l and psum(i, l) the sum
of its matched payloads. Counting and checksumming the full join therefore
needs NO fan-out materialization — one `match_stats` sweep per level.
`match_stats` is the hot kernel: hash + gather + compare + advance over the
whole batch, iterated to drain duplicate chains with a live-lane early-exit
(`lax.while_loop` ends when every lane has hit its chain end).

For materialized results use `bulk_materialize` (static-width candidate
grids, exact row multiset vs the oracle) or the pipelined executor.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ccve.ops.hash_table import (
    CSRTable,
    EMPTY,
    LPTable,
    csr_expand_grid,
    lp_expand_grid,
)
from ccve.ops.hashing import murmurhash64


class MatchStats(NamedTuple):
    mult: jax.Array  # int32[n]: matches per probe key
    psum: jax.Array  # int64[n]: sum of matched payloads per probe key


def compact_survivors(live: jax.Array, new_cap: int, *cols: jax.Array):
    """Stream compaction of the LP drain's surviving lanes: a prefix
    count of `live` and one scatter per column pack the live entries of
    each column to the front of a `new_cap` buffer. Returns (n_live,
    packed columns); when n_live > new_cap the overflow lanes collide
    in the last slot, and the caller must detect it."""
    pos = jnp.cumsum(live.astype(jnp.int32)) - 1
    dst = jnp.where(live, jnp.minimum(pos, new_cap - 1), new_cap)
    return pos[-1] + 1, tuple(
        jnp.zeros(new_cap, c.dtype).at[dst].set(c, mode="drop") for c in cols
    )


def lp_match_stats(
    table: LPTable,
    keys: jax.Array,
    compact_lanes: bool | None = None,
) -> MatchStats:
    """Drain the LP chain of every key: advance until the first EMPTY slot
    per lane (linear_probing_ht.cpp:60-115).

    At load factor <= 25% (the build invariant, linear_probing_ht.cpp:5-6)
    only ~25% of lanes survive each step, so iterating at full width wastes
    ~4x bandwidth per extra step. With `compact_lanes` (default on for
    large batches), surviving lanes are stream-compacted into buffers on a
    fixed shrink schedule (n/4 -> n/16 -> ...) between steps — the bulk
    analogue of the reference's `bucket_sel_vector_` re-compaction
    (chaining_ht.cpp:113-122). A lane-count overflow of the schedule (only
    possible far above the design load factor) falls back to the
    full-width path for the remaining lanes.
    """
    n = keys.shape[0]
    slot_mask = jnp.uint64(table.n_slots - 1)
    h = (murmurhash64(keys) & slot_mask).astype(jnp.int32)
    if compact_lanes is None:
        compact_lanes = n >= (1 << 16)

    zero64 = keys ^ keys  # varying-typed zeros (shard_map vma agreement)
    mult = zero64.astype(jnp.int32)
    psum = zero64

    def step(keys_c, cursor_c, live_c):
        """One probe step at the current (compacted) width."""
        cand = jnp.take(table.slot_keys, cursor_c)
        occupied = live_c & (cand != EMPTY)
        hit = occupied & (cand == keys_c)
        pay = jnp.take(table.slot_payloads, cursor_c)
        nxt = (cursor_c + 1) & jnp.int32(table.n_slots - 1)
        return hit, jnp.where(hit, pay, 0), occupied, nxt

    if not compact_lanes:
        def cond(st):
            _, _, _, live = st
            return jnp.any(live)

        def body(st):
            cursor, m, p, live = st
            hit, payc, occupied, nxt = step(keys, cursor, live)
            return nxt, m + hit.astype(jnp.int32), p + payc, occupied

        _, mult, psum, _ = jax.lax.while_loop(
            cond, body, (h, mult, psum, keys == keys)
        )
        return MatchStats(mult=mult, psum=psum)

    # --- compacted schedule ------------------------------------------------
    # Step 0 runs at full width with lane-aligned accumulators (no
    # scatter). Each later stage compacts survivors ~4x (with slack — LP
    # occupancy clusters into runs, so the independent-slot estimate is
    # optimistic), runs ONE step, and flushes that step's hits back with a
    # single scatter-add of only the hitting lanes. The tail drains in a
    # while_loop with STAGE-LOCAL accumulators flushed once at the end:
    # a scatter-add into the full-width arrays inside the loop would copy
    # whole arrays per iteration.
    hit, payc, live_c, cursor_c = step(keys, h, keys == keys)
    mult = hit.astype(jnp.int32)
    psum = payc

    keys_c = keys
    idx_c = jnp.arange(n, dtype=jnp.int32)
    cap = n
    floor = max(n // 16, 16384)
    overflowed = jnp.asarray(False)
    # Halving caps with a floor: LP occupancy clusters into runs, so
    # survivor counts decay much slower than the 4x independent-slot
    # estimate — 4x caps would overflow at stage 2+. Halving keeps >=2x
    # margin at 25% load; the floor bounds the number of flush scatters.
    while cap > floor:
        new_cap = max(cap // 2, floor)
        n_live, (keys_c, cursor_c, idx_c) = compact_survivors(
            live_c, new_cap, keys_c, cursor_c, idx_c
        )
        overflowed = overflowed | (n_live > new_cap)
        lane = jnp.arange(new_cap, dtype=jnp.int32)
        live_c = lane < jnp.minimum(n_live, new_cap)
        cap = new_cap

        hit, payc, live_c, cursor_c = step(keys_c, cursor_c, live_c)
        safe_idx = jnp.where(hit, idx_c, n)  # touch only rows that hit
        mult = mult.at[safe_idx].add(hit.astype(jnp.int32), mode="drop")
        psum = psum.at[safe_idx].add(payc, mode="drop")

    # Drain the tail at the final width with stage-local accumulators.
    def cond(st):
        _, _, live, _, _ = st
        return jnp.any(live)

    def body(st):
        cursor_t, keys_t, live_t, am, ap = st
        hit, payc, live2, nxt = step(keys_t, cursor_t, live_t)
        return nxt, keys_t, live2, am + hit.astype(jnp.int32), ap + payc

    zc = keys_c ^ keys_c
    _, _, _, acc_m, acc_p = jax.lax.while_loop(
        cond,
        body,
        (cursor_c, keys_c, live_c, zc.astype(jnp.int32), zc),
    )
    safe_idx = jnp.where(acc_m > 0, idx_c, n)
    mult = mult.at[safe_idx].add(acc_m, mode="drop")
    psum = psum.at[safe_idx].add(acc_p, mode="drop")

    # Overflow fallback: recompute exactly at full width (rare by design).
    def full(_):
        return lp_match_stats(table, keys, compact_lanes=False)

    def keep(_):
        return MatchStats(mult=mult, psum=psum)

    return jax.lax.cond(overflowed, full, keep, None)


def csr_match_stats(table: CSRTable, keys: jax.Array) -> MatchStats:
    """Drain each key's bucket entries (chaining_ht.cpp:82-124) in
    lock-step with early exit."""
    n = keys.shape[0]
    bucket_mask = jnp.uint64(table.n_buckets - 1)
    b = (murmurhash64(keys) & bucket_mask).astype(jnp.int32)
    cursor = jnp.take(table.offsets, b).astype(jnp.int32)
    end = jnp.take(table.offsets, b + 1).astype(jnp.int32)

    def cond(st):
        cursor, end, _, _ = st
        return jnp.any(cursor < end)

    def body(st):
        cursor, end, mult, psum = st
        live = cursor < end
        safe = jnp.where(live, cursor, 0)
        cand = jnp.take(table.entry_keys, safe)
        hit = live & (cand == keys)
        mult = mult + hit.astype(jnp.int32)
        pay = jnp.take(table.entry_payloads, safe)
        psum = psum + jnp.where(hit, pay, 0)
        return cursor + 1, end, mult, psum

    zero64 = keys ^ keys  # varying-typed zeros (see lp_match_stats)
    init = (cursor, end, zero64.astype(jnp.int32), zero64)
    _, _, mult, psum = jax.lax.while_loop(cond, body, init)
    return MatchStats(mult=mult, psum=psum)


def match_stats(table, keys: jax.Array) -> MatchStats:
    from ccve.ops.sort_merge import SortedTable, sorted_match_stats

    if isinstance(table, SortedTable):
        return sorted_match_stats(table, keys)
    keys = keys.astype(jnp.int64)  # narrow probe columns widen here
    if isinstance(table, LPTable):
        return lp_match_stats(table, keys)
    if isinstance(table, CSRTable):
        return csr_match_stats(table, keys)
    raise TypeError(f"unknown table type {type(table)}")


class BulkResult(NamedTuple):
    count: jax.Array  # int64 scalar: total output rows of the N-way join
    payload_checksums: jax.Array  # int64[n_levels]: Σ over output rows of
    #                               each level's matched-payload column


@jax.jit
def _bulk_count_jit(tables: tuple, probe_cols: jax.Array) -> BulkResult:
    """Tables are pytrees (register_dataclass): array leaves trace, the
    max_run/max_len bounds ride along as static aux data."""
    from ccve.ops.sort_merge import SortedTable, sorted_match_totals

    n_levels = len(tables)
    if n_levels == 1 and isinstance(tables[0], SortedTable):
        # single-level fast path: totals are order-invariant, skip unsort
        count, chk = sorted_match_totals(tables[0], probe_cols[0])
        return BulkResult(count=count, payload_checksums=chk[None])
    stats = [match_stats(tables[l], probe_cols[l]) for l in range(n_levels)]
    mults = [s.mult.astype(jnp.int64) for s in stats]
    prod = mults[0]
    for m in mults[1:]:
        prod = prod * m
    count = jnp.sum(prod)
    chks = []
    for l in range(n_levels):
        # Π_{k≠l} mult — zero contribution where mult_l == 0 (row emits
        # nothing), so the guarded division is exact.
        others = jnp.where(mults[l] > 0, prod // mults[l], 0)
        chks.append(jnp.sum(stats[l].psum * others))
    return BulkResult(count=count, payload_checksums=jnp.stack(chks))


def bulk_count(
    tables: Sequence[LPTable | CSRTable],
    probe_rows: np.ndarray | jax.Array,
    tile_rows: int | None = None,
) -> BulkResult:
    """Count (and payload-checksum) the N-way join of `probe_rows`
    (int64[n, n_joins]) against `tables` without materializing output.
    Optionally processes in `tile_rows`-row tiles to bound memory."""
    tables = tuple(tables)
    # keep an i32 probe table narrow: the sort-merge totals path packs an
    # i32 column into its i32 sort operand without widening it
    probe = jnp.asarray(probe_rows)
    if probe.dtype != jnp.int32:
        probe = probe.astype(jnp.int64)
    probe = probe.T  # [n_joins, n]
    n = probe.shape[1]
    if tile_rows is None or tile_rows >= n:
        return _bulk_count_jit(tables, probe)
    count = jnp.asarray(0, jnp.int64)
    chk = jnp.zeros(len(tables), jnp.int64)
    for s in range(0, n, tile_rows):
        r = _bulk_count_jit(tables, probe[:, s : s + tile_rows])
        count = count + r.count
        chk = chk + r.payload_checksums
    return BulkResult(count=count, payload_checksums=chk)


# ---------------------------------------------------------------------------
# Materializing bulk join (static-width expansion)
# ---------------------------------------------------------------------------


def _expand(table, keys):
    if isinstance(table, LPTable):
        return lp_expand_grid(table, keys)
    return csr_expand_grid(table, keys)


def _expand_sorted(table, keys):
    """Per-level expansion for SortedTable via the gather-free
    `sorted_expand` (ops/sort_merge.py): returns (row_of, keys, pays)
    dense arrays of the n_keep matches. Capacity is the static worst
    case n * max_mult — the same bound the reference's chunk_factor
    gives its chains (chaining_ht.cpp:15-26)."""
    from ccve.ops.sort_merge import sorted_expand

    cap = int(keys.shape[0]) * max(int(table.max_mult), 1)
    rows, ck, cp, total = sorted_expand(table, keys, cap)
    return rows, ck, cp, int(total)


def bulk_materialize(
    tables: Sequence[LPTable | CSRTable],
    probe_rows: np.ndarray,
    payload_mode,
) -> np.ndarray:
    """Materialize the full N-way join output (int64[m, 3*n_joins]) by
    per-level candidate-grid expansion. Output width/order match
    exec/oracle.oracle_pipeline. Memory grows by Π max-chain-width, so this
    is for moderate multiplicities; use the pipelined executor otherwise."""
    from ccve.config import PayloadMode

    probe_rows = np.asarray(probe_rows, dtype=np.int64)
    n, n_joins = probe_rows.shape
    assert n_joins == len(tables)

    # survivors: (row index into probe_rows, appended cols so far)
    src = jnp.arange(n, dtype=jnp.int64)
    appended = jnp.zeros((0, n), jnp.int64)
    probe_cols = jnp.asarray(probe_rows.T)

    from ccve.ops.sort_merge import SortedTable

    for l, table in enumerate(tables):
        keys = jnp.take(probe_cols[l], src)
        if isinstance(table, SortedTable):
            # gather-free path: segmented-propagation expansion
            rows_d, ck_d, cp_d, n_keep = _expand_sorted(table, keys)
            row_of = rows_d[:n_keep]
            ck = ck_d[:n_keep]
            cp = cp_d[:n_keep]
        else:
            grid = _expand(table, keys)  # match [m, w]
            m, w = grid.match.shape
            flat_match = grid.match.reshape(-1)
            # Dense compaction of surviving (row, candidate) pairs.
            order = jnp.argsort(~flat_match, stable=True)  # matches first
            n_keep = int(jnp.sum(flat_match))
            keep = order[:n_keep]
            row_of = keep // w
            ck = grid.keys.reshape(-1)[keep]
            cp = grid.payloads.reshape(-1)[keep]
        src = jnp.take(src, row_of)
        appended = jnp.take(appended, row_of, axis=1)
        if payload_mode is PayloadMode.REFERENCE:
            new_cols = jnp.stack([jnp.zeros_like(ck), ck])
        else:
            new_cols = jnp.stack([ck, cp])
        appended = jnp.concatenate([appended, new_cols], axis=0)

    lhs = probe_rows[np.asarray(src)]
    return np.concatenate([lhs, np.asarray(appended).T], axis=1)
