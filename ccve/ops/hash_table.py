"""Device hash tables for the equi-join — linear-probing and chaining (CSR).

A re-design of the reference's two hash tables:

 - `LPTable` ⇔ `LPHashTable` (linear_probing_ht.h:47-71): open addressing in
   a flat power-of-two slot array, slots = next_pow2(4 * n_build) (load
   factor ≤ 25%, linear_probing_ht.cpp:5-6), empty = -1. Unlike the
   reference — which stores only keys and discards payloads
   (linear_probing_ht.cpp:35) — the table carries a payload array too, so
   both PayloadMode.REFERENCE (key-echo parity) and PayloadMode.FULL work.

 - `CSRTable` ⇔ `HashTable` (chaining_ht.h:79-101): the reference's
   `std::list<Key>` chains (one heap-allocated linked list per bucket,
   chaining_ht.cpp:7-8, probed through raw node pointers,
   chaining_ht.cpp:239-292) become a CSR index: `offsets[b] .. offsets[b+1]`
   delimit bucket b's entries in flat `entry_keys`/`entry_payloads` arrays.
   Pointer chasing becomes integer index arithmetic + vector gathers.
   Buckets = next_pow2(2 * n_build) (chaining_ht.cpp:5-6).

Builds are inherently sequential (insertion order) and run on the host —
in the native C++ runtime when available (ccve_native.cpp), else NumPy.
The reference also builds on the host thread outside the timed region
(main.cpp:62-68). A device-side parallel CSR build (hash → radix sort →
histogram) lives in `build_csr_device` for the distributed tier, where
shipping build rows through the host would cross HBM↔host for no reason.

Probing is decomposed exactly like the reference — probe (hash + prefilter),
match, gather, advance (chaining_ht.cpp:38-173) — but each phase is a
fixed-shape batched array op: the per-row `std::list` iterator becomes an
int32 cursor array, `compressstoreu` compaction becomes mask → prefix-sum →
scatter (`chunk.compress_indices`), and the `while (ss.HasNext())` drain
becomes either a bounded candidate-grid expansion (`*_expand_grid`, for the
bulk operator-at-a-time executor) or a `ScanState` stepped by `scan_next`
(for the chunk-at-a-time pipelined executor).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ccve import native
from ccve.core.chunk import gather_clip, scatter_drop
from ccve.ops.hashing import murmurhash64, murmurhash64_np

EMPTY = -1  # empty-slot sentinel (linear_probing_ht.cpp:7)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Table pytrees
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["slot_keys", "slot_payloads"],
    meta_fields=["max_run"],
)
@dataclasses.dataclass(frozen=True)
class LPTable:
    """Open-addressing table. `max_run` (static) bounds probe-chain length:
    the longest circular run of occupied slots, measured at build time."""

    slot_keys: jax.Array  # int64[n_slots]
    slot_payloads: jax.Array  # int64[n_slots]
    max_run: int

    @property
    def n_slots(self) -> int:
        return self.slot_keys.shape[0]

    @property
    def mask(self):
        return jnp.uint64(self.n_slots - 1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["offsets", "entry_keys", "entry_payloads"],
    meta_fields=["max_len"],
)
@dataclasses.dataclass(frozen=True)
class CSRTable:
    """Chaining table in CSR layout. `max_len` (static) is the longest
    bucket, bounding the match drain."""

    offsets: jax.Array  # int32[n_buckets + 1]
    entry_keys: jax.Array  # int64[n_entries]
    entry_payloads: jax.Array  # int64[n_entries]
    max_len: int

    @property
    def n_buckets(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def mask(self):
        return jnp.uint64(self.n_buckets - 1)


# ---------------------------------------------------------------------------
# Host builds (native C++ fast path, NumPy fallback)
# ---------------------------------------------------------------------------


def _default_payloads(keys: np.ndarray) -> np.ndarray:
    # payload = insertion index + 10_000_000 (chaining_ht.cpp:21)
    return np.arange(keys.shape[0], dtype=np.int64) + 10_000_000


def build_lp(keys, payloads=None, device=None) -> LPTable:
    """Sequential first-empty-slot insertion (linear_probing_ht.cpp:27-36)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    payloads = (
        _default_payloads(keys)
        if payloads is None
        else np.ascontiguousarray(payloads, dtype=np.int64)
    )
    n_slots = next_pow2(4 * n)  # load factor <= 25% (linear_probing_ht.cpp:5-6)
    slot_keys = np.empty(n_slots, dtype=np.int64)
    slot_payloads = np.empty(n_slots, dtype=np.int64)

    lib = native.load()
    if lib is not None:
        import ctypes

        p64 = ctypes.POINTER(ctypes.c_int64)
        max_run = lib.ccve_build_lp(
            keys.ctypes.data_as(p64),
            payloads.ctypes.data_as(p64),
            n,
            n_slots,
            slot_keys.ctypes.data_as(p64),
            slot_payloads.ctypes.data_as(p64),
        )
    else:
        slot_keys.fill(EMPTY)
        slot_payloads.fill(EMPTY)
        mask = n_slots - 1
        hashes = murmurhash64_np(keys) & np.uint64(mask)
        for i in range(n):
            s = int(hashes[i])
            while slot_keys[s] != EMPTY:
                s = (s + 1) & mask
            slot_keys[s] = keys[i]
            slot_payloads[s] = payloads[i]
        occ = slot_keys != EMPTY
        max_run = _longest_circular_run(occ)

    return LPTable(
        slot_keys=jax.device_put(slot_keys, device),
        slot_payloads=jax.device_put(slot_payloads, device),
        max_run=int(max_run),
    )


def _longest_circular_run(occ: np.ndarray) -> int:
    if occ.all():
        return occ.shape[0]
    # rotate so position 0 is empty, then longest run is a plain max
    first_empty = int(np.argmin(occ))
    r = np.roll(occ, -first_empty).astype(np.int64)
    # lengths of runs of ones
    padded = np.concatenate([[0], r, [0]])
    d = np.diff(padded)
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return int((ends - starts).max(initial=0))


def build_csr(keys, payloads=None, device=None) -> CSRTable:
    """Chaining build (chaining_ht.cpp:4-36) in CSR layout, insertion order
    preserved within each bucket (std::list push_back semantics)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    payloads = (
        _default_payloads(keys)
        if payloads is None
        else np.ascontiguousarray(payloads, dtype=np.int64)
    )
    n_buckets = next_pow2(2 * n)  # chaining_ht.cpp:5-6
    offsets = np.empty(n_buckets + 1, dtype=np.int64)
    entry_keys = np.empty(n, dtype=np.int64)
    entry_payloads = np.empty(n, dtype=np.int64)

    lib = native.load()
    if lib is not None:
        import ctypes

        p64 = ctypes.POINTER(ctypes.c_int64)
        max_len = lib.ccve_build_chaining_csr(
            keys.ctypes.data_as(p64),
            payloads.ctypes.data_as(p64),
            n,
            n_buckets,
            offsets.ctypes.data_as(p64),
            entry_keys.ctypes.data_as(p64),
            entry_payloads.ctypes.data_as(p64),
        )
    else:
        bucket = (murmurhash64_np(keys) & np.uint64(n_buckets - 1)).astype(
            np.int64
        )
        counts = np.bincount(bucket, minlength=n_buckets)
        offsets[0] = 0
        np.cumsum(counts, out=offsets[1:])
        order = np.argsort(bucket, kind="stable")
        entry_keys[:] = keys[order]
        entry_payloads[:] = payloads[order]
        max_len = int(counts.max(initial=0))

    return CSRTable(
        offsets=jax.device_put(offsets.astype(np.int32), device),
        entry_keys=jax.device_put(entry_keys, device),
        entry_payloads=jax.device_put(entry_payloads, device),
        max_len=int(max_len),
    )


def build_csr_device(keys: jax.Array, payloads: jax.Array, n_buckets: int, max_len: int) -> CSRTable:
    """Device-side parallel CSR build: hash → stable sort by bucket →
    histogram → offsets. Used by the distributed tier where the build shard
    already lives on-device. `max_len` must be a static bound (callers use
    per-shard psum'd histograms or a workload-known bound)."""
    bucket = (murmurhash64(keys) & jnp.uint64(n_buckets - 1)).astype(jnp.int32)
    order = jnp.argsort(bucket, stable=True)
    counts = jnp.zeros(n_buckets, jnp.int32).at[bucket].add(1)
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )
    return CSRTable(
        offsets=offsets,
        entry_keys=jnp.take(keys, order),
        entry_payloads=jnp.take(payloads, order),
        max_len=int(max_len),
    )


# ---------------------------------------------------------------------------
# Probe: candidate-grid expansion (bulk executor)
# ---------------------------------------------------------------------------


class MatchGrid(NamedTuple):
    """Bounded match expansion for a batch of probe keys: candidate j of row
    i (j < width, the static chain bound). `match[i, j]` marks real matches;
    `keys`/`payloads` are the candidate build entries (garbage where
    ~match)."""

    match: jax.Array  # bool[n, width]
    keys: jax.Array  # int64[n, width]
    payloads: jax.Array  # int64[n, width]


def lp_expand_grid(table: LPTable, probe_keys: jax.Array) -> MatchGrid:
    """All LP matches per key: scan slots h, h+1, ... until the first empty
    slot (the `while HasNext` drain of LPScanStructure::Next,
    linear_probing_ht.cpp:60-115), bounded by the static max_run."""
    width = max(table.max_run, 1)
    h = (murmurhash64(probe_keys) & table.mask).astype(jnp.int64)
    steps = jnp.arange(width, dtype=jnp.int64)
    slots = (h[:, None] + steps[None, :]) & jnp.int64(table.n_slots - 1)
    cand = jnp.take(table.slot_keys, slots, axis=0)  # [n, width]
    live = jnp.cumprod(cand != EMPTY, axis=1).astype(bool)
    match = live & (cand == probe_keys[:, None])
    payloads = jnp.take(table.slot_payloads, slots, axis=0)
    return MatchGrid(match=match, keys=cand, payloads=payloads)


def csr_expand_grid(table: CSRTable, probe_keys: jax.Array) -> MatchGrid:
    """All chaining matches per key: bucket entries start..start+len
    (ScanInnerJoin drain, chaining_ht.cpp:82-107), bounded by max_len."""
    width = max(table.max_len, 1)
    b = (murmurhash64(probe_keys) & table.mask).astype(jnp.int32)
    start = jnp.take(table.offsets, b)
    length = jnp.take(table.offsets, b + 1) - start
    steps = jnp.arange(width, dtype=jnp.int32)
    idx = start[:, None] + steps[None, :]
    live = steps[None, :] < length[:, None]
    safe_idx = jnp.where(live, idx, 0).astype(jnp.int32)
    cand = jnp.take(table.entry_keys, safe_idx, axis=0)
    match = live & (cand == probe_keys[:, None])
    payloads = jnp.take(table.entry_payloads, safe_idx, axis=0)
    return MatchGrid(match=match, keys=cand, payloads=payloads)


# ---------------------------------------------------------------------------
# Probe: staged scan (chunk-at-a-time pipelined executor)
# ---------------------------------------------------------------------------


class ScanState(NamedTuple):
    """Per-row probe cursor — the device ScanStructure. The reference carries a
    `std::list` iterator per row (chaining_ht.h:29-42) or a slot id
    (linear_probing_ht.h:19-31) plus a compacted `bucket_sel_vector_`; here
    the cursor/end are dense int32 arrays over storage positions and the
    compacted live set is (sel, count) like everywhere else.

    For LP tables `cursor` is the slot id and `end` is unused (-1 ⇒ advance
    stops at the first empty slot); for CSR it is the entry index with `end`
    the bucket's end offset.
    """

    cursor: jax.Array  # int64[block] current slot / entry index
    end: jax.Array  # int64[block] CSR end offset (LP: unused)
    sel: jax.Array  # int32[block] live-row compaction over input positions
    count: jax.Array  # int32 scalar: number of live rows

    def has_next(self) -> jax.Array:
        return self.count > 0


def _compress(mask: jax.Array):
    from ccve.core.chunk import compress_indices

    return compress_indices(mask)


def lp_probe(table: LPTable, keys: jax.Array, sel: jax.Array, count) -> ScanState:
    """LPHashTable::Probe (linear_probing_ht.cpp:39-66): hash each selected
    key to a slot, prefilter rows whose initial slot is empty."""
    block = keys.shape[0]
    gathered = gather_clip(keys, sel.astype(jnp.int32))
    slots = (murmurhash64(gathered) & table.mask).astype(jnp.int64)
    # scatter slot ids back to input positions (state is indexed by input row)
    cursor = scatter_drop(jnp.zeros(block, jnp.int64), sel, slots)
    idx = jnp.arange(block, dtype=jnp.int32)
    in_range = idx < count
    occupied = gather_clip(table.slot_keys, gather_clip(cursor, sel)) != EMPTY
    live = in_range & occupied
    new_sel_pos, new_count = _compress(live)
    # live positions are positions into `sel`'s order; map back to input rows
    new_sel = gather_clip(sel, new_sel_pos)
    return ScanState(
        cursor=cursor,
        end=jnp.full(block, -1, jnp.int64),
        sel=new_sel.astype(jnp.int32),
        count=new_count,
    )


def csr_probe(table: CSRTable, keys: jax.Array, sel: jax.Array, count) -> ScanState:
    """HashTable::Probe (chaining_ht.cpp:38-58): hash to bucket, snapshot
    begin/end, prefilter empty buckets."""
    block = keys.shape[0]
    gathered = gather_clip(keys, sel.astype(jnp.int32))
    b = (murmurhash64(gathered) & table.mask).astype(jnp.int32)
    # one gather for both offset reads, one scatter for both state rows
    be = gather_clip(table.offsets[None, :], jnp.concatenate([b, b + 1]))
    begin = be[0, :block].astype(jnp.int64)
    endv = be[0, block:].astype(jnp.int64)
    ce = scatter_drop(
        jnp.zeros((2, block), jnp.int64), sel, jnp.stack([begin, endv])
    )
    cursor, end = ce[0], ce[1]
    idx = jnp.arange(block, dtype=jnp.int32)
    live = (idx < count) & (endv > begin)
    new_sel_pos, new_count = _compress(live)
    new_sel = gather_clip(sel, new_sel_pos)
    return ScanState(cursor=cursor, end=end, sel=new_sel.astype(jnp.int32), count=new_count)


class NextResult(NamedTuple):
    result_vector: jax.Array  # int32[block] matching input rows (compacted)
    result_count: jax.Array  # int32 scalar
    matched_keys: jax.Array  # int64[block] build keys, in result order
    matched_payloads: jax.Array  # int64[block] build payloads, in result order
    state: ScanState  # advanced cursor state


def _scan_live_mask(state: ScanState, block: int) -> jax.Array:
    """bool[block]: True exactly at the live input rows — scatter True
    through the first `count` entries of sel (stale entries routed to the
    dropped row `block`)."""
    idx = jnp.arange(block, dtype=jnp.int32)
    return scatter_drop(
        jnp.zeros(block, jnp.int32),
        jnp.where(idx < state.count, state.sel, block),
        jnp.ones(block, jnp.int32),
    ) > 0


def scan_match(table: LPTable | CSRTable, keys: jax.Array, state: ScanState):
    """Match phase alone — ScanInnerJoin (CycleProfiler slot 1,
    chaining_ht.cpp:82-107 / linear_probing_ht.cpp:69-82): compare each
    live row's current entry, compress matching rows. Used by the
    4-phase micro-bench attribution (bench/micro.run_phased_variant);
    the production executor uses the fused `scan_next`."""
    block = keys.shape[0]
    live = _scan_live_mask(state, block)
    if isinstance(table, LPTable):
        cand = gather_clip(table.slot_keys, state.cursor)
        has_entry = cand != EMPTY
    else:
        n_entries = max(table.entry_keys.shape[0], 1)
        safe = jnp.clip(state.cursor, 0, n_entries - 1).astype(jnp.int32)
        cand = gather_clip(table.entry_keys, safe)
        has_entry = state.cursor < state.end
    return _compress(live & has_entry & (cand == keys))


def scan_gather(
    table: LPTable | CSRTable, state: ScanState, result_vector: jax.Array
):
    """Gather phase alone — GatherResult (CycleProfiler slot 2,
    chaining_ht.cpp:126-136): read the matched rows' current entries."""
    cur = gather_clip(state.cursor, result_vector.astype(jnp.int32))
    if isinstance(table, LPTable):
        kp = gather_clip(
            jnp.stack([table.slot_keys, table.slot_payloads]), cur
        )
    else:
        n_entries = max(table.entry_keys.shape[0], 1)
        safe = jnp.clip(cur, 0, n_entries - 1).astype(jnp.int32)
        kp = gather_clip(
            jnp.stack([table.entry_keys, table.entry_payloads]), safe
        )
    return kp[0], kp[1]


def scan_advance(table: LPTable | CSRTable, state: ScanState) -> ScanState:
    """Advance phase alone — AdvancePointers (CycleProfiler slot 3,
    chaining_ht.cpp:109-124): step cursors, drop exhausted rows."""
    block = state.sel.shape[0]
    live = _scan_live_mask(state, block)
    if isinstance(table, LPTable):
        nxt = (state.cursor + 1) & jnp.int64(table.n_slots - 1)
        still = live & (gather_clip(table.slot_keys, nxt) != EMPTY)
    else:
        nxt = state.cursor + 1
        still = live & (nxt < state.end)
    new_sel, new_count = _compress(still)
    return ScanState(cursor=nxt, end=state.end, sel=new_sel, count=new_count)


def scan_next(
    table: LPTable | CSRTable,
    keys: jax.Array,
    state: ScanState,
    want_matches: bool = True,
) -> NextResult:
    """One Next step — match + gather + advance, fused like `InOneNext`
    (chaining_ht.cpp:138-173, linear_probing_ht.cpp:117-153): each live row
    tests its current cursor entry, emits ≤ 1 match, and advances.

    Unlike the reference's scalar `Next`, there is no inner retry loop on
    zero matches (ScanInnerJoin's `while(true)`, chaining_ht.cpp:82-107) —
    a zero-match step simply emits count 0, which the executor skips; the
    emitted multiset is identical.
    """
    block = keys.shape[0]
    is_lp = isinstance(table, LPTable)
    # Mark exactly the live input rows: scatter True through the first
    # `count` entries of sel; stale sel entries beyond count are routed to
    # the dropped row `block` so they can't clobber live rows.
    idx = jnp.arange(block, dtype=jnp.int32)
    live_mask = scatter_drop(
        jnp.zeros(block, jnp.int32),
        jnp.where(idx < state.count, state.sel, block),
        jnp.ones(block, jnp.int32),
    ) > 0

    if is_lp:
        kp = gather_clip(
            jnp.stack([table.slot_keys, table.slot_payloads]), state.cursor
        )
        cand_keys, cand_payloads = kp[0], kp[1]
        has_entry = cand_keys != EMPTY
    else:
        n_entries = max(table.entry_keys.shape[0], 1)
        safe = jnp.clip(state.cursor, 0, n_entries - 1).astype(jnp.int32)
        kp = gather_clip(
            jnp.stack([table.entry_keys, table.entry_payloads]), safe
        )
        cand_keys, cand_payloads = kp[0], kp[1]
        has_entry = state.cursor < state.end

    match = live_mask & has_entry & (cand_keys == keys)
    result_vector, result_count = _compress(match)
    if want_matches:
        mk = gather_clip(
            jnp.stack([cand_keys, cand_payloads]), result_vector
        )
        matched_keys, matched_payloads = mk[0], mk[1]
    else:
        # count-only executors never read the gathered values — skip
        # the gather
        matched_keys = matched_payloads = jnp.zeros(block, jnp.int64)

    # Advance (AdvancePointers, chaining_ht.cpp:109-124 /
    # linear_probing_ht.cpp:96-112): move cursor, drop exhausted rows.
    if is_lp:
        nxt = (state.cursor + 1) & jnp.int64(table.n_slots - 1)
        still = live_mask & (gather_clip(table.slot_keys, nxt) != EMPTY)
    else:
        nxt = state.cursor + 1
        still = live_mask & (nxt < state.end)
    new_sel, new_count = _compress(still)
    new_state = ScanState(
        cursor=nxt, end=state.end, sel=new_sel, count=new_count
    )
    return NextResult(
        result_vector=result_vector,
        result_count=result_count,
        matched_keys=matched_keys,
        matched_payloads=matched_payloads,
        state=new_state,
    )
