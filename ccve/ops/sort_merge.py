"""Sort-merge equi-join stats — the gather-free probe path.

The reference's probe is random access: hash each key, chase a bucket
chain with per-key loads (chaining_ht.cpp:38-173). The same join falls
out of sorts and prefix scans alone, with no random access at all:

 1. concat build keys and probe keys, tagged build / probe, and sort by
    (key, tag): within a key run, all build entries precede all probe
    entries;
 2. inclusive prefix count of build entries `c` and prefix payload sum
    `pc`; per-run bases recovered with a cummax over run-start markers
    (run-start prefix values are monotone, so a max-scan IS "latest run
    start" propagation — no gather);
 3. per probe element: mult = c - base_c, psum = pc - base_p;
 4. restore original probe order with a second sort keyed by carried row
    id.

Order-invariant outputs (totals, per-build-row counts) skip step 4 and
sort ONE operand: the key packed with a build/probe tag bit
(`_count_side_bc`). On the GPU, XLA hands single-operand and key + value
sorts to a radix sort. Which engine is faster for a workload — this one
or exec/bulk's hash probes — is a per-workload measurement, not a
property of the design.

Output (mult, psum per probe key) is exactly exec/bulk.match_stats's
contract, verified against it in tests. Requires non-negative payloads
for the cummax trick (engine payloads are row_index + 10^7,
chaining_ht.cpp:21); `sorted_match_stats(..., allow_negative=True)`
switches base-recovery to an associative segmented scan.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ccve.exec.bulk import MatchStats

_I64 = np.iinfo(np.int64)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["keys", "payloads"],
    meta_fields=["pack32", "span62", "max_mult"],
)
@dataclasses.dataclass(frozen=True)
class SortedTable:
    """A build table for the sort-merge path: rows sorted by key.

    Static aux data, computed at build time on the host (the probe side
    is range-checked on device):
      - `pack32`: (kmin, key_bits) when the tagged key (key' << 1 | tag)
        fits a non-negative i32 — key spans up to 2^30 — else None;
      - `span62`: the key span is below 2^62, so the tagged key fits an
        int64 (the wide-key count-side stream);
      - `max_mult`: the largest key multiplicity (the reference's
        chunk_factor bound, chaining_ht.cpp:15-26) — the static fan-out
        of `sorted_expand`."""

    keys: jax.Array  # int64[m], ascending
    payloads: jax.Array  # int64[m], aligned with keys
    pack32: tuple | None = None
    span62: bool = False
    max_mult: int = 1


def _pack32_meta(keys: np.ndarray):
    """(kmin, key_bits) when (key' << 1 | tag) fits a non-negative i32 —
    key spans up to 2^30. Independent of payload range and sign: the
    count-side path never sorts payloads."""
    if keys.size == 0:
        return None
    kmin, kmax = int(keys.min()), int(keys.max())
    key_bits = max(int(kmax - kmin + 2).bit_length(), 1)
    if key_bits > 30:
        return None
    return (kmin, key_bits)


def build_sorted(keys, payloads=None, device=None) -> SortedTable:
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    else:
        payloads = np.ascontiguousarray(payloads, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    # key_lo = kmin - 1 and key_hi = kmax + 1 must not wrap
    span62 = bool(
        keys.size > 0
        and int(keys.min()) > _I64.min
        and int(keys.max()) < _I64.max
        and int(keys.max()) - int(keys.min()) + 2 < 2**62
    )
    if keys.size:
        _, counts = np.unique(keys, return_counts=True)
        max_mult = int(counts.max())
    else:
        max_mult = 1
    return SortedTable(
        keys=jax.device_put(jnp.asarray(keys[order]), device),
        payloads=jax.device_put(jnp.asarray(payloads[order]), device),
        pack32=_pack32_meta(keys),
        span62=span62,
        max_mult=max_mult,
    )


def _segment_base(run_start: jax.Array, prefix: jax.Array, monotone: bool):
    """Value of `prefix` at each position's latest run start."""
    if monotone:
        neg = jnp.full_like(prefix, jnp.iinfo(prefix.dtype).min)
        return jax.lax.cummax(jnp.where(run_start, prefix, neg))
    # general segmented copy-last scan
    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va)

    _, base = jax.lax.associative_scan(
        combine, (run_start, jnp.where(run_start, prefix, 0))
    )
    return base


def _merged_stats(table: SortedTable, probe_keys: jax.Array, allow_negative):
    """Shared core: one stable sort of build∪probe plus prefix scans.
    Returns (mult, psum, srow, is_build) in merged-sorted order, with
    zeros at build positions."""
    m = table.keys.shape[0]
    n = probe_keys.shape[0]

    # Builds precede probes at equal keys because they come first in the
    # concat and the sort is stable — no tag operand needed.
    keys = jnp.concatenate([table.keys, probe_keys.astype(jnp.int64)])
    pay = jnp.concatenate([table.payloads, jnp.zeros(n, jnp.int64)])
    row = jnp.concatenate(
        [jnp.full(m, -1, jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )

    sk, spay, srow = jax.lax.sort([keys, pay, row], num_keys=1, is_stable=True)

    is_build = srow < 0
    ib = is_build.astype(jnp.int32)
    c = jnp.cumsum(ib)  # inclusive build count
    bpay = jnp.where(is_build, spay, 0)
    pc = jnp.cumsum(bpay)  # inclusive build payload sum

    run_start = jnp.concatenate(
        [jnp.ones(1, bool), sk[1:] != sk[:-1]]
    )
    base_c = _segment_base(run_start, c - ib, monotone=True)
    base_p = _segment_base(run_start, pc - bpay, monotone=not allow_negative)

    mult_sorted = jnp.where(is_build, 0, c - base_c).astype(jnp.int32)
    psum_sorted = jnp.where(is_build, 0, pc - base_p)
    return mult_sorted, psum_sorted, srow, is_build


def sorted_match_stats(
    table: SortedTable,
    probe_keys: jax.Array,
    allow_negative: bool = False,
) -> MatchStats:
    """Per-probe-key (match count, matched-payload sum) via sort-merge,
    in original probe-row order."""
    m = table.keys.shape[0]
    mult_sorted, psum_sorted, srow, is_build = _merged_stats(
        table, probe_keys, allow_negative
    )
    # Restore probe order: one more sort keyed by row id, with mult
    # packed into the key's low bits — build entries (row −1) sort to
    # the front, probe rows land at positions m..m+n-1 in original order.
    packed = (srow.astype(jnp.int64) << jnp.int64(32)) | mult_sorted.astype(
        jnp.int64
    )
    packed_s, psum = jax.lax.sort([packed, psum_sorted], num_keys=1)
    mult = (packed_s[m:] & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
    return MatchStats(mult=mult, psum=psum[m:])


def _tagged_streams(table: SortedTable, probe_keys: jax.Array):
    """Tag-packed (probe, build) streams for `_count_side_bc`: probes
    key' << 1 (tag 0), builds key' << 1 | 1 (tag 1), key' = key - key_lo
    with key_lo = kmin - 1. Probes clamp into [key_lo, key_lo + span),
    whose ends lie outside every build key — clamped keys match nothing.

    i32 streams when the table has `pack32` (a narrow probe column packs
    without widening), int64 streams when `span62`; None when the key
    span is too wide to pack (the caller takes the two-key sort)."""
    if table.pack32 is not None:
        kmin, key_bits = table.pack32
        key_lo = kmin - 1
        key_top = key_lo + (1 << key_bits) - 1
        b = (((table.keys - key_lo) << 1) | 1).astype(jnp.int32)
        if (
            probe_keys.dtype == jnp.int32
            and -(2**31) <= key_lo
            and key_top < 2**31
        ):
            # clamp BEFORE the subtract: both bounds fit i32, so neither
            # the clip nor the shifted difference can wrap
            pkc = jnp.clip(probe_keys, jnp.int32(key_lo), jnp.int32(key_top))
            p = (pkc - jnp.int32(key_lo)) << 1
        else:
            pkc = jnp.clip(probe_keys.astype(jnp.int64), key_lo, key_top)
            p = ((pkc - key_lo) << 1).astype(jnp.int32)
        return p, b
    if table.span62:
        key_lo = table.keys[0] - 1
        key_hi = table.keys[-1] + 1
        b = ((table.keys - key_lo) << 1) | 1
        pkc = jnp.clip(probe_keys.astype(jnp.int64), key_lo, key_hi)
        return (pkc - key_lo) << 1, b
    return None


def _count_side_bc(p: jax.Array, b: jax.Array, m: int) -> jax.Array:
    """Dense per-build-row probe counts bc i32[m] from tag-packed
    streams (`_tagged_streams`; `b` in table order, ascending) — the
    count-side engine shared by `sorted_build_counts` and
    `sorted_match_totals`.

    One single-operand sort of p ∪ b puts each run's probes (tag 0)
    before its builds (tag 1), so at a build the probe prefix count
    minus its run-start value is the number of probes with its key. The
    j-th build of the sorted stream is table row j (equal packed values
    are interchangeable), so one scatter lays the counts out densely."""
    s = jax.lax.sort(jnp.concatenate([p, b]))
    is_build = (s & 1) == 1
    ip = (~is_build).astype(jnp.int32)
    cp = jnp.cumsum(ip)
    kk = s >> 1
    run_start = jnp.concatenate([jnp.ones(1, bool), kk[1:] != kk[:-1]])
    base = _segment_base(run_start, cp - ip, monotone=True)
    bidx = jnp.cumsum(is_build.astype(jnp.int32)) - 1
    return (
        jnp.zeros(m, jnp.int32)
        .at[jnp.where(is_build, bidx, m)]
        .set(cp - base, mode="drop")
    )


def rank_table(table: SortedTable) -> SortedTable:
    """Twin of `table` whose payload is the SORTED ROW INDEX at each key
    run's FIRST row and 0 elsewhere — the input to `sorted_match_ranks`.
    A probe key matches exactly one full key run, so the twin's matched-
    payload sum IS the run's start row: no division, no algebra, just
    `psum` (start = 0 rows are disambiguated by mult > 0). Shares the
    key plane with the original table (no extra device memory for
    keys)."""
    m = int(table.keys.shape[0])
    idx = jnp.arange(m, dtype=jnp.int64)
    if m > 0:
        run_start = jnp.concatenate(
            [jnp.ones(1, bool), table.keys[1:] != table.keys[:-1]]
        )
        pay = jnp.where(run_start, idx, 0)
    else:
        pay = idx
    return dataclasses.replace(table, payloads=pay)


def sorted_match_ranks(rtable: SortedTable, probe_keys: jax.Array):
    """Per-probe-key (mult, start) in original probe order: mult = match
    count, start = first matching row of the SORTED table (garbage where
    mult == 0). `rtable` must be a `rank_table(...)` twin (payload ==
    sorted row index at run starts, 0 elsewhere): a probe's matched rows
    are exactly one full key run, so the matched-payload sum IS the
    run-start row — the stats path is reused verbatim, with no per-chunk
    table staging and no table-size bound."""
    st = sorted_match_stats(rtable, probe_keys)
    return st.mult, st.psum.astype(jnp.int32)


def sorted_build_counts(table: SortedTable, probe_keys: jax.Array):
    """Per-build-ROW probe multiplicities bc int32[m]: bc[j] = number of
    probe keys equal to table.keys[j] (table order = sorted order). The
    count-side primitive behind `sorted_match_totals`, exposed for
    aggregate pushdown (ops/aggregate.join_dense_aggregate): when a
    group-by key equals the join key, per-group stats are algebra over
    bc and the build payloads — no per-probe materialization.

    Tables whose key span packs (`_tagged_streams`) take the
    single-operand count-side sort; the rest a two-key sort."""
    m = table.keys.shape[0]
    streams = _tagged_streams(table, probe_keys)
    if streams is not None:
        return _count_side_bc(*streams, m)
    n = probe_keys.shape[0]
    keys = jnp.concatenate([table.keys, probe_keys.astype(jnp.int64)])
    tags = jnp.concatenate(
        [jnp.ones(m, jnp.int32), jnp.zeros(n, jnp.int32)]
    )
    sk, st = jax.lax.sort([keys, tags], num_keys=2)  # probes before builds
    ip = (st == 0).astype(jnp.int32)
    cp = jnp.cumsum(ip)
    run_start = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
    base = _segment_base(run_start, cp - ip, monotone=True)
    bc = jnp.where(st == 1, cp - base, 0)
    # j-th build of the stream is table row j
    bidx = jnp.cumsum(st) - 1
    return (
        jnp.zeros(m, jnp.int32)
        .at[jnp.where(st == 1, bidx, m)]
        .set(bc.astype(jnp.int32), mode="drop")
    )


def sorted_match_totals(table: SortedTable, probe_keys: jax.Array):
    """(total match count, total matched-payload sum) for a single-level
    join — order-invariant, so no per-probe output and no unsort: with
    bc the per-build-row probe counts (`sorted_build_counts`),

        count = Σ bc,   psum = dot(bc, table.payloads)

    — no gather and no payload scans; exact for negative payloads too
    (the dot carries the sign)."""
    bc = sorted_build_counts(table, probe_keys).astype(jnp.int64)
    return jnp.sum(bc), jnp.sum(bc * table.payloads)


# Probe rows per `sorted_expand_tiled` program. A tile of n rows holds
# the (m + n)-entry sort operands, max_mult candidate planes of m + n
# entries and n * max_mult output triples, about 70 * max_mult bytes per
# row in all: 2^24 rows at max_mult <= 4 stays under ~5 GB, a small
# share of one card's memory, while the 16M-row config-1 stream still
# runs as ONE program.
EXPAND_TILE_ROWS = 1 << 24


def sorted_expand_tiled(
    table: SortedTable,
    probe_keys,
    tile_rows: int | None = None,
):
    """Capacity auto-tiling for `sorted_expand`: probe streams longer
    than `EXPAND_TILE_ROWS` are split into fixed-size tiles, ONE jitted
    tile-shaped program serves all of them (expansion is independent
    per probe row, so tiling is exact), and each tile's `rows` are
    returned in GLOBAL probe coordinates.

    The last tile is padded with a sentinel key strictly below the
    table's smallest key (one 1-element device read — the build is
    sorted; any key for an empty table), which matches nothing. Returns
    (tiles, total): `tiles` is a list of (rows i64[cap], keys i64[cap],
    payloads i64[cap], total i64) per-tile tuples with cap = tile rows
    * max_mult, `total` the grand total as a python int."""
    probe_keys = jnp.asarray(probe_keys).reshape(-1)
    n = probe_keys.shape[0]
    tile = min(int(tile_rows or EXPAND_TILE_ROWS), n)
    if n == tile:
        out = _expand_tile_fn(n * max(int(table.max_mult), 1))(
            table, probe_keys, jnp.int64(0)
        )
        return [out], int(out[3])

    if table.keys.shape[0] == 0:
        pad_key = 0  # nothing can match an empty table
    else:
        kmin = int(np.asarray(table.keys[:1])[0])
        if kmin == _I64.min:
            raise ValueError(
                "cannot synthesize a below-range pad key: the build "
                "table's smallest key is INT64_MIN; pass a tile_rows "
                "dividing the probe length instead"
            )
        pad_key = kmin - 1
    pad = (-n) % tile
    if pad:
        probe_keys = jnp.concatenate(
            [probe_keys, jnp.full(pad, pad_key, jnp.int64)]
        )
    cap = tile * max(int(table.max_mult), 1)
    one_tile = _expand_tile_fn(cap)
    tiles = [
        one_tile(table, probe_keys[s : s + tile], jnp.int64(s))
        for s in range(0, n + pad, tile)
    ]
    # one host read for the whole stream: the per-tile totals are summed
    # on device
    grand = jnp.sum(jnp.stack([t[3] for t in tiles]))
    return tiles, int(grand)


@functools.lru_cache(maxsize=None)
def _expand_tile_fn(cap: int):
    """ONE jitted tile program per capacity: the table rides as a
    traced pytree argument, so every `sorted_expand_tiled` call (and
    every same-shape table) reuses the same compiled executable instead
    of re-tracing a fresh closure per invocation."""

    @jax.jit
    def one_tile(table, p, offset):
        rows, ck, cp, total = sorted_expand(table, p, cap)
        rows = jnp.where(
            rows >= 0, rows.astype(jnp.int64) + offset, jnp.int64(-1)
        )
        return rows, ck, cp, total

    return one_tile


def sorted_expand(
    table: SortedTable,
    probe_keys: jax.Array,
    capacity: int,
):
    """Materialize ALL matched (probe_row, build_key, build_payload)
    triples of one join level — gather-free. The reference materializes
    through per-row payload gathers (GatherResult, chaining_ht.cpp:126-
    136); the same output falls out of the merged sorted stream:

      1. ONE stable 3-operand sort of build∪probe (key, payload, row).
      2. Per-run build ordinals / per-probe build counts via the same
         prefix scans as `sorted_match_stats`.
      3. For f = 1..max_mult (static): the f-th build's payload
         propagates to every probe of its run with one segmented
         copy-last scan; a probe with >= f builds emits one triple.
      4. A prefix count over the F*(m+n) candidates' validity and one
         scatter compact them to the front (in candidate order); the
         static `capacity` prefix is returned.

    Work is O(F * (m+n)) after the sort, with NO random-access gathers
    and no intermediate wider than F*(m+n). Returns (rows i32[capacity],
    keys i64[capacity], payloads i64[capacity], total_matches i64);
    slots past the match count carry row == -1. `capacity` bounds the
    RETURNED rows only — total_matches reports overflow."""
    m = table.keys.shape[0]
    n = probe_keys.shape[0]
    F = max(int(table.max_mult), 1)

    keys = jnp.concatenate([table.keys, probe_keys.astype(jnp.int64)])
    pay = jnp.concatenate([table.payloads, jnp.zeros(n, jnp.int64)])
    row = jnp.concatenate(
        [jnp.full(m, -1, jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )
    sk, spay, srow = jax.lax.sort(
        [keys, pay, row], num_keys=1, is_stable=True
    )

    is_build = srow < 0
    ib = is_build.astype(jnp.int32)
    c = jnp.cumsum(ib)
    run_start = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
    base_c = _segment_base(run_start, c - ib, monotone=True)
    # builds: 1-based in-run ordinal; probes: the run's build count
    # (builds precede probes at equal keys: table first + stable sort)
    ordv = c - base_c
    total = jnp.sum(jnp.where(is_build, 0, ordv).astype(jnp.int64))

    pays_f, valid_f = [], []
    for f in range(1, F + 1):
        src = is_build & (ordv == f)
        pays_f.append(_segment_base(src, spay, monotone=False))
        valid_f.append((~is_build) & (ordv >= f))

    valid = jnp.concatenate(valid_f)
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    dst = jnp.where(valid, pos, capacity)  # invalid -> dropped

    def compact(vals, fill):
        return (
            jnp.full(capacity, fill, vals.dtype)
            .at[dst]
            .set(vals, mode="drop")
        )

    out_rows = compact(jnp.tile(srow, F), -1)
    out_keys = compact(jnp.tile(sk, F), 0)
    out_pays = compact(jnp.concatenate(pays_f), 0)
    return out_rows, out_keys, out_pays, total
