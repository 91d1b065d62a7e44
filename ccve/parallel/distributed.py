"""Distributed hash join: hash-partitioned tables + all_to_all radix shuffle.

The engine's shared-nothing distributed join (the
reference has no distributed tier at all — SURVEY.md §2 "Parallelism
inventory"). Design:

 - **Partitioning**: build rows are owned by partition
   `owner(key) = murmurhash64(key) >> (64 - log2 P)` — the hash's HIGH bits,
   deliberately disjoint from the LOW bits that pick the bucket/slot inside
   each local table, so per-partition tables stay uniformly loaded.
 - **Build**: each partition's table is built independently (host build or
   device-side sort build) and stacked on a leading mesh axis; shapes are
   padded to the max partition so every shard is identical — SPMD.
 - **Probe (radix shuffle)**: under `shard_map`, each device buckets its
   local probe keys by owner with a stable sort + exclusive-prefix
   offsets, scatters them into a `[P, cap]` send grid, and exchanges grids
   with ONE `lax.all_to_all`. Each device probes the
   received keys against its local partition (`exec/bulk.match_stats`),
   then a second all_to_all routes per-key (multiplicity, payload-sum)
   stats back to the home device, which unsorts them to original row
   order. Counting the N-way join then factorizes exactly like the
   single-chip bulk path (Σ_i Π_l mult), finished with one psum.
 - **Skew**: per-destination send histograms are psum'd into a global
   [P] load vector; `skew` = max/mean. Overflow of the static `cap` is
   detected (not silently dropped) and reported.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ccve.exec.bulk import match_stats
from ccve.ops.hash_table import CSRTable, LPTable, build_csr, build_lp, next_pow2
from ccve.ops.hashing import murmurhash64, murmurhash64_np

AXIS = "shards"


def make_join_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n & (n - 1):
        raise ValueError(f"mesh size must be a power of two (got {n})")
    if len(devs) < n:
        raise ValueError(
            f"need {n} devices for the mesh but only {len(devs)} present "
            f"({devs[0].platform}); for CPU testing set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N and "
            "jax.config.update('jax_platforms', 'cpu') before backend init"
        )
    return Mesh(np.array(devs[:n]), (axis,))


def _owner_np(keys: np.ndarray, n_parts: int) -> np.ndarray:
    if n_parts == 1:
        return np.zeros(keys.shape[0], np.int64)
    shift = np.uint64(64 - int(math.log2(n_parts)))
    return (murmurhash64_np(keys) >> shift).astype(np.int64)


def _owner_jnp(keys: jax.Array, n_parts: int) -> jax.Array:
    if n_parts == 1:
        return jnp.zeros(keys.shape[0], jnp.int32)
    shift = jnp.uint64(64 - int(math.log2(n_parts)))
    return (murmurhash64(keys) >> shift).astype(jnp.int32)


class PartitionedTables(NamedTuple):
    """One join level's build table, hash-partitioned and stacked on a
    leading axis of size P. LP: arrays are [P, n_slots]; CSR: offsets
    [P, n_buckets+1], entries [P, cap]. `max_bound` is the global static
    chain bound (max_run / max_len across partitions)."""

    kind: str  # "lp" | "csr"
    arrays: tuple  # the stacked device arrays
    max_bound: int
    n_parts: int

    def local_table(self, arrs: tuple):
        """Rebuild the single-partition table from per-shard (squeezed)
        arrays inside shard_map."""
        if self.kind == "lp":
            slot_keys, slot_payloads = arrs
            return LPTable(slot_keys, slot_payloads, self.max_bound)
        if self.kind == "sorted":
            from ccve.ops.sort_merge import SortedTable

            keys, payloads = arrs
            # no packing metadata: partitions share one SPMD program, and
            # the INT64_MAX padding rows sit outside any packable key
            # range. max_mult = the global unpadded multiplicity bound
            # (pad runs never match a probe, so they need no fan-out).
            return SortedTable(keys, payloads, max_mult=self.max_bound)
        offsets, ekeys, epays = arrs
        return CSRTable(offsets, ekeys, epays, self.max_bound)


def partition_tables(
    keys: np.ndarray,
    payloads: np.ndarray | None,
    n_parts: int,
    kind: str = "lp",
    mesh: Mesh | None = None,
) -> PartitionedTables:
    """Hash-partition one build table into P local tables with identical
    (padded) shapes, stacked on the leading axis and placed shard-per-device
    when a mesh is given."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    owner = _owner_np(keys, n_parts)
    parts = [np.nonzero(owner == p)[0] for p in range(n_parts)]
    return _pack_partitions(keys, payloads, parts, n_parts, kind, mesh)


def _pack_partitions(keys, payloads, parts, n_parts, kind, mesh):
    """Build one local table per partition index list, padded to common
    shapes and stacked on the leading axis."""
    max_count = max((idx.shape[0] for idx in parts), default=1)
    max_count = max(max_count, 1)

    if kind == "lp":
        n_slots = next_pow2(4 * max_count)
        sk = np.full((n_parts, n_slots), -1, np.int64)
        sp = np.full((n_parts, n_slots), -1, np.int64)
        bound = 1
        for p, idx in enumerate(parts):
            if idx.shape[0] == 0:
                continue
            t = _rebuild_lp(keys[idx], payloads[idx], n_slots)
            sk[p] = np.asarray(t.slot_keys)
            sp[p] = np.asarray(t.slot_payloads)
            bound = max(bound, t.max_run)
        arrays = (jnp.asarray(sk), jnp.asarray(sp))
    elif kind == "csr":
        n_buckets = next_pow2(2 * max_count)
        cap = max_count
        offs = np.zeros((n_parts, n_buckets + 1), np.int32)
        ek = np.full((n_parts, cap), -1, np.int64)
        ep = np.full((n_parts, cap), -1, np.int64)
        bound = 1
        for p, idx in enumerate(parts):
            if idx.shape[0] == 0:
                continue
            t = _rebuild_csr(keys[idx], payloads[idx], n_buckets)
            cnt = np.asarray(t.entry_keys).shape[0]
            offs[p] = np.asarray(t.offsets)
            ek[p, :cnt] = np.asarray(t.entry_keys)
            ep[p, :cnt] = np.asarray(t.entry_payloads)
            bound = max(bound, t.max_len)
        arrays = (jnp.asarray(offs), jnp.asarray(ek), jnp.asarray(ep))
    elif kind == "sorted":
        # per-partition sort-merge tables (the fast local engine): rows
        # sorted by key, padded to the max partition with INT64_MAX keys
        # (ascending-preserving, matching no engine key) / payload 0.
        # `bound` records the real (unpadded) max key multiplicity — the
        # static fan-out the materializing path's sorted_expand needs.
        sk = np.full((n_parts, max_count), np.iinfo(np.int64).max, np.int64)
        sp = np.zeros((n_parts, max_count), np.int64)
        bound = 1
        for p, idx in enumerate(parts):
            if idx.shape[0] == 0:
                continue
            order = np.argsort(keys[idx], kind="stable")
            sk[p, : idx.shape[0]] = keys[idx][order]
            sp[p, : idx.shape[0]] = payloads[idx][order]
            _, cnts = np.unique(keys[idx], return_counts=True)
            bound = max(bound, int(cnts.max(initial=1)))
        arrays = (jnp.asarray(sk), jnp.asarray(sp))
    else:
        raise ValueError(f"unknown table kind {kind!r}")

    if mesh is not None:
        # 1D join mesh: shard over AXIS. 2D (dcn, ici) mesh: the leading
        # partition axis splits over BOTH axes — partition p lives on
        # device (p // ici_size, p % ici_size), matching _owner_hier.
        sharding = NamedSharding(mesh, P(tuple(mesh.axis_names)))
        arrays = tuple(jax.device_put(a, sharding) for a in arrays)
    return PartitionedTables(kind=kind, arrays=arrays, max_bound=int(bound), n_parts=n_parts)


def _rebuild_lp(keys, payloads, n_slots) -> LPTable:
    """LP build with an explicit slot count (shape parity across shards)."""
    mask = n_slots - 1
    slot_keys = np.full(n_slots, -1, np.int64)
    slot_payloads = np.full(n_slots, -1, np.int64)
    hashes = (murmurhash64_np(keys) & np.uint64(mask)).astype(np.int64)
    for i in range(keys.shape[0]):
        s = int(hashes[i])
        while slot_keys[s] != -1:
            s = (s + 1) & mask
        slot_keys[s] = keys[i]
        slot_payloads[s] = payloads[i]
    occ = slot_keys != -1
    from ccve.ops.hash_table import _longest_circular_run

    return LPTable(
        slot_keys=jnp.asarray(slot_keys),
        slot_payloads=jnp.asarray(slot_payloads),
        max_run=int(_longest_circular_run(occ)),
    )


def _rebuild_csr(keys, payloads, n_buckets) -> CSRTable:
    bucket = (murmurhash64_np(keys) & np.uint64(n_buckets - 1)).astype(np.int64)
    counts = np.bincount(bucket, minlength=n_buckets)
    offsets = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(bucket, kind="stable")
    return CSRTable(
        offsets=jnp.asarray(offsets.astype(np.int32)),
        entry_keys=jnp.asarray(keys[order]),
        entry_payloads=jnp.asarray(payloads[order]),
        max_len=int(counts.max(initial=1)),
    )


def partition_tables_block(
    keys: np.ndarray,
    payloads: np.ndarray | None,
    n_parts: int,
    kind: str = "lp",
    mesh: Mesh | None = None,
) -> PartitionedTables:
    """BLOCK-partitioned build (row ranges, no hash shuffle at build time)
    for the ring join: partition p owns rows [p*ceil(n/P), ...). Every
    probe key must then visit every partition — see dist_bulk_count_ring."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    per = -(-keys.shape[0] // n_parts)
    owner = np.minimum(np.arange(keys.shape[0]) // per, n_parts - 1)
    # reuse the hash-partition packing with an explicit owner assignment
    parts = [np.nonzero(owner == p)[0] for p in range(n_parts)]
    return _pack_partitions(keys, payloads, parts, n_parts, kind, mesh)


class HotSplitTables(NamedTuple):
    """PRPD (partial-redistribution / partial-duplication) split of one
    build level for skewed workloads: rows whose key is a detected heavy
    hitter are REPLICATED to every partition (`rep`, tiny), the rest are
    hash-partitioned as usual (`part`). Probes with hot keys never enter
    the radix shuffle — they probe the local replica — so a Zipf head
    cannot overflow the shuffle capacity or skew the partition load."""

    part: PartitionedTables
    rep: PartitionedTables
    hot_keys: jax.Array  # int64[H], padded with -3 (matches no key)


def detect_heavy_hitters(
    keys: np.ndarray, max_hot: int = 64, min_frac: float = 0.001
) -> np.ndarray:
    """Host-side heavy-hitter detection on a (sample of a) probe key
    stream: the <= max_hot most frequent keys with frequency above
    min_frac. The reference's skew story is its chunk-level selectivity
    adaptation; distribution-level skew is a problem only a partitioned
    engine has, so this subsystem is specific to the distributed tier."""
    keys = np.asarray(keys).reshape(-1)
    vals, counts = np.unique(keys, return_counts=True)
    keep = counts >= max(1, int(min_frac * keys.shape[0]))
    vals, counts = vals[keep], counts[keep]
    order = np.argsort(-counts)[:max_hot]
    return np.ascontiguousarray(vals[order], dtype=np.int64)


def partition_tables_split(
    keys: np.ndarray,
    payloads: np.ndarray | None,
    n_parts: int,
    hot_keys: np.ndarray,
    kind: str = "lp",
    mesh: Mesh | None = None,
) -> HotSplitTables:
    """Hash-partition the cold rows; replicate the hot rows to every
    partition (stacked copies so the SPMD program stays uniform)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    hot_keys = np.ascontiguousarray(hot_keys, dtype=np.int64)
    is_hot = np.isin(keys, hot_keys)
    cold_idx = np.nonzero(~is_hot)[0]
    hot_idx = np.nonzero(is_hot)[0]
    owner = _owner_np(keys, n_parts)
    cold_parts = [
        cold_idx[owner[cold_idx] == p] for p in range(n_parts)
    ]
    part = _pack_partitions(keys, payloads, cold_parts, n_parts, kind, mesh)
    rep = _pack_partitions(
        keys, payloads, [hot_idx] * n_parts, n_parts, kind, mesh
    )
    H = max(hot_keys.shape[0], 1)
    hk = np.full(H, -3, np.int64)
    hk[: hot_keys.shape[0]] = hot_keys
    hk_dev = jnp.asarray(hk)
    if mesh is not None:
        # replicated across the mesh: every shard tests the same hot set
        hk_dev = jax.device_put(hk_dev, NamedSharding(mesh, P()))
    return HotSplitTables(part=part, rep=rep, hot_keys=hk_dev)


class ReplicatedTables(NamedTuple):
    """One join level's build table, REPLICATED to every device (no
    leading partition axis). The broadcast-join counterpart of
    `PartitionedTables` — see `dist_bulk_count_bcast` for when this is
    the right trade."""

    kind: str  # "lp" | "csr" | "sorted"
    arrays: tuple  # unstacked device arrays, replicated across the mesh
    max_bound: int

    def local_table(self, arrs: tuple):
        if self.kind == "lp":
            slot_keys, slot_payloads = arrs
            return LPTable(slot_keys, slot_payloads, self.max_bound)
        if self.kind == "sorted":
            from ccve.ops.sort_merge import SortedTable

            keys, payloads = arrs
            return SortedTable(keys, payloads, max_mult=self.max_bound)
        offsets, ekeys, epays = arrs
        return CSRTable(offsets, ekeys, epays, self.max_bound)


def replicate_tables(
    keys: np.ndarray,
    payloads: np.ndarray | None,
    kind: str = "sorted",
    mesh: Mesh | None = None,
) -> ReplicatedTables:
    """Build ONE full local table and replicate it across the mesh (the
    one-time broadcast whose cost `dist_bulk_count_bcast` amortizes).
    Reuses the partition packing with a single all-rows partition."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if payloads is None:
        payloads = np.arange(keys.shape[0], dtype=np.int64) + 10_000_000
    pt = _pack_partitions(
        keys, payloads, [np.arange(keys.shape[0])], 1, kind, None
    )
    arrays = tuple(a[0] for a in pt.arrays)
    if mesh is not None:
        sharding = NamedSharding(mesh, P())
        arrays = tuple(jax.device_put(a, sharding) for a in arrays)
    return ReplicatedTables(kind=kind, arrays=arrays,
                            max_bound=pt.max_bound)


class DistResult(NamedTuple):
    count: jax.Array  # int64: total join output rows
    payload_checksums: jax.Array  # int64[n_levels]
    skew: jax.Array  # float32: max/mean of the global partition load
    overflow: jax.Array  # bool: any send bucket exceeded cap (results invalid)


def _shuffle_level_stats(table_arrays, ptables: PartitionedTables, keys, cap):
    """Inside shard_map: route keys to owners, probe, route stats back.
    Returns (mult int32[n], psum int64[n], send_hist int64[P], overflow)."""
    P_ = jax.lax.axis_size(AXIS)
    n = keys.shape[0]
    owner = _owner_jnp(keys, P_)
    # dead keys (-2: padding, or hot probes handled by the local replica)
    # match nothing — spread them round-robin so they can't pile onto
    # murmur(-2)'s owner and eat that partition's send capacity
    dead = keys == -2
    rr = jnp.arange(n, dtype=jnp.int32) % P_
    owner = jnp.where(dead, rr, owner)

    order = jnp.argsort(owner, stable=True)
    owner_sorted = jnp.take(owner, order)
    keys_sorted = jnp.take(keys, order)
    counts = jnp.zeros(P_, jnp.int32).at[owner].add(1)
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(n, dtype=jnp.int32) - jnp.take(offs, owner_sorted)
    overflow = jnp.any(counts > cap)

    # Scatter into the [P, cap] send grid; pad key -2 never matches
    # (build keys are >= 0; EMPTY slots are -1).
    send = jnp.full((P_, cap), -2, jnp.int64)
    safe_pos = jnp.where(pos < cap, pos, cap - 1)
    send = send.at[owner_sorted, safe_pos].set(keys_sorted)

    recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0)
    local = ptables.local_table(table_arrays)
    stats = match_stats(local, recv.reshape(-1))
    mult_grid = stats.mult.reshape(P_, cap)
    psum_grid = stats.psum.reshape(P_, cap)

    back_m = jax.lax.all_to_all(mult_grid, AXIS, split_axis=0, concat_axis=0)
    back_p = jax.lax.all_to_all(psum_grid, AXIS, split_axis=0, concat_axis=0)

    mult_sorted = back_m[owner_sorted, safe_pos]
    psum_sorted = back_p[owner_sorted, safe_pos]
    inv = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    mult = jnp.take(mult_sorted, inv)
    psum = jnp.take(psum_sorted, inv)
    return mult, psum, counts.astype(jnp.int64), overflow


def dist_bulk_count(
    mesh: Mesh,
    ptables: Sequence[PartitionedTables | HotSplitTables],
    probe_rows: np.ndarray | jax.Array,
    cap_slack: float = 2.0,
) -> DistResult:
    """Distributed N-way join count over `mesh`. `probe_rows` is
    int64[n, n_joins] (host or device); rows are split evenly across
    devices (padded with no-match sentinel keys), shuffled per level by
    key ownership, and the factorized count/checksums are psum'd.

    A level given as `HotSplitTables` takes the PRPD path: probes whose
    key is in the level's hot set are masked out of the shuffle (their
    stats come from the local replica), so the Zipf head neither loads
    one partition nor counts toward the send capacity."""
    n_parts = mesh.devices.size
    probe = jnp.asarray(probe_rows, jnp.int64)
    n, n_joins = probe.shape
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate(
            [probe, jnp.full((pad, n_joins), -2, jnp.int64)]
        )
    cap = max(int(per_dev / n_parts * cap_slack) + 8, 16)
    cap = min(cap, per_dev)

    probe_sharded = jax.device_put(
        probe, NamedSharding(mesh, P(AXIS, None))
    )

    def leaves(pt):
        if isinstance(pt, HotSplitTables):
            return (pt.part.arrays, pt.rep.arrays, pt.hot_keys)
        return pt.arrays

    table_leaves = tuple(leaves(pt) for pt in ptables)
    in_specs = (
        tuple(
            (
                jax.tree.map(lambda _: P(AXIS), pt.part.arrays),
                jax.tree.map(lambda _: P(AXIS), pt.rep.arrays),
                P(),
            )
            if isinstance(pt, HotSplitTables)
            else jax.tree.map(lambda _: P(AXIS), pt.arrays)
            for pt in ptables
        ),
        P(AXIS, None),
    )
    out_specs = (P(), P(), P(), P())

    def spmd(table_leaves, probe_local):  # probe_local: [per_dev, n_joins]
        mults, psums = [], []
        hist = jnp.zeros(n_parts, jnp.int64)
        over = jnp.zeros((), jnp.int32)
        for l, pt in enumerate(ptables):
            keys = probe_local[:, l]
            if isinstance(pt, HotSplitTables):
                part_arrs, rep_arrs, hot = table_leaves[l]
                arrs = tuple(a[0] for a in part_arrs)
                hot_mask = jnp.any(
                    keys[:, None] == hot[None, :], axis=1
                )
                routed = jnp.where(hot_mask, jnp.int64(-2), keys)
                m, s, h, o = _shuffle_level_stats(arrs, pt.part, routed, cap)
                rep_local = pt.rep.local_table(
                    tuple(a[0] for a in rep_arrs)
                )
                rs = match_stats(rep_local, keys)
                m = m + rs.mult
                s = s + rs.psum
            else:
                arrs = tuple(a[0] for a in table_leaves[l])  # squeeze shard
                m, s, h, o = _shuffle_level_stats(arrs, pt, keys, cap)
            mults.append(m.astype(jnp.int64))
            psums.append(s)
            hist = hist + h
            over = jnp.maximum(over, o.astype(jnp.int32))
        prod = mults[0]
        for m in mults[1:]:
            prod = prod * m
        count = jax.lax.psum(jnp.sum(prod), AXIS)
        chks = []
        for l in range(len(ptables)):
            others = jnp.where(mults[l] > 0, prod // mults[l], 0)
            chks.append(jax.lax.psum(jnp.sum(psums[l] * others), AXIS))
        ghist = jax.lax.psum(hist, AXIS).astype(jnp.float32)
        skew = ghist.max() / jnp.maximum(ghist.mean(), 1.0)
        overflow = jax.lax.pmax(over, AXIS) > 0
        return count, jnp.stack(chks), skew.astype(jnp.float32), overflow

    f = jax.jit(
        jax.shard_map(spmd, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    count, chks, skew, overflow = f(table_leaves, probe_sharded)
    return DistResult(
        count=count, payload_checksums=chks, skew=skew, overflow=overflow
    )


def dist_bulk_count_ring(
    mesh: Mesh,
    ptables: Sequence[PartitionedTables],
    probe_rows: np.ndarray | jax.Array,
    n_chunks: int = 2,
) -> DistResult:
    """Ring (fragment-replicate) N-way join count for BLOCK-partitioned
    builds (partition_tables_block): no radix shuffle — instead each
    device's probe chunk visits every partition via P-1 `ppermute`
    rotations, accumulating per-row (mult, psum) that travel with the
    chunk; multiplicities are additive across partitions. After a full
    rotation the chunk is home, so the factorized count needs no inverse
    routing. This is the analogue of ring-exchange joins (and
    structurally of ring attention's KV rotation), trading P× probe
    compute for zero shuffle-capacity risk — the right choice when the
    build side is small or heavily skewed.

    **Exchange/compute overlap**: each device's local probe stream is
    split into `n_chunks` independently-circulating chunks. Within a
    rotation step the chunks are probed and permuted one after another,
    so chunk c's transfer carries no data dependency on chunk c+1's
    probe — XLA's latency-hiding scheduler overlaps the in-flight
    permute with the next chunk's local compute (the same software
    pipeline ring attention uses for its KV rotation). n_chunks=1
    degenerates to the strictly-serialized ring.
    """
    n_parts = mesh.devices.size
    n_chunks = max(1, n_chunks)
    probe = jnp.asarray(probe_rows, jnp.int64)
    n, n_joins = probe.shape
    per_dev = -(-n // n_parts)
    per_dev += (-per_dev) % n_chunks  # chunk-divisible
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate(
            [probe, jnp.full((pad, n_joins), -2, jnp.int64)]
        )
    probe_sharded = jax.device_put(probe, NamedSharding(mesh, P(AXIS, None)))
    table_leaves = tuple(pt.arrays for pt in ptables)
    in_specs = (jax.tree.map(lambda _: P(AXIS), table_leaves), P(AXIS, None))
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]
    per_chunk = per_dev // n_chunks
    n_levels = len(ptables)

    def spmd(table_leaves, probe_local):
        locals_ = [
            pt.local_table(tuple(a[0] for a in table_leaves[l]))
            for l, pt in enumerate(ptables)
        ]
        chunks = []
        for c in range(n_chunks):
            sl = probe_local[c * per_chunk : (c + 1) * per_chunk].T
            chunks.append(
                (
                    sl,  # [n_joins, per_chunk]
                    jnp.zeros((n_levels, per_chunk), jnp.int64),
                    jnp.zeros((n_levels, per_chunk), jnp.int64),
                )
            )
        for _ in range(n_parts):
            nxt = []
            for c in range(n_chunks):
                keys, mult, psum = chunks[c]
                new_mult, new_psum = [], []
                for l in range(n_levels):
                    s = match_stats(locals_[l], keys[l])
                    new_mult.append(mult[l] + s.mult.astype(jnp.int64))
                    new_psum.append(psum[l] + s.psum)
                # issue this chunk's permute before touching chunk c+1:
                # no dependency between chunks -> transfer overlaps the
                # next chunk's probe compute
                nxt.append(
                    jax.tree.map(
                        lambda x: jax.lax.ppermute(x, AXIS, perm),
                        (keys, jnp.stack(new_mult), jnp.stack(new_psum)),
                    )
                )
            chunks = nxt
        # home again after P rotations: reassemble the local stream
        mult = jnp.concatenate([c[1] for c in chunks], axis=1)
        psum = jnp.concatenate([c[2] for c in chunks], axis=1)
        prod = mult[0]
        for l in range(1, len(ptables)):
            prod = prod * mult[l]
        count = jax.lax.psum(jnp.sum(prod), AXIS)
        chks = []
        for l in range(len(ptables)):
            others = jnp.where(mult[l] > 0, prod // mult[l], 0)
            chks.append(jax.lax.psum(jnp.sum(psum[l] * others), AXIS))
        return (
            count,
            jnp.stack(chks),
            jnp.ones((), jnp.float32),  # ring visits all: skew N/A
            jnp.zeros((), bool),  # no shuffle capacity to overflow
        )

    f = jax.jit(
        jax.shard_map(
            spmd, mesh=mesh, in_specs=in_specs,
            out_specs=(P(), P(), P(), P()),
        )
    )
    count, chks, skew, overflow = f(table_leaves, probe_sharded)
    return DistResult(
        count=count, payload_checksums=chks, skew=skew, overflow=overflow
    )


# ---------------------------------------------------------------------------
# Hierarchical (multi-host) tier: 2D (dcn, ici) mesh. It models several
# hosts — a slow cross-host network (dcn) and fast links between the
# devices of one host (ici) — and is for multi-host launches; on one host
# every device reaches every other at the same rate, and the flat mesh
# (`make_join_mesh`) is the one to use.
# ---------------------------------------------------------------------------

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def make_join_mesh_2d(
    n_hosts: int, chips_per_host: int, axes=(DCN_AXIS, ICI_AXIS)
) -> Mesh:
    """A (hosts × devices-per-host) mesh: the leading axis crosses the
    hosts' network (or stands in for it on a virtual CPU mesh), the
    trailing axis the links inside one host.
    Partition p of a P = n_hosts*chips_per_host–way partitioning lives on
    device (p // chips_per_host, p % chips_per_host)."""
    devs = jax.devices()
    need = n_hosts * chips_per_host
    if len(devs) < need:
        raise ValueError(
            f"need {need} devices ({n_hosts}x{chips_per_host}) but only "
            f"{len(devs)} present"
        )
    return Mesh(np.array(devs[:need]).reshape(n_hosts, chips_per_host), axes)


def _route_one_hop(vals: jax.Array, dest: jax.Array, n_dest: int, axis: str,
                   cap: int):
    """Route int64 `vals` to shard `dest` along mesh `axis` with one
    all_to_all of a [n_dest, cap] grid (-2 = empty slot).

    Dead values (-2 — probe padding, PRPD-masked keys, or grid filler
    from a previous hop) need no particular destination, so their
    `dest` is ignored: they are assigned to rows with FREE capacity
    (free-slot fill), live values pack first within each row, and any
    dead value that still doesn't fit scatters into a phantom column
    that is never transmitted. Live keys therefore can never be
    displaced by padding, and `overflow` reflects live counts only.
    Returns (received flat values, reverse-routing state, overflow)."""
    n = vals.shape[0]
    dead = vals == -2
    dead_i = dead.astype(jnp.int32)
    live_i = 1 - dead_i
    counts_live = jnp.zeros(n_dest, jnp.int32).at[dest].add(live_i)
    overflow = jnp.any(counts_live > cap)
    # dead value of rank r fills global free slot r mod F
    free = jnp.maximum(cap - counts_live, 0)
    cum_free = jnp.cumsum(free)
    total_free = cum_free[-1]
    dead_rank = jnp.cumsum(dead_i) - 1
    slot = dead_rank % jnp.maximum(total_free, 1)
    dest_dead = jnp.searchsorted(cum_free, slot, side="right").astype(
        jnp.int32
    )
    dest = jnp.where(dead, dest_dead, dest).astype(jnp.int32)
    # group by destination with live values first inside each group, so
    # a live value's in-group position is always < counts_live[d] <= cap
    order = jnp.argsort(dest * 2 + dead_i, stable=True)
    dest_sorted = jnp.take(dest, order)
    vals_sorted = jnp.take(vals, order)
    counts = jnp.zeros(n_dest, jnp.int32).at[dest].add(1)
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(n, dtype=jnp.int32) - jnp.take(offs, dest_sorted)
    # clamp to the phantom column `cap` (dropped before the all_to_all)
    safe_pos = jnp.where(pos < cap, pos, cap)
    send = jnp.full((n_dest, cap + 1), -2, jnp.int64)
    send = send.at[dest_sorted, safe_pos].set(vals_sorted)
    recv = jax.lax.all_to_all(send[:, :cap], axis, split_axis=0,
                              concat_axis=0)
    inv = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    state = (dest_sorted, jnp.minimum(safe_pos, cap - 1), inv)
    return recv.reshape(-1), state, overflow


def _route_back_one_hop(stats: Sequence[jax.Array], state, n_dest: int,
                        axis: str):
    """Reverse of `_route_one_hop` for per-received-value stat arrays."""
    dest_sorted, safe_pos, inv = state
    out = []
    for s in stats:
        grid = s.reshape(n_dest, -1)
        back = jax.lax.all_to_all(grid, axis, split_axis=0, concat_axis=0)
        picked = back[dest_sorted, safe_pos]
        out.append(jnp.take(picked, inv))
    return out


def _hier_level_stats(table_arrays, ptables: PartitionedTables, keys,
                      n_hosts: int, n_ici: int, caps):
    """Two-hop hierarchical shuffle: ICI owner-column aggregation, then
    ONE host-aggregated DCN crossing that lands every key exactly at
    its owner chip.

      hop A (ici): to local chip i = owner % I  (the owner's chip column)
      hop B (dcn): to host d = owner // I — the receiving chip IS the
                   owner, since its column was fixed by hop A

    Owner-column routing is uniform, so hop B's [D, capB] grid has ALL
    rows live at ~per_dev/D keys each — byte-optimal DCN traffic in D-1
    aggregated messages per chip. (The previous 3-hop design aggregated
    by destination HOST first: each chip's traffic then concentrated on
    ceil(D/I) of the D grid rows, forcing row capacity up by I/ceil(D/I)
    and re-routing grid padding forward so cap slack compounded across
    hops. One hop, strictly fewer bytes, was the fix.) Dead keys (-2)
    fill free row capacity inside `_route_one_hop` and their returned
    stats are masked to zero here. Returns (mult, psum, owner
    histogram, overflow) like `_shuffle_level_stats`."""
    P_ = n_hosts * n_ici
    capA, capB = caps
    owner0 = _owner_jnp(keys, P_)
    live0 = keys != -2
    hist = jnp.zeros(P_, jnp.int64).at[owner0].add(live0.astype(jnp.int64))

    kA, stA, ovA = _route_one_hop(
        keys, owner0 % n_ici, n_ici, ICI_AXIS, capA
    )
    oA = _owner_jnp(kA, P_)
    kB, stB, ovB = _route_one_hop(kA, oA // n_ici, n_hosts, DCN_AXIS, capB)

    local = ptables.local_table(table_arrays)
    stats = match_stats(local, kB)

    # mult stays int32 across both return hops (12 B/slot with psum —
    # the same wire cost per slot as the flat shuffle's return)
    mA, pA = _route_back_one_hop(
        [stats.mult, stats.psum], stB, n_hosts, DCN_AXIS
    )
    mult, psum = _route_back_one_hop([mA, pA], stA, n_ici, ICI_AXIS)
    # dead keys may have read a clamped slot's stats on the way back
    mult = jnp.where(live0, mult, 0)
    psum = jnp.where(live0, psum, 0)
    overflow = ovA | ovB
    return mult.astype(jnp.int32), psum, hist, overflow


def dist_bulk_count_hier(
    mesh: Mesh,
    ptables: Sequence[PartitionedTables],
    probe_rows: np.ndarray | jax.Array,
    cap_slack: float = 2.0,
) -> DistResult:
    """Distributed N-way join count over a 2D (dcn, ici) mesh with the
    HIERARCHICAL radix shuffle: an ICI hop to the owner's chip column,
    then each probe key crosses the slow DCN axis exactly once, inside
    a host-aggregated [n_hosts, cap] grid, landing directly at its
    owner chip. The flat `dist_bulk_count` all_to_all sends P-1
    per-chip messages of which (P - I) cross DCN individually; here DCN
    sees D-1 aggregated messages per chip at the byte-optimal size
    (~per_dev/D live keys each). (Scaling-book recipe: lay shardings
    out so collectives ride ICI, aggregate what must cross DCN.) Tables
    must be partitioned with `mesh=the same 2D mesh` (partition p on
    device (p // I, p % I))."""
    assert tuple(mesh.axis_names) == (DCN_AXIS, ICI_AXIS), mesh.axis_names
    n_hosts, n_ici = mesh.devices.shape
    n_parts = n_hosts * n_ici
    probe = jnp.asarray(probe_rows, jnp.int64)
    n, n_joins = probe.shape
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate(
            [probe, jnp.full((pad, n_joins), -2, jnp.int64)]
        )

    def capf(avg):
        return max(int(avg * cap_slack) + 8, 16)

    # hop A (ici): owner chip-columns are uniform over I -> each source
    # chip sends ~per_dev/I keys per column. hop B (dcn): after hop A a
    # chip holds ~per_dev live keys whose destination hosts are uniform
    # over D -> ~per_dev/D per row. Caps are sized off LIVE expectations
    # (grid padding fills free capacity, _route_one_hop).
    capA = capf(per_dev / n_ici)
    capB = capf(per_dev / n_hosts)

    probe_sharded = jax.device_put(
        probe, NamedSharding(mesh, P((DCN_AXIS, ICI_AXIS), None))
    )
    table_leaves = tuple(pt.arrays for pt in ptables)
    in_specs = (
        jax.tree.map(lambda _: P((DCN_AXIS, ICI_AXIS)), table_leaves),
        P((DCN_AXIS, ICI_AXIS), None),
    )

    def spmd(table_leaves, probe_local):
        mults, psums = [], []
        hist = jnp.zeros(n_parts, jnp.int64)
        over = jnp.zeros((), jnp.int32)
        for l, pt in enumerate(ptables):
            arrs = tuple(a[0] for a in table_leaves[l])
            m, s, h, o = _hier_level_stats(
                arrs, pt, probe_local[:, l], n_hosts, n_ici,
                (capA, capB),
            )
            mults.append(m.astype(jnp.int64))
            psums.append(s)
            hist = hist + h
            over = jnp.maximum(over, o.astype(jnp.int32))
        prod = mults[0]
        for m in mults[1:]:
            prod = prod * m
        axes = (DCN_AXIS, ICI_AXIS)
        count = jax.lax.psum(jnp.sum(prod), axes)
        chks = []
        for l in range(len(ptables)):
            others = jnp.where(mults[l] > 0, prod // mults[l], 0)
            chks.append(jax.lax.psum(jnp.sum(psums[l] * others), axes))
        ghist = jax.lax.psum(hist, axes).astype(jnp.float32)
        skew = ghist.max() / jnp.maximum(ghist.mean(), 1.0)
        overflow = jax.lax.pmax(jax.lax.pmax(over, DCN_AXIS), ICI_AXIS) > 0
        return count, jnp.stack(chks), skew.astype(jnp.float32), overflow

    f = jax.jit(
        jax.shard_map(
            spmd, mesh=mesh, in_specs=in_specs,
            out_specs=(P(), P(), P(), P()),
        )
    )
    count, chks, skew, overflow = f(table_leaves, probe_sharded)
    return DistResult(
        count=count, payload_checksums=chks, skew=skew, overflow=overflow
    )


# ---------------------------------------------------------------------------
# Broadcast (replicated-build) tier: the shuffle amortization
# ---------------------------------------------------------------------------


def dist_bulk_count_bcast(
    mesh: Mesh,
    rtables: Sequence[ReplicatedTables],
    probe_rows: np.ndarray | jax.Array,
) -> DistResult:
    """Distributed N-way join count with REPLICATED builds — the shuffle
    amortization for builds small enough to copy to every device.

    Why this, and not a cleverer shuffle: the per-level radix shuffle
    moves bytes in proportion to the probe stream, because every probe
    key pays ~20 wire bytes per level (8 B key out, 12 B
    (mult, psum) back) EVERY pass, while both compute and bytes shrink
    together with P. Forward-chaining the levels (route the row once,
    hop owner-to-owner carrying partial stats) does not help: the row
    must drag its remaining keys and accumulated psums through every
    hop, Σ_l [8·(L-l) + 4 + 8·l] ≈ 8·L² + 12·L bytes/row — MORE than
    the 20·L of the per-level shuffle for every L ≥ 1. The byte count
    that can actually be removed is the per-key traffic itself: the
    multiplicity/psum function each level evaluates has a SMALL domain
    (the build table, n_rhs rows — 128K..2M in the reference's own
    workloads, base.h:44-51) while the probe stream is huge (16M-134M
    rows, base.h:43). So ship the FUNCTION, not the arguments: one-time
    all-gather of each level's table (16·m bytes, sorted kind), then
    every probe row is answered entirely locally and the only recurring
    communication is an O(L) scalar psum. The broadcast cost is
    amortized over all L levels and every probe batch streamed against
    the same build — exactly the reference driver's shape (one build,
    then a long chunk stream, main.cpp:62-95).

    Probe rows are split evenly across devices (row balance is exact by
    construction: skew ≡ 1.0, no send capacity exists to overflow).
    Works on any mesh (1D join mesh or 2D (dcn, ici)); the psum runs
    over all mesh axes. For build tables too large to replicate, the
    partitioned `dist_bulk_count`/`dist_bulk_count_hier` remain the
    alternative."""
    axes = tuple(mesh.axis_names)
    n_parts = mesh.devices.size
    probe = jnp.asarray(probe_rows, jnp.int64)
    n, n_joins = probe.shape
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate(
            [probe, jnp.full((pad, n_joins), -2, jnp.int64)]
        )
    probe_sharded = jax.device_put(
        probe, NamedSharding(mesh, P(axes, None))
    )
    table_leaves = tuple(rt.arrays for rt in rtables)
    in_specs = (
        tuple(jax.tree.map(lambda _: P(), rt.arrays) for rt in rtables),
        P(axes, None),
    )
    out_specs = (P(), P(), P(), P())

    def spmd(table_leaves, probe_local):  # probe_local: [per_dev, n_joins]
        mults, psums = [], []
        for l, rt in enumerate(rtables):
            local = rt.local_table(table_leaves[l])
            # pad keys (-2) match nothing: build keys are >= 0, LP empty
            # is -1, sorted padding is INT64_MAX
            s = match_stats(local, probe_local[:, l])
            mults.append(s.mult.astype(jnp.int64))
            psums.append(s.psum)
        prod = mults[0]
        for m in mults[1:]:
            prod = prod * m
        count = jax.lax.psum(jnp.sum(prod), axes)
        chks = []
        for l in range(len(rtables)):
            others = jnp.where(mults[l] > 0, prod // mults[l], 0)
            chks.append(jax.lax.psum(jnp.sum(psums[l] * others), axes))
        return (
            count,
            jnp.stack(chks),
            jnp.ones((), jnp.float32),  # row-balanced by construction
            jnp.zeros((), bool),  # no send capacity to overflow
        )

    f = jax.jit(
        jax.shard_map(spmd, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs)
    )
    count, chks, skew, overflow = f(table_leaves, probe_sharded)
    return DistResult(
        count=count, payload_checksums=chks, skew=skew, overflow=overflow
    )


class DistExpandResult(NamedTuple):
    """Materialized distributed join output, per shard: the first
    `counts[p]` slots of shard p's arrays are valid (probe_row,
    build_key, build_payload) triples; `total` is the exact global match
    count (== counts.sum() unless `overflow`)."""

    rows: jax.Array  # int64[n_parts * capacity] global probe-row ids, -1 pad
    keys: jax.Array  # int64[n_parts * capacity] matched build keys
    payloads: jax.Array  # int64[n_parts * capacity] matched build payloads
    counts: jax.Array  # int64[n_parts] valid triples per shard
    total: jax.Array  # int64
    overflow: jax.Array  # bool: a send bucket overflowed (results invalid)

    def triples(self) -> np.ndarray:
        """Host view: int64[total, 3] (row, key, payload), shard order."""
        n_parts = self.counts.shape[0]
        cap = self.rows.shape[0] // n_parts
        out = []
        for p in range(n_parts):
            c = int(self.counts[p])
            s = p * cap
            out.append(
                np.stack(
                    [
                        np.asarray(self.rows[s : s + c]),
                        np.asarray(self.keys[s : s + c]),
                        np.asarray(self.payloads[s : s + c]),
                    ],
                    axis=1,
                )
            )
        return np.concatenate(out, axis=0)


class DistPipelineResult(NamedTuple):
    """Materialized distributed N-WAY join output, sharded: on shard p,
    the slots with rid >= 0 are valid output rows. `rid` is the global
    probe-row id; `payloads[l]` the level-l matched build payload (the
    matched KEY is the probe's own column l — equi-join). `total` is the
    exact global match count."""

    rid: jax.Array  # int64[n_parts * S] global probe-row ids, -1 dead
    payloads: jax.Array  # int64[n_levels, n_parts * S]
    counts: jax.Array  # int64[n_parts]
    total: jax.Array  # int64
    overflow: jax.Array  # bool

    def materialize(self, probe_rows: np.ndarray, payload_mode) -> np.ndarray:
        """Host view in the executor's row layout (exec/oracle.py):
        [probe cols..., per-level (0, key) | (key, payload)]."""
        from ccve.config import PayloadMode

        probe_rows = np.asarray(probe_rows)
        rid = np.asarray(self.rid)
        pays = np.asarray(self.payloads)
        valid = rid >= 0
        rid_v = rid[valid]
        n_levels = pays.shape[0]
        cols = [probe_rows[rid_v]]
        for l in range(n_levels):
            key_l = probe_rows[rid_v, l]
            if payload_mode is PayloadMode.REFERENCE:
                cols.append(np.zeros_like(key_l)[:, None])
                cols.append(key_l[:, None])
            else:
                cols.append(key_l[:, None])
                cols.append(pays[l, valid][:, None])
        return np.concatenate(cols, axis=1)


def dist_pipeline_expand(
    mesh: Mesh,
    ptables: Sequence[PartitionedTables],
    probe_rows: np.ndarray | jax.Array,
    cap_slack: float = 2.0,
    level_caps: Sequence[int] | None = None,
) -> DistPipelineResult:
    """Distributed MATERIALIZING N-way join — the reference pipeline's
    full output (main.cpp:119-191) across the mesh, not just counts.

    A cascade of radix-shuffled expansions: at level l every live
    partial row is routed to the owner of its level-l key (cargo: the
    global probe-row id + the matched payloads of levels < l; the
    remaining key columns are re-read on the host side of nothing —
    they ride as planes), expanded gather-free against the owner's
    shard (`sorted_expand`), and the survivors proceed to level l+1.
    Output stays sharded where the LAST level expanded it; the triple
    multiset equals the single-chip `oracle_pipeline` exactly
    (tests/test_distributed.py, CPU mesh).

    Capacities default to static worst cases (each level's expansion
    buffer = what its shuffle can deliver x the level's max
    multiplicity) — safe but MULTIPLICATIVE: a 4-level fan-out-4 join
    multiplies per-shard state by ~cap_slack*4 per level regardless of
    live rows. `level_caps[l]` bounds the PER-SHARD state carried out of
    level l instead (a cardinality estimate x slack, the usual planner
    input): after each level's expansion the live rows are re-compacted
    (one validity sort) into the bounded buffer, and exceeding it is
    DETECTED overflow, exactly like send-bucket overflow — never a
    silent drop. The transient expansion buffer inside a level stays
    worst-case (it must: `sorted_expand`'s output bound is exact), so
    memory scales with one level's worst case + the bounded carry, not
    the product over levels."""
    for pt in ptables:
        if pt.kind != "sorted":
            raise ValueError("dist_pipeline_expand needs 'sorted' partitions")
    from ccve.ops.sort_merge import sorted_expand

    n_parts = mesh.devices.size
    probe = jnp.asarray(probe_rows, jnp.int64)
    n, n_levels = probe.shape
    assert n_levels == len(ptables)
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate(
            [probe, jnp.full((pad, n_levels), -2, jnp.int64)]
        )

    # static per-shard state size per level (S[0] holds the probe shard)
    S = [per_dev]
    caps = []  # per-level send-bucket capacity
    expand_caps = []  # per-level transient expansion size (exact bound)
    for l, pt in enumerate(ptables):
        c = max(int(S[l] / n_parts * cap_slack) + 8, 16)
        c = min(c, S[l])
        caps.append(c)
        worst = n_parts * c * max(int(pt.max_bound), 1)
        expand_caps.append(worst)
        if level_caps is not None and l < len(level_caps):
            S.append(min(worst, max(int(level_caps[l]), 1)))
        else:
            S.append(worst)

    probe_sharded = jax.device_put(probe, NamedSharding(mesh, P(AXIS, None)))
    in_specs = (
        tuple(jax.tree.map(lambda _: P(AXIS), pt.arrays) for pt in ptables),
        P(AXIS, None),
    )
    out_specs = (P(AXIS), P(AXIS), P(AXIS), P(), P())
    table_leaves = tuple(pt.arrays for pt in ptables)

    def spmd(table_leaves, probe_local):  # [per_dev, n_levels]
        P_ = jax.lax.axis_size(AXIS)
        d = jax.lax.axis_index(AXIS)
        rid = d * per_dev + jnp.arange(per_dev, dtype=jnp.int64)
        rid = jnp.where(probe_local[:, 0] == -2, jnp.int64(-1), rid)
        kcols = [probe_local[:, l] for l in range(n_levels)]
        mpays = []  # matched payloads of completed levels
        overflow = jnp.zeros((), jnp.int32)

        for l, pt in enumerate(ptables):
            cap = caps[l]
            k = jnp.where(rid >= 0, kcols[l], jnp.int64(-2))
            sz = k.shape[0]
            owner = _owner_jnp(k, P_)
            dead = rid < 0
            rr = jnp.arange(sz, dtype=jnp.int32) % P_
            owner = jnp.where(dead, rr, owner)

            order = jnp.argsort(owner, stable=True)
            owner_sorted = jnp.take(owner, order)
            counts = jnp.zeros(P_, jnp.int32).at[owner].add(1)
            offs = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
            )
            pos = jnp.arange(sz, dtype=jnp.int32) - jnp.take(
                offs, owner_sorted
            )
            overflow = jnp.maximum(
                overflow, jnp.any(counts > cap).astype(jnp.int32)
            )
            safe_pos = jnp.where(pos < cap, pos, cap - 1)

            def route(vals, fill):
                send = jnp.full((P_, cap), fill, jnp.int64)
                send = send.at[owner_sorted, safe_pos].set(
                    jnp.take(vals, order)
                )
                return jax.lax.all_to_all(
                    send, AXIS, split_axis=0, concat_axis=0
                ).reshape(-1)

            recv_k = route(k, -2)
            recv_rid = route(rid, -1)
            recv_kcols = [
                route(kcols[j], -2) for j in range(l + 1, n_levels)
            ]
            recv_pays = [route(mp, 0) for mp in mpays]

            local = pt.local_table(tuple(a[0] for a in table_leaves[l]))
            capx = expand_caps[l]
            ridx, _mk, mpay_l, _tot = sorted_expand(local, recv_k, capx)
            src_idx = jnp.clip(ridx, 0, P_ * cap - 1)
            live = ridx >= 0

            def expand_cargo(vals, fill):
                g = jnp.take(vals, src_idx, mode="clip")
                return jnp.where(live, g, jnp.int64(fill))

            rid = expand_cargo(recv_rid, -1)
            # dead received slots (pad/-2) never match, but guard anyway
            rid = jnp.where(live, rid, jnp.int64(-1))
            kcols = [jnp.zeros((capx,), jnp.int64)] * (l + 1) + [
                expand_cargo(kc, -2) for kc in recv_kcols
            ]
            mpays = [expand_cargo(mp, 0) for mp in recv_pays]
            mpays.append(jnp.where(rid >= 0, mpay_l, 0))

            if S[l + 1] < capx:
                # bounded carry: re-compact live rows (one validity
                # sort — live first, stable) into the level_caps[l]
                # buffer; exceeding it is DETECTED overflow
                live_now = rid >= 0
                n_live = jnp.sum(live_now.astype(jnp.int32))
                overflow = jnp.maximum(
                    overflow,
                    (n_live > S[l + 1]).astype(jnp.int32),
                )
                sel = jnp.argsort(~live_now, stable=True)[: S[l + 1]]
                rid = jnp.take(rid, sel)
                kcols = [jnp.take(kc, sel) for kc in kcols]
                mpays = [jnp.take(mp, sel) for mp in mpays]

        count_local = jnp.sum((rid >= 0).astype(jnp.int64))
        total = jax.lax.psum(count_local, AXIS)
        over = jax.lax.pmax(overflow, AXIS) > 0
        pays = jnp.stack(
            [jnp.where(rid >= 0, mp, 0) for mp in mpays]
        )  # [L, S_final]
        return rid, pays.T, count_local[None], total, over

    f = jax.jit(
        jax.shard_map(spmd, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    rid, pays_t, counts, total, overflow = f(table_leaves, probe_sharded)
    return DistPipelineResult(
        rid=rid,
        payloads=pays_t.T,
        counts=counts,
        total=total,
        overflow=overflow,
    )


def dist_bulk_expand(
    mesh: Mesh,
    ptable: PartitionedTables,
    probe_keys: np.ndarray | jax.Array,
    cap_slack: float = 2.0,
) -> DistExpandResult:
    """Distributed MATERIALIZING single-level join (the north star's
    "bit-identical join results", not just counts, across the mesh):
    probe keys are radix-shuffled to their key's owner carrying their
    global row id, each shard materializes its matches gather-free with
    `sorted_expand` (ops/sort_merge.py), and the triples stay sharded —
    the result multiset equals the single-chip `sorted_expand` exactly
    (asserted in tests/test_distributed.py on a CPU mesh).

    `ptable` must be the "sorted" kind (partition_tables(..., kind=
    "sorted")). Output capacity per shard is the static worst case
    n_parts * cap * max_mult, so expansion itself cannot overflow; only
    the shuffle's send-bucket capacity can (reported, like
    dist_bulk_count)."""
    if ptable.kind != "sorted":
        raise ValueError("dist_bulk_expand needs kind='sorted' partitions")
    from ccve.ops.sort_merge import sorted_expand

    n_parts = mesh.devices.size
    probe = jnp.asarray(probe_keys, jnp.int64).reshape(-1)
    n = probe.shape[0]
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        probe = jnp.concatenate([probe, jnp.full(pad, -2, jnp.int64)])
    cap = max(int(per_dev / n_parts * cap_slack) + 8, 16)
    cap = min(cap, per_dev)
    F = max(int(ptable.max_bound), 1)
    capx = n_parts * cap * F  # static per-shard output bound

    probe_sharded = jax.device_put(probe, NamedSharding(mesh, P(AXIS)))
    in_specs = (jax.tree.map(lambda _: P(AXIS), ptable.arrays), P(AXIS))
    out_specs = (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P())

    def spmd(table_leaves, probe_local):  # probe_local: [per_dev]
        P_ = jax.lax.axis_size(AXIS)
        d = jax.lax.axis_index(AXIS)
        keys = probe_local
        grow = d * per_dev + jnp.arange(per_dev, dtype=jnp.int64)
        owner = _owner_jnp(keys, P_)
        dead = keys == -2
        rr = jnp.arange(per_dev, dtype=jnp.int32) % P_
        owner = jnp.where(dead, rr, owner)

        order = jnp.argsort(owner, stable=True)
        owner_sorted = jnp.take(owner, order)
        keys_sorted = jnp.take(keys, order)
        rows_sorted = jnp.take(grow, order)
        counts = jnp.zeros(P_, jnp.int32).at[owner].add(1)
        offs = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
        )
        pos = jnp.arange(per_dev, dtype=jnp.int32) - jnp.take(
            offs, owner_sorted
        )
        overflow = jnp.any(counts > cap)
        safe_pos = jnp.where(pos < cap, pos, cap - 1)

        send_k = jnp.full((P_, cap), -2, jnp.int64)
        send_k = send_k.at[owner_sorted, safe_pos].set(keys_sorted)
        send_r = jnp.full((P_, cap), -1, jnp.int64)
        send_r = send_r.at[owner_sorted, safe_pos].set(rows_sorted)
        recv_k = jax.lax.all_to_all(send_k, AXIS, split_axis=0, concat_axis=0)
        recv_r = jax.lax.all_to_all(send_r, AXIS, split_axis=0, concat_axis=0)

        local = ptable.local_table(tuple(a[0] for a in table_leaves))
        ridx, mkeys, mpays, total_local = sorted_expand(
            local, recv_k.reshape(-1), capx
        )
        src = jnp.take(
            recv_r.reshape(-1),
            jnp.clip(ridx, 0, P_ * cap - 1),
            mode="clip",
        )
        grows = jnp.where(ridx >= 0, src, jnp.int64(-1))
        count_local = jnp.sum((grows >= 0).astype(jnp.int64))
        total = jax.lax.psum(total_local, AXIS)
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), AXIS) > 0
        return (
            grows,
            jnp.where(grows >= 0, mkeys, 0),
            jnp.where(grows >= 0, mpays, 0),
            count_local[None],
            total,
            overflow,
        )

    f = jax.jit(
        jax.shard_map(spmd, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    rows, keys, pays, counts, total, overflow = f(
        ptable.arrays, probe_sharded
    )
    return DistExpandResult(
        rows=rows,
        keys=keys,
        payloads=pays,
        counts=counts,
        total=total,
        overflow=overflow,
    )
