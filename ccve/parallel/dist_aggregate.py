"""Distributed hash aggregate — group-by over a hash-partitioned mesh.

The north-star op set (BASELINE.json: filter / aggregate /
sort alongside the joins) gets the same shared-nothing treatment as the
join tier (parallel/distributed.py). The reference has no counterpart —
it is single-thread C++ (SURVEY.md §2 parallelism inventory).

Design (the classic shuffle aggregate):

 1. rows are split evenly across the mesh; each shard routes its rows to
    `owner(key) = murmurhash64(key) >> (64 - log2 P)` — the same
    high-bit ownership as the join shuffle, so a workload that joins and
    then aggregates on the same key reuses the placement;
 2. ONE `lax.all_to_all` per operand (keys, values) exchanges `[P, cap]`
    send grids;
 3. each shard runs the single-chip sort-based `ops.aggregate.
    hash_aggregate` (segmented scans, scatter-free) on the rows it owns.
    Ownership is disjoint, so there is NO second combine phase — shard
    results concatenate into the global group set;
 4. per-destination send histograms psum into the global load vector
    (`skew` = max/mean); static-cap overflow is detected and reported,
    never silently dropped (same contract as DistResult.overflow).

Padding keys travel as I64_MAX (sorts after every real key, so each
shard's sentinel group — if any — is its LAST group and is sliced off
by `shard_groups`); real keys must therefore be < I64_MAX. Pad rows are
spread round-robin so they cannot overload murmur(I64_MAX)'s owner.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ccve.ops.aggregate import GroupByResult, hash_aggregate
from ccve.parallel.distributed import AXIS, _owner_jnp

_SENTINEL = jnp.iinfo(jnp.int64).max


class DistAggResult(NamedTuple):
    """Global group-by result, laid out as P per-shard blocks of length
    `block_len` each: shard p's live groups occupy rows
    [p*block_len, p*block_len + shard_groups[p]). Keys are globally
    distinct (hash ownership is disjoint) and sorted within a block."""

    keys: jax.Array  # int64[P * block_len]
    count: jax.Array  # int64[P * block_len]
    sum: jax.Array  # int64[P * block_len]
    min: jax.Array  # int64[P * block_len]
    max: jax.Array  # int64[P * block_len]
    shard_groups: jax.Array  # int32[P]: live groups per block
    n_groups: jax.Array  # int32: total distinct keys
    block_len: int  # static per-shard block length
    skew: jax.Array  # float32: max/mean global partition load
    overflow: jax.Array  # bool: a send bucket exceeded cap (invalid)


def dist_aggregate(
    mesh: Mesh,
    keys: np.ndarray | jax.Array,
    values: np.ndarray | jax.Array,
    cap_slack: float = 2.0,
) -> DistAggResult:
    """Distributed count/sum/min/max group-by of `values` by `keys` over
    `mesh`. Rows are split evenly across devices and radix-shuffled to
    their key's owner; each owner aggregates locally (sort-based,
    scatter-free). `cap_slack` scales the static per-destination send
    capacity (expected uniform load × slack)."""
    n_parts = mesh.devices.size
    keys = jnp.asarray(keys, jnp.int64)
    values = jnp.asarray(values, jnp.int64)
    (n,) = keys.shape
    per_dev = -(-n // n_parts)
    pad = per_dev * n_parts - n
    if pad:
        keys = jnp.concatenate([keys, jnp.full(pad, _SENTINEL, jnp.int64)])
        values = jnp.concatenate([values, jnp.zeros(pad, jnp.int64)])
    cap = max(int(per_dev / n_parts * cap_slack) + 8, 16)
    cap = min(cap, per_dev)

    sharded = NamedSharding(mesh, P(AXIS))
    keys = jax.device_put(keys, sharded)
    values = jax.device_put(values, sharded)

    def spmd(keys_local, vals_local):  # [per_dev] each
        P_ = jax.lax.axis_size(AXIS)
        m = keys_local.shape[0]
        real = keys_local != _SENTINEL
        owner = _owner_jnp(keys_local, P_)
        rr = jnp.arange(m, dtype=jnp.int32) % P_
        owner = jnp.where(real, owner, rr)

        order = jnp.argsort(owner, stable=True)
        owner_sorted = jnp.take(owner, order)
        counts = jnp.zeros(P_, jnp.int32).at[owner].add(1)
        offs = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
        )
        pos = jnp.arange(m, dtype=jnp.int32) - jnp.take(offs, owner_sorted)
        over = jnp.any(counts > cap)
        safe_pos = jnp.where(pos < cap, pos, cap - 1)

        send_k = jnp.full((P_, cap), _SENTINEL, jnp.int64)
        send_k = send_k.at[owner_sorted, safe_pos].set(
            jnp.take(keys_local, order)
        )
        send_v = jnp.zeros((P_, cap), jnp.int64)
        send_v = send_v.at[owner_sorted, safe_pos].set(
            jnp.take(vals_local, order)
        )
        recv_k = jax.lax.all_to_all(send_k, AXIS, split_axis=0, concat_axis=0)
        recv_v = jax.lax.all_to_all(send_v, AXIS, split_axis=0, concat_axis=0)

        flat_k = recv_k.reshape(-1)
        res: GroupByResult = hash_aggregate(flat_k, recv_v.reshape(-1))
        # the sentinel sorts last -> if present it is group n_groups-1
        has_pad = jnp.any(flat_k == _SENTINEL)
        n_live = res.n_groups - has_pad.astype(jnp.int32)

        hist = (
            jnp.zeros(P_, jnp.int64)
            .at[owner]
            .add(real.astype(jnp.int64))
        )
        ghist = jax.lax.psum(hist, AXIS).astype(jnp.float32)
        skew = (ghist.max() / jnp.maximum(ghist.mean(), 1.0)).astype(
            jnp.float32
        )
        n_total = jax.lax.psum(n_live, AXIS)
        overflow = jax.lax.pmax(over.astype(jnp.int32), AXIS) > 0
        return (
            res.keys,
            res.count,
            res.sum,
            res.min,
            res.max,
            n_live[None],
            n_total,
            skew,
            overflow,
        )

    out_specs = (
        P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
        P(AXIS), P(), P(), P(),
    )
    f = jax.jit(
        jax.shard_map(
            spmd, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
            out_specs=out_specs,
        )
    )
    k, c, s, mn, mx, shard_groups, n_total, skew, overflow = f(keys, values)
    return DistAggResult(
        keys=k, count=c, sum=s, min=mn, max=mx,
        shard_groups=shard_groups, n_groups=n_total,
        block_len=n_parts * cap, skew=skew, overflow=overflow,
    )


def collect_groups(res: DistAggResult) -> np.ndarray:
    """Host-side: the live groups as int64[n_groups, 5] rows
    (key, count, sum, min, max), sorted by key — the canonical form for
    comparing against the single-chip `hash_aggregate` oracle."""
    k = np.asarray(res.keys)
    stats = [np.asarray(a) for a in (res.count, res.sum, res.min, res.max)]
    ng = np.asarray(res.shard_groups)
    L = res.block_len
    rows = []
    for p, g in enumerate(ng):
        lo, hi = p * L, p * L + int(g)
        rows.append(
            np.stack([k[lo:hi]] + [s[lo:hi] for s in stats], axis=1)
        )
    out = np.concatenate(rows, axis=0)
    return out[np.argsort(out[:, 0], kind="stable")]
