"""Hash aggregate — group-by over int64 keys.

North-star extension (BASELINE.json: "hash aggregate"; config 4 pairs it
with Zipf-skewed keys). No reference counterpart.

Design: instead of a pointer-chasing aggregation hash table,
grouping is a sort-based segment reduction — sort keys (XLA's bitonic /
radix-fused sort or ops/sort.radix_sort), find segment starts, and
`segment_sum`-style scatter-adds keyed by group id. All shapes static:
the output is padded to the input size with a `n_groups` valid count,
because the number of distinct keys is data-dependent.

For bounded key domains (`domain` given) it skips the sort entirely:
one scatter-add per aggregate into a dense `domain`-sized table — the
direct analogue of a perfect-hash aggregate, and the fastest path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GroupByResult(NamedTuple):
    keys: jax.Array  # int64[n]: group keys (garbage beyond n_groups)
    count: jax.Array  # int64[n]: rows per group
    sum: jax.Array  # int64[n]: sum of values per group
    min: jax.Array  # int64[n]
    max: jax.Array  # int64[n]
    n_groups: jax.Array  # int32 scalar


I64_MAX = jnp.iinfo(jnp.int64).max
I64_MIN = jnp.iinfo(jnp.int64).min


def _seg_scan(op, run_start, x):
    """Inclusive segmented scan: `op` restarts at each run start."""

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, op(va, vb))

    _, out = jax.lax.associative_scan(combine, (run_start, x))
    return out


@jax.jit
def hash_aggregate(keys: jax.Array, values: jax.Array) -> GroupByResult:
    """Sort-based group-by — scatter-free: the reduction runs as
    segmented SCANS over the sorted stream and the per-group results are
    compacted to the front with one more sort:

      1. sort (key, value) pairs;
      2. inclusive segmented count/sum/min/max scans (restart at run
         starts) — each run's LAST element carries the group's stats;
      3. one sort keyed by (is_run_end ? gid : n) compacts those run-end
         rows to positions 0..n_groups-1 in sorted-key order.
    """
    n = keys.shape[0]
    sk, sv = jax.lax.sort([keys, values], num_keys=1)
    # accumulate in int64 regardless of the value dtype (GroupByResult's
    # contract; the old scatter path accumulated into int64 tables)
    sv = sv.astype(jnp.int64)
    is_start = jnp.concatenate([jnp.ones(1, bool), sk[1:] != sk[:-1]])
    gid = jnp.cumsum(is_start.astype(jnp.int32)) - 1  # group id per row
    n_groups = gid[-1] + 1

    one = jnp.ones(n, jnp.int64)
    cnt_s = _seg_scan(jnp.add, is_start, one)
    sum_s = _seg_scan(jnp.add, is_start, sv)
    min_s = _seg_scan(jnp.minimum, is_start, sv)
    max_s = _seg_scan(jnp.maximum, is_start, sv)

    is_end = jnp.concatenate([is_start[1:], jnp.ones(1, bool)])
    ckey = jnp.where(is_end, gid, jnp.int32(n))  # run ends first, gid order
    _, out_keys, cnt, s, mn, mx = jax.lax.sort(
        [ckey, sk, cnt_s, sum_s, min_s, max_s], num_keys=1
    )
    lane = jnp.arange(n, dtype=jnp.int32)
    live = lane < n_groups
    return GroupByResult(
        keys=jnp.where(live, out_keys, 0),
        count=jnp.where(live, cnt, 0),
        sum=jnp.where(live, s, 0),
        min=jnp.where(live, mn, I64_MAX),
        max=jnp.where(live, mx, I64_MIN),
        n_groups=n_groups,
    )


def dense_aggregate(keys: jax.Array, values: jax.Array, domain: int) -> GroupByResult:
    """Perfect-hash aggregate for keys in [0, domain): one scatter-add per
    stat into a dense table; `keys[g] = g` for occupied groups."""
    cnt = jnp.zeros(domain, jnp.int64).at[keys].add(1, mode="drop")
    s = jnp.zeros(domain, jnp.int64).at[keys].add(values, mode="drop")
    mn = jnp.full(domain, I64_MAX, jnp.int64).at[keys].min(values, mode="drop")
    mx = jnp.full(domain, I64_MIN, jnp.int64).at[keys].max(values, mode="drop")
    occupied = cnt > 0
    return GroupByResult(
        keys=jnp.arange(domain, dtype=jnp.int64),
        count=cnt,
        sum=s,
        min=mn,
        max=mx,
        n_groups=jnp.sum(occupied.astype(jnp.int32)),
    )


def join_dense_aggregate(table, probe_keys: jax.Array, domain: int):
    """Aggregate pushdown through the join (eager aggregation): for a
    join probe(keys) ⋈ table followed by GROUP BY probe.key over the
    per-probe matched-payload sums, when the table's keys are UNIQUE and
    lie in [0, domain), every probe of key k carries the same value
    S_k = table payload of k — so the whole aggregate is algebra over
    the per-build-row probe counts bc (ops/sort_merge.sorted_build_counts):

      count[k] = bc[k]        sum[k] = bc[k] * S_k
      min[k] = max[k] = S_k where bc[k] > 0
      total matches = Σ bc

    Replaces the 4M-row scatter-based dense aggregate of config 4 with
    one domain-sized elementwise pass after the count-side join — the
    equivalent of pushing the aggregate below the probe loop
    (no reference counterpart; the reference materializes join output
    chunks, pipeline.cpp's result collection).

    Returns (GroupByResult over [0, domain), total_matches int64).
    Requires table.keys == arange(domain) (checked statically where
    possible); use `dense_aggregate` otherwise."""
    from ccve.ops.sort_merge import sorted_build_counts

    bc = sorted_build_counts(table, probe_keys).astype(jnp.int64)
    s_k = table.payloads
    occupied = bc > 0
    return (
        GroupByResult(
            keys=table.keys,
            count=bc,
            sum=bc * s_k,
            min=jnp.where(occupied, s_k, I64_MAX),
            max=jnp.where(occupied, s_k, I64_MIN),
            n_groups=jnp.sum(occupied.astype(jnp.int32)),
        ),
        jnp.sum(bc),
    )


def partition_histogram(keys: jax.Array, n_parts: int) -> jax.Array:
    """Per-partition key histogram (int64[n_parts]) — the skew-detection
    statistic for the distributed tier (owner = high hash bits, matching
    parallel/distributed.py)."""
    from ccve.parallel.distributed import _owner_jnp

    owner = _owner_jnp(keys, n_parts)
    return jnp.zeros(n_parts, jnp.int64).at[owner].add(1)
