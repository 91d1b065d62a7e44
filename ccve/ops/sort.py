"""Radix sort — multi-pass LSD counting sort on int64 keys.

North-star extension (BASELINE.json: "radix sort"). No reference
counterpart. Design: a least-significant-digit radix sort over
8-bit digits. Each pass is a stable counting sort with static shapes and
no data-dependent control flow:

 1. tile the key array into [n_tiles, tile];
 2. per-tile digit histogram + within-tile stable rank via a one-hot
    cumulative sum — computed a SEGMENT of tiles at a time under
    `lax.scan` so the one-hot working set stays ~seg_tiles*tile*256*4 B
    (64 MB at the defaults) instead of n*256*4;
 3. global digit base = exclusive scan of total digit counts; per-tile
    base = exclusive scan over tiles (digit-major, then tile-major — the
    standard parallel radix decomposition);
 4. one scatter of keys and permutation to final positions.

Keys are bias-mapped (sign bit flipped) so signed int64 order is
preserved. `radix_sort_pairs` carries a payload through the permutation;
`bits` < 64 skips passes for bounded key domains.

STATUS — parity/fallback component, NOT on any production path: the
engine's sorts are XLA's own (`jax.lax.sort`, `xla_sort_pairs` in this
module). Kept because BASELINE.json names radix sort: it is the correct, stable,
payload-carrying parity implementation and the oracle for the sort
tests; use it only where a bounded-domain stable multi-pass structure
is required verbatim.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS


def _to_biased(x: jax.Array) -> jax.Array:
    # flip the sign bit: signed order == unsigned order of biased keys
    return (x ^ jnp.int64(-0x8000000000000000)).astype(jnp.uint64)


def _radix_pass(keys_u, perm, shift: int, tile: int, seg_tiles: int):
    """One stable counting-sort pass on digit (keys_u >> shift) & 0xff."""
    n = keys_u.shape[0]
    n_tiles = n // tile
    n_segs = n_tiles // seg_tiles
    digits = ((keys_u >> jnp.uint64(shift)) & jnp.uint64(RADIX - 1)).astype(
        jnp.int32
    )
    dseg = digits.reshape(n_segs, seg_tiles, tile)

    def seg_fn(_, d):  # d: [seg_tiles, tile]
        onehot = jax.nn.one_hot(d, RADIX, dtype=jnp.int32)
        within = jnp.cumsum(onehot, axis=1) - onehot  # exclusive
        rank = jnp.take_along_axis(within, d[..., None], axis=2).squeeze(-1)
        hist = onehot.sum(axis=1)  # [seg_tiles, RADIX]
        return None, (rank, hist)

    _, (ranks, hists) = jax.lax.scan(seg_fn, None, dseg)
    rank_in_tile = ranks.reshape(n_tiles, tile)
    hist = hists.reshape(n_tiles, RADIX)

    total = hist.sum(axis=0)  # [RADIX]
    digit_base = jnp.cumsum(total) - total  # exclusive over digits
    tile_base = jnp.cumsum(hist, axis=0) - hist  # exclusive over tiles

    dt = digits.reshape(n_tiles, tile)
    pos = (
        jnp.take(digit_base, dt)
        + jnp.take_along_axis(tile_base, dt, axis=1)
        + rank_in_tile
    ).reshape(n)

    new_keys = jnp.zeros_like(keys_u).at[pos].set(keys_u)
    new_perm = jnp.zeros_like(perm).at[pos].set(perm)
    return new_keys, new_perm


@partial(jax.jit, static_argnums=(1, 2, 3))
def radix_argsort(
    keys: jax.Array, tile: int = 2048, bits: int = 64, seg_tiles: int = 32
) -> jax.Array:
    """Stable ascending argsort of int64 keys by LSD radix. `bits` bounds
    the significant key width (biased): use 64 for general int64; smaller
    for known-bounded non-negative domains (e.g. 32) to skip passes —
    note the sign-bias puts non-negative keys' bit 63 to 1, so bits<64
    requires all keys to share the same sign (checked by callers)."""
    n = keys.shape[0]
    group = tile * seg_tiles
    if n % group != 0:
        pad = group - n % group
        keys = jnp.concatenate(
            [keys, jnp.full(pad, jnp.iinfo(jnp.int64).max, jnp.int64)]
        )
    ku = _to_biased(keys)
    if bits < 64:
        # drop the common sign-bias bit pattern so low passes suffice
        ku = ku & jnp.uint64((1 << bits) - 1)
    perm = jnp.arange(ku.shape[0], dtype=jnp.int32)
    n_passes = -(-bits // RADIX_BITS)
    for p in range(n_passes):
        ku, perm = _radix_pass(ku, perm, p * RADIX_BITS, tile, seg_tiles)
    return perm[:n]


def radix_sort(keys: jax.Array, tile: int = 2048, bits: int = 64) -> jax.Array:
    return jnp.take(keys, radix_argsort(keys, tile, bits))


def radix_sort_pairs(
    keys: jax.Array, values: jax.Array, tile: int = 2048, bits: int = 64
):
    perm = radix_argsort(keys, tile, bits)
    return jnp.take(keys, perm), jnp.take(values, perm)


def xla_sort_pairs(keys: jax.Array, values: jax.Array):
    """XLA's built-in sort, for comparison benchmarks."""
    order = jnp.argsort(keys, stable=True)
    return jnp.take(keys, order), jnp.take(values, order)
