"""Columnar chunk with a selection vector — the engine's L1 data model.

A re-design of the reference's `Vector`/`DataChunk`
(base.h:59-100): a chunk is a fixed-shape pytree

    cols : int64[n_cols, block]   column storage (block is the minor,
                                  lane-tiled dimension)
    sel  : int32[block]           selection vector: sel[i] is the storage row
                                  of the i-th live tuple (identity on reset,
                                  base.h:96-99)
    count: int32 scalar           number of live tuples (carried as a traced
                                  scalar, never a Python int, so one compiled
                                  program serves every occupancy)

Shapes are static everywhere; variable row counts are expressed through
(sel, count) masking. The reference's zero-copy `Slice` (base.cpp:37-47) —
reference the parent's columns and *compose* selection vectors — maps to
`slice_compose`, a pure gather: sel'[i] = parent_sel[result_vector[i]].
`SIMDSlice`'s 16-lane `_mm512_i32gather_epi32` (base.cpp:49-68) is the same
gather; under XLA the lane-parallelism is XLA's job.

`Append` (base.cpp:15-27) — copy *through* the source's selection vector into
dense positions — maps to `append_into`, a masked scatter at a dynamic
offset. This (mask → target positions → scatter) is the engine's stream-
compaction primitive, replacing AVX-512 `compressstoreu`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


SEL_DTYPE = jnp.int32
COL_DTYPE = jnp.int64


class Chunk(NamedTuple):
    cols: jax.Array  # int64[n_cols, block]
    sel: jax.Array  # int32[block]
    count: jax.Array  # int32 scalar

    @property
    def n_cols(self) -> int:
        return self.cols.shape[0]

    @property
    def block_size(self) -> int:
        return self.cols.shape[1]


def gather_clip(vals: jax.Array, idx: jax.Array) -> jax.Array:
    """out[..., i] = vals[..., clamp(idx[i])] — the engine's gather
    (jnp.take along the last axis, clip semantics)."""
    return jnp.take(vals, idx, axis=-1, mode="clip")


def scatter_drop(dst: jax.Array, pos: jax.Array, vals: jax.Array) -> jax.Array:
    """dst.at[..., pos].set(vals), out-of-range positions dropped — the
    engine's scatter. In-range positions must be unique, or carry equal
    values (all call sites scatter through a selection vector or a
    prefix-sum rank)."""
    return dst.at[..., pos].set(vals, mode="drop")


def iota_sel(block_size: int) -> jax.Array:
    return jnp.arange(block_size, dtype=SEL_DTYPE)


def make_dense(cols: jax.Array, count=None) -> Chunk:
    """Chunk whose selection vector is the identity (a freshly Reset chunk,
    base.h:96-99)."""
    block = cols.shape[1]
    if count is None:
        count = block
    return Chunk(
        cols=cols.astype(COL_DTYPE),
        sel=iota_sel(block),
        count=jnp.asarray(count, jnp.int32),
    )


def empty(n_cols: int, block_size: int) -> Chunk:
    return Chunk(
        cols=jnp.zeros((n_cols, block_size), COL_DTYPE),
        sel=iota_sel(block_size),
        count=jnp.asarray(0, jnp.int32),
    )


def reset(chunk: Chunk) -> Chunk:
    """DataChunk::Reset (base.h:96-99): identity sel, zero count. Storage is
    left as-is, same as the reference."""
    return Chunk(chunk.cols, iota_sel(chunk.block_size), jnp.asarray(0, jnp.int32))


def valid_mask(chunk: Chunk) -> jax.Array:
    """bool[block]: True for live positions i < count."""
    return iota_sel(chunk.block_size) < chunk.count


def slice_compose(
    parent: Chunk, result_vector: jax.Array, result_count: jax.Array
) -> Chunk:
    """DataChunk::Slice (base.cpp:37-47): share the parent's column storage,
    compose selection vectors: sel'[i] = parent.sel[result_vector[i]].

    Positions >= result_count hold garbage (as in the reference) and are
    masked by `count`.
    """
    new_sel = gather_clip(parent.sel, result_vector.astype(SEL_DTYPE))
    return Chunk(parent.cols, new_sel, jnp.asarray(result_count, jnp.int32))


def gather_rows(chunk: Chunk) -> jax.Array:
    """Materialize live rows densely: out[:, i] = cols[:, sel[i]] for
    i < count; positions >= count are zeroed. Returns int64[n_cols, block]."""
    dense = gather_clip(chunk.cols, chunk.sel)
    return jnp.where(valid_mask(chunk)[None, :], dense, jnp.int64(0))


def compact_rows(
    cols: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Fused stream compaction to a DENSE layout: one masked scatter
    (out[:, rank(j)] = cols[:, j] for mask[j]) instead of
    compress_indices + a later gather through the selection vector.
    Returns
    (dense_cols, count); storage beyond count is zero."""
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(SEL_DTYPE)) - 1
    count = jnp.sum(mask.astype(SEL_DTYPE)).astype(SEL_DTYPE)
    scatter_pos = jnp.where(mask, pos, n)
    dense = scatter_drop(jnp.zeros_like(cols), scatter_pos, cols)
    return dense, count


def append_into(
    dst_cols: jax.Array, dst_count: jax.Array, src: Chunk, limit=None,
    src_dense: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """DataChunk::Append generalized with overflow split (base.cpp:15-27 +
    the compactor's two-destination append, compactor.cpp:22-24).

    Scatters the first min(src.count, limit) live rows of `src` (read through
    its selection vector) into `dst_cols` starting at row dst_count; rows
    that would exceed the block wrap into a fresh overflow buffer starting at
    row 0.

    Returns (new_dst_cols, new_dst_count, overflow_cols, overflow_count)
    where new_dst_count is capped at block and overflow_count is the number
    of wrapped rows. All shapes static.
    """
    block = src.block_size
    n = src.count if limit is None else jnp.minimum(src.count, limit)
    idx = iota_sel(block)
    live = idx < n

    # Dense gather of the live source rows (through sel); a src known
    # dense (identity sel — the sorted executor's internal form) skips
    # the gather: dead-lane values are dropped by the scatter positions
    # below.
    dense = src.cols if src_dense else gather_clip(src.cols, src.sel)

    target = idx + dst_count  # would-be destination rows
    in_main = live & (target < block)
    in_over = live & (target >= block)

    # Scatter into main: dead lanes are routed to row `block` (dropped).
    main_pos = jnp.where(in_main, target, block)
    new_dst = scatter_drop(dst_cols, main_pos, dense)

    over_pos = jnp.where(in_over, target - block, block)
    overflow = scatter_drop(jnp.zeros_like(dst_cols), over_pos, dense)

    total = dst_count + n
    new_dst_count = jnp.minimum(total, block)
    over_count = jnp.maximum(total - block, 0)
    return new_dst, new_dst_count, overflow, over_count


def compress_indices(mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Stream compaction of a boolean mask — the replacement for
    `_mm256_mask_compressstoreu_epi32` (chaining_ht.cpp:248 et al.).

    Returns (result_vector, count): result_vector[j] = the j-th set index of
    `mask` for j < count, garbage (clamped) above. Implemented as masked
    prefix-sum + scatter, fully lane-parallel.
    """
    n = mask.shape[0]
    idx = jnp.arange(n, dtype=SEL_DTYPE)
    pos = jnp.cumsum(mask.astype(SEL_DTYPE)) - 1  # target position per set lane
    # NB: jnp.sum promotes int32 -> int64 under x64; counts are int32 by
    # contract everywhere (ScanState, Chunk.count).
    count = jnp.sum(mask.astype(SEL_DTYPE)).astype(SEL_DTYPE)
    scatter_pos = jnp.where(mask, pos, n)
    result = scatter_drop(jnp.zeros((n,), SEL_DTYPE), scatter_pos, idx)
    return result, count


# ---------------------------------------------------------------------------
# Host-side helpers (tests / result collection)
# ---------------------------------------------------------------------------


def to_rows(chunk: Chunk) -> np.ndarray:
    """Live tuples as an int64[count, n_cols] NumPy array (row-major), read
    through the selection vector — the observable content of a chunk."""
    cols = np.asarray(chunk.cols)
    sel = np.asarray(chunk.sel)
    count = int(chunk.count)
    return cols[:, sel[:count]].T.copy()


def from_rows(rows: np.ndarray, block_size: int) -> Chunk:
    """Build a dense chunk from int64[count, n_cols] host rows (count <=
    block_size); storage above count is zero-padded."""
    rows = np.asarray(rows, dtype=np.int64)
    count, n_cols = rows.shape
    if count > block_size:
        raise ValueError(f"{count} rows > block_size {block_size}")
    cols = np.zeros((n_cols, block_size), dtype=np.int64)
    cols[:, :count] = rows.T
    return make_dense(jnp.asarray(cols), count)
