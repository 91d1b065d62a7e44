"""Chunk compaction — merging under-filled chunks into full ones.

A re-design of the reference's `NaiveCompactor`
(compactor.h:14-29, compactor.cpp:5-41). The reference mutates the
pipeline's chunk in place via `unique_ptr` swaps between a cached chunk and
a temp chunk; here the compactor is a pure function over an explicit state
pytree (the device-resident cache), so it jits and donates cleanly:

    emitted, new_state = compact(state, chunk, threshold)

Observable semantics (compactor.cpp:5-41, generalized with the threshold
axis that setting.h:17-29 names but the reference repo lacks):

 - count >= threshold        → pass through unchanged (the reference's
   NaiveCompactor uses threshold == block_size: only full chunks pass,
   compactor.cpp:6; BINARY uses block_size // 2; NONE uses 0 = everything
   passes; DYNAMIC gets the threshold from the bandit tuner).
 - else append into the cache (through the chunk's selection vector, dense);
   if it fits entirely, emit an empty chunk (compactor.cpp:12-20);
   on overflow, emit the now-full cache and keep the remainder as the new
   cache (the 3-way unique_ptr swap, compactor.cpp:22-37).
 - flush(state) hands back the partial cache at end-of-stream
   (compactor.h:23).

Everything is branch-free selects over static shapes, so one compiled
program serves every (occupancy, threshold) combination — the DYNAMIC
strategy's per-segment threshold is a traced scalar, not a recompile.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccve.core.chunk import Chunk, append_into, iota_sel


class CompactorState(NamedTuple):
    """The device-resident cached chunk (always dense: identity sel)."""

    cache_cols: jax.Array  # int64[n_cols, block]
    cache_count: jax.Array  # int32 scalar

    @property
    def block_size(self) -> int:
        return self.cache_cols.shape[1]


def init_state(n_cols: int, block_size: int) -> CompactorState:
    return CompactorState(
        cache_cols=jnp.zeros((n_cols, block_size), jnp.int64),
        cache_count=jnp.asarray(0, jnp.int32),
    )


def compact(
    state: CompactorState, chunk: Chunk, threshold,
    chunk_dense: bool = False,
) -> tuple[Chunk, CompactorState]:
    """One Compact step. `threshold` is a traced int scalar: chunks with
    count >= threshold pass through; smaller ones are absorbed into the
    cache, which is emitted whenever it fills. `chunk_dense` asserts the
    input's sel is the identity (the sorted executor's internal form) —
    the absorb skips its gather matmul.

    Returns (emitted_chunk, new_state). The emitted chunk is the input
    chunk itself on pass-through, a dense full cache on overflow, or an
    empty chunk when the input was swallowed.
    """
    block = chunk.block_size
    threshold = jnp.asarray(threshold, jnp.int32)
    # Full chunks always pass (compactor.cpp:6), regardless of threshold.
    passthrough = (chunk.count >= threshold) | (chunk.count >= block)

    # --- absorb path (computed unconditionally; selected at the end) -----
    new_cache, new_count, overflow, over_count = append_into(
        state.cache_cols, state.cache_count, chunk, src_dense=chunk_dense
    )
    emits_cache = new_count >= block  # cache filled exactly or split occurred
    # When the cache fills, emit it and keep the overflow as the new cache.
    # NOTE semantics match compactor.cpp:12-20: a chunk that lands the cache
    # exactly at block IS emitted (count <= capacity - cached means swallow;
    # equality fills the cache which then passes through next time). The
    # reference keeps a full cache until the *next* Compact call pushes it
    # out; emitting immediately yields the same multiset with one less copy.
    absorb_cols = jnp.where(emits_cache, new_cache, state.cache_cols)
    absorb_emit_count = jnp.where(emits_cache, jnp.minimum(new_count, block), 0)
    next_cache_cols = jnp.where(emits_cache, overflow, new_cache)
    next_cache_count = jnp.where(emits_cache, over_count, new_count)

    # --- select between pass-through and absorb ---------------------------
    emit_cols = jnp.where(passthrough, chunk.cols, absorb_cols)
    emit_sel = jnp.where(passthrough, chunk.sel, iota_sel(block))
    emit_count = jnp.where(passthrough, chunk.count, absorb_emit_count)
    out_cache_cols = jnp.where(passthrough, state.cache_cols, next_cache_cols)
    out_cache_count = jnp.where(passthrough, state.cache_count, next_cache_count)

    emitted = Chunk(emit_cols, emit_sel, emit_count.astype(jnp.int32))
    return emitted, CompactorState(out_cache_cols, out_cache_count.astype(jnp.int32))


def flush(state: CompactorState) -> tuple[Chunk, CompactorState]:
    """End-of-stream: emit the partial cache (compactor.h:23) and reset."""
    block = state.block_size
    emitted = Chunk(state.cache_cols, iota_sel(block), state.cache_count)
    fresh = CompactorState(
        cache_cols=jnp.zeros_like(state.cache_cols),
        cache_count=jnp.asarray(0, jnp.int32),
    )
    return emitted, fresh
