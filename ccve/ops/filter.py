"""Filter operator — a selection-vector producer.

No direct reference counterpart (the reference pipeline has only joins),
but mandated by BASELINE.json's north star ("filter") and config 2
("selective filter (sel ≈ 10%) exercising full vs dynamic chunk
compaction"). A filter is the canonical producer of under-filled chunks:
it evaluates a predicate over a chunk's live rows and *composes* the
selection vector down to the passing rows — zero data movement, exactly
like the reference's Slice (base.cpp:37-47). The under-filled output is
what the downstream compactor (ops/compactor.py) exists to fix.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ccve.core.chunk import Chunk, compress_indices, slice_compose


def filter_chunk(chunk: Chunk, predicate: Callable[[jax.Array], jax.Array], col: int) -> Chunk:
    """Keep live rows where `predicate(cols[col][row])` holds. Returns a
    zero-copy sliced chunk (composed selection vector)."""
    block = chunk.block_size
    gathered = jnp.take(chunk.cols[col], chunk.sel)  # live rows in sel order
    live = jnp.arange(block, dtype=jnp.int32) < chunk.count
    keep = live & predicate(gathered)
    # keep is in sel-order positions; compress then compose through sel
    result_vector, count = compress_indices(keep)
    return slice_compose(chunk, result_vector, count)


def filter_mask(values: jax.Array, predicate: Callable[[jax.Array], jax.Array]) -> jax.Array:
    """Bulk-executor form: boolean mask over a whole column."""
    return predicate(values)


# Common predicates (int64 columns)
def lt(c):
    return lambda x: x < c


def le(c):
    return lambda x: x <= c


def gt(c):
    return lambda x: x > c


def ge(c):
    return lambda x: x >= c


def eq(c):
    return lambda x: x == c


def between(lo, hi):
    """lo <= x < hi"""
    return lambda x: (x >= lo) & (x < hi)


def mod_eq(m, r):
    """x % m == r — handy for deterministic selectivity in benchmarks."""
    return lambda x: x % m == r
