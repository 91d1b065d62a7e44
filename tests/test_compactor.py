"""Compactor semantics (compactor.cpp:5-41 + threshold generalization)."""

import jax.numpy as jnp
import numpy as np

from ccve.core.chunk import Chunk, from_rows, to_rows
from ccve.ops import compactor as comp

BLOCK = 128


def _chunk(values, count=None, block=BLOCK):
    rows = np.asarray(values, dtype=np.int64).reshape(-1, 1)
    c = from_rows(rows, block)
    if count is not None:
        c = Chunk(c.cols, c.sel, jnp.asarray(count, jnp.int32))
    return c


def _drain(state, chunks, threshold):
    emitted = []
    for c in chunks:
        e, state = comp.compact(state, c, threshold)
        if int(e.count):
            emitted.append(to_rows(e))
    f, state = comp.flush(state)
    if int(f.count):
        emitted.append(to_rows(f))
    return emitted, state


def test_full_compaction_merges_small_chunks():
    state = comp.init_state(1, BLOCK)
    chunks = [_chunk(np.arange(i * 50, i * 50 + 50)) for i in range(5)]  # 5x50
    emitted, _ = _drain(state, chunks, threshold=BLOCK)
    sizes = [e.shape[0] for e in emitted]
    assert sizes == [BLOCK, BLOCK - 6]  # 250 = 128 + 122
    got = np.concatenate(emitted)[:, 0]
    np.testing.assert_array_equal(np.sort(got), np.arange(250))


def test_full_chunk_passes_through():
    state = comp.init_state(1, BLOCK)
    full = _chunk(np.arange(BLOCK))
    e, state2 = comp.compact(state, full, jnp.asarray(BLOCK))
    assert int(e.count) == BLOCK
    assert int(state2.cache_count) == 0


def test_exact_fill_emits_full_cache():
    state = comp.init_state(1, BLOCK)
    a = _chunk(np.arange(100))
    b = _chunk(np.arange(100, 128))
    e1, state = comp.compact(state, a, jnp.asarray(BLOCK))
    assert int(e1.count) == 0
    e2, state = comp.compact(state, b, jnp.asarray(BLOCK))
    assert int(e2.count) == BLOCK
    assert int(state.cache_count) == 0
    np.testing.assert_array_equal(np.sort(to_rows(e2)[:, 0]), np.arange(128))


def test_overflow_split():
    state = comp.init_state(1, BLOCK)
    e1, state = comp.compact(state, _chunk(np.arange(100)), jnp.asarray(BLOCK))
    e2, state = comp.compact(
        state, _chunk(np.arange(100, 200)), jnp.asarray(BLOCK)
    )
    assert int(e1.count) == 0
    assert int(e2.count) == BLOCK
    assert int(state.cache_count) == 72  # 200 - 128
    f, _ = comp.flush(state)
    merged = np.concatenate([to_rows(e2)[:, 0], to_rows(f)[:, 0]])
    np.testing.assert_array_equal(np.sort(merged), np.arange(200))


def test_threshold_passthrough():
    """count >= threshold flows through untouched (BINARY/DYNAMIC axis)."""
    state = comp.init_state(1, BLOCK)
    half = _chunk(np.arange(70))  # 70 >= 64 -> pass
    e, state2 = comp.compact(state, half, jnp.asarray(BLOCK // 2))
    assert int(e.count) == 70
    assert int(state2.cache_count) == 0
    small = _chunk(np.arange(10))  # 10 < 64 -> absorbed
    e, state3 = comp.compact(state2, small, jnp.asarray(BLOCK // 2))
    assert int(e.count) == 0
    assert int(state3.cache_count) == 10


def test_threshold_zero_is_none():
    state = comp.init_state(1, BLOCK)
    tiny = _chunk(np.arange(3))
    e, state2 = comp.compact(state, tiny, jnp.asarray(0))
    assert int(e.count) == 3
    assert int(state2.cache_count) == 0


def test_respects_selection_vector():
    """Absorb reads through the source chunk's selection vector."""
    state = comp.init_state(1, BLOCK)
    base = from_rows(np.arange(BLOCK, dtype=np.int64).reshape(-1, 1), BLOCK)
    sel = jnp.asarray(np.array([5, 9, 33], dtype=np.int32).repeat(1))
    sel = jnp.zeros(BLOCK, jnp.int32).at[:3].set(sel)
    sparse = Chunk(base.cols, sel, jnp.asarray(3, jnp.int32))
    e, state2 = comp.compact(state, sparse, jnp.asarray(BLOCK))
    assert int(e.count) == 0
    f, _ = comp.flush(state2)
    np.testing.assert_array_equal(to_rows(f)[:, 0], [5, 9, 33])
