"""Card-only checks: what the GPU could do differently from the CPU
backend the rest of the suite runs on — 64-bit integers on the device,
scatter/gather edge semantics, sort stability, and the exactness of every
sort-merge route at a size where the GPU's own sort and scan kernels are
used. Each test compares with NumPy. Run on the card by
`python chip_smoke.py`; skipped elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccve.core.chunk import gather_clip, scatter_drop
from ccve.ops.sort_merge import (
    build_sorted,
    sorted_build_counts,
    sorted_expand,
    sorted_match_stats,
    sorted_match_totals,
)

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]

I64 = np.iinfo(np.int64)


def test_card_int64_on_device(card):
    x = jax.device_put(jnp.asarray([I64.max - 1, I64.min + 1], jnp.int64),
                       card)
    y = np.asarray(x + jnp.int64(1))
    assert y.dtype == np.int64
    assert y.tolist() == [I64.max, I64.min + 2]


def test_card_gather_clip_and_scatter_drop(card):
    rng = np.random.default_rng(0)
    vals = rng.integers(I64.min, I64.max, (3, 5000), dtype=np.int64)
    idx = rng.integers(-100, 5100, 2048).astype(np.int32)
    got = np.asarray(gather_clip(jnp.asarray(vals), jnp.asarray(idx)))
    assert np.array_equal(got, vals[:, np.clip(idx, 0, 4999)])

    dst = np.zeros((3, 2048), np.int64)
    pos = rng.permutation(4096)[:2048].astype(np.int32)  # half dropped
    src = rng.integers(I64.min, I64.max, (3, 2048), dtype=np.int64)
    got = np.asarray(scatter_drop(jnp.asarray(dst), jnp.asarray(pos),
                                  jnp.asarray(src)))
    want = dst.copy()
    keep = pos < 2048
    want[:, pos[keep]] = src[:, keep]
    assert np.array_equal(got, want)


def test_card_stable_sort_keeps_build_first(card):
    """The stats path relies on a stable sort: equal keys keep concat
    order (builds before probes)."""
    rng = np.random.default_rng(1)
    k = rng.integers(0, 1000, 1 << 20).astype(np.int64)
    v = np.arange(k.size, dtype=np.int32)
    sk, sv = jax.lax.sort([jnp.asarray(k), jnp.asarray(v)], num_keys=1,
                          is_stable=True)
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(sk), k[order])
    assert np.array_equal(np.asarray(sv), v[order])


def _setup(span, n=1 << 22, m=1 << 18, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-span, span, m, dtype=np.int64)
    keys[: m // 4] = keys[m // 4 : m // 2]  # duplicate runs
    payloads = rng.integers(-(2**40), 2**40, m, dtype=np.int64)
    probe = np.concatenate([
        rng.choice(keys, n // 2),
        rng.integers(-2 * span, 2 * span, n - n // 2 - 2, dtype=np.int64),
        [I64.min, I64.max],
    ])
    rng.shuffle(probe)
    order = np.argsort(keys, kind="stable")
    sk, sp = keys[order], payloads[order]
    lo = np.searchsorted(sk, probe, "left")
    hi = np.searchsorted(sk, probe, "right")
    cp = np.concatenate([[0], np.cumsum(sp)])
    return build_sorted(keys, payloads), probe, sk, hi - lo, cp[hi] - cp[lo]


@pytest.mark.parametrize("span", [1 << 20, 1 << 40, 1 << 62])
def test_card_count_side_routes_exact(card, span):
    table, probe, sk, mult, psum = _setup(span)
    p = jax.device_put(jnp.asarray(probe), card)
    c, chk = jax.jit(lambda q: sorted_match_totals(table, q))(p)
    assert int(c) == int(mult.sum()) and int(chk) == int(psum.sum())
    sp = np.sort(probe)
    want_bc = np.searchsorted(sp, sk, "right") - np.searchsorted(sp, sk, "left")
    bc = jax.jit(lambda q: sorted_build_counts(table, q))(p)
    assert np.array_equal(np.asarray(bc), want_bc)


def test_card_stats_and_expand_exact(card):
    table, probe, _, mult, psum = _setup(1 << 40, n=1 << 21, seed=3)
    p = jax.device_put(jnp.asarray(probe), card)
    st = jax.jit(lambda q: sorted_match_stats(table, q, allow_negative=True))(p)
    assert np.array_equal(np.asarray(st.mult), mult)
    assert np.array_equal(np.asarray(st.psum), psum)
    cap = probe.size * table.max_mult
    rows, _, pays, total = jax.jit(
        lambda q: sorted_expand(table, q, cap))(p)
    rows = np.asarray(rows)
    assert int(total) == int(mult.sum()) == int((rows >= 0).sum())
    assert np.array_equal(np.bincount(rows[rows >= 0], minlength=probe.size),
                          mult)
    assert int(np.asarray(pays).sum()) == int(psum.sum())
