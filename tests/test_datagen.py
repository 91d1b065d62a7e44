"""Generator parity: the NumPy ports must bit-match the native C++ library
(which calls the exact std::mt19937 / uniform_int_distribution / glibc rand
the reference uses: main.cpp:41-55, simd_micro_bench.cpp:78-79)."""

import ctypes

import numpy as np
import pytest

from ccve import native
from ccve.core import datagen

needs_native = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def test_mt19937_known_values():
    # std::mt19937 with seed 5489 (default): 10000th draw is 4123659995
    # (the canonical MT19937 check value).
    gen = datagen.MT19937(5489)
    draws = gen.draw(10_000)
    assert int(draws[-1]) == 4123659995


@needs_native
def test_probe_table_matches_native():
    n_rows, n_cols, rhs = 10_000, 3, 2_000_000
    ours = datagen.gen_probe_table(n_rows, n_cols, rhs, use_native=False)
    theirs = np.zeros(n_rows * n_cols, dtype=np.int64)
    native.load().ccve_gen_probe_table(n_rows, n_cols, rhs, _p64(theirs))
    np.testing.assert_array_equal(ours.ravel(), theirs)


@needs_native
@pytest.mark.parametrize("chunk_factor", [1, 2, 5, 7])
def test_rhs_table_matches_native(chunk_factor):
    n_rhs = 10_007
    keys, payloads = datagen.gen_rhs_table(n_rhs, chunk_factor)
    k2 = np.zeros(n_rhs, dtype=np.int64)
    p2 = np.zeros(n_rhs, dtype=np.int64)
    native.load().ccve_gen_rhs_table(n_rhs, chunk_factor, _p64(k2), _p64(p2))
    np.testing.assert_array_equal(keys, k2)
    np.testing.assert_array_equal(payloads, p2)


@needs_native
def test_microbench_keys_match_native():
    n, rhs_tuples, hit_freq = 50_000, 128, 2
    ours = datagen.gen_microbench_keys(n, rhs_tuples, hit_freq, use_native=False)
    theirs = np.zeros(n, dtype=np.int64)
    native.load().ccve_gen_microbench_keys(n, rhs_tuples, hit_freq, _p64(theirs))
    np.testing.assert_array_equal(ours, theirs)


def test_rhs_table_structure():
    keys, payloads = datagen.gen_rhs_table(100, 4)
    # 25 unique values, stride 100//25 = 4, each repeated 4x
    assert len(np.unique(keys)) == 25
    np.testing.assert_array_equal(np.unique(keys), np.arange(25) * 4)
    np.testing.assert_array_equal(payloads, np.arange(100) + 10_000_000)


@needs_native
def test_native_chunk_feeder_matches_numpy():
    """ccve_make_chunk_batch == pad + reshape + transpose (the pipelined
    executor's host IO hot loop)."""
    import ctypes

    rows = np.arange(61 * 3, dtype=np.int64).reshape(61, 3)
    block, seg_start, seg_chunks = 8, 2, 7  # covers rows 16..72 (padded)
    out = np.empty(seg_chunks * 3 * block, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    native.load().ccve_make_chunk_batch(
        rows.ctypes.data_as(p64), 61, 3, block, seg_start, seg_chunks,
        out.ctypes.data_as(p64),
    )
    got = out.reshape(seg_chunks, 3, block)
    exp = np.zeros((seg_chunks, 3, block), np.int64)
    for c in range(seg_chunks):
        seg = rows[(seg_start + c) * block : (seg_start + c + 1) * block]
        exp[c, :, : seg.shape[0]] = seg.T
    np.testing.assert_array_equal(got, exp)
