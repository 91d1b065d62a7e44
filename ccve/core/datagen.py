"""Deterministic workload generators, bit-matching the reference.

The reference's correctness story rests on determinism (SURVEY.md §4):

 - Probe table: `std::mt19937 gen(2)` + `std::uniform_int_distribution<>
   dist(0, kRHSTupleSize)`, drawn row-major (main.cpp:41-55).
 - Build (RHS) table: `num_unique = ceil(n_rhs / chunk_factor)` distinct
   keys, key_i = i * (n_rhs / num_unique), each repeated chunk_factor times,
   payload = row_index + 10_000_000 (chaining_ht.cpp:15-26,
   linear_probing_ht.cpp:14-25).
 - Micro-bench keys: glibc `rand()` (default seed 1) masked by
   `kRHSTuples * kHitFreq - 1` (simd_micro_bench.cpp:78-79).

This module reproduces all three bit-exactly in NumPy: a vectorized MT19937,
a port of libstdc++'s `uniform_int_distribution` rejection algorithm
(/usr/include/c++/*/bits/uniform_int_dist.h), and a port of glibc's TYPE_3
additive-feedback `rand()`. The native C++ library (ccve/native) provides
the same generators by calling the real std:: / libc implementations; tests
assert the two agree.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# MT19937 (vectorized per 624-word generation)
# ---------------------------------------------------------------------------

_MT_N = 624
_MT_M = 397
_MT_MATRIX_A = np.uint32(0x9908B0DF)
_MT_UPPER = np.uint32(0x80000000)
_MT_LOWER = np.uint32(0x7FFFFFFF)


class MT19937:
    """std::mt19937-compatible generator (32-bit outputs)."""

    def __init__(self, seed: int):
        state = np.zeros(_MT_N, dtype=np.uint32)
        state[0] = np.uint32(seed)
        for i in range(1, _MT_N):
            prev = state[i - 1]
            state[i] = np.uint32(
                (1812433253 * (int(prev) ^ (int(prev) >> 30)) + i) & 0xFFFFFFFF
            )
        self._state = state
        self._idx = _MT_N  # force twist on first draw

    def _twist(self) -> None:
        # In-place twist semantics: mt[i] = mt[(i+M)%N] ^ f(mt[i], mt[i+1]),
        # where for i >= N-M the (i+M)%N operand has already been updated in
        # this same pass, and the final element additionally reads the new
        # mt[0]. Vectorized in waves of stride N-M = 227.
        old = self._state
        new = old.copy()

        def f(a, b):
            y = (a & _MT_UPPER) | (b & _MT_LOWER)
            mag = np.where(
                (y & np.uint32(1)).astype(bool), _MT_MATRIX_A, np.uint32(0)
            )
            return (y >> np.uint32(1)) ^ mag

        k = _MT_N - _MT_M  # 227
        # wave 0: i in [0, k) uses untouched mt[i+M]
        new[:k] = old[_MT_M:] ^ f(old[:k], old[1 : k + 1])
        # waves 1..: i in [k, N-1) uses new[i-k]
        start = k
        while start < _MT_N - 1:
            stop = min(start + k, _MT_N - 1)
            new[start:stop] = new[start - k : stop - k] ^ f(
                old[start:stop], old[start + 1 : stop + 1]
            )
            start = stop
        # final element reads new mt[0] and new mt[M-1]
        new[_MT_N - 1] = new[_MT_M - 1] ^ f(
            old[_MT_N - 1 : _MT_N], new[0:1]
        )[0]
        self._state = new
        self._idx = 0

    def draw(self, n: int) -> np.ndarray:
        """Next n tempered 32-bit outputs as uint32[n]."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= _MT_N:
                self._twist()
            take = min(n - filled, _MT_N - self._idx)
            y = self._state[self._idx : self._idx + take].copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled : filled + take] = y
            self._idx += take
            filled += take
        return out


def uniform_int_stream(gen: MT19937, n: int, lo: int, hi: int) -> np.ndarray:
    """n draws of libstdc++ `uniform_int_distribution<int>(lo, hi)` fed by
    `gen`, bit-exact with g++/libstdc++ on LP64 (the reference platform).

    For a 32-bit generator libstdc++ >= 11 uses Lemire's nearly-divisionless
    downscaling (bits/uniform_int_dist.h `_S_nd`, per "Fast Random Integer
    Generation in an Interval", Lemire 2019):

        product = uint64(g()) * uint64(range)      # range = urange + 1
        accept iff uint32(product) >= (2^32 - range) % range
        value = product >> 32

    (A draw with low >= range is always accepted since threshold < range.)
    Vectorized here with ordered filtering; we only keep the first n accepted
    values, which is exactly the C++ output sequence.
    """
    urange = hi - lo
    assert 0 <= urange < 0xFFFFFFFF
    uerange = np.uint64(urange + 1)
    threshold = np.uint64(((1 << 32) - int(uerange)) % int(uerange))

    out = np.empty(n, dtype=np.int64)
    filled = 0
    while filled < n:
        need = n - filled
        batch = int(need * 1.01) + 64
        product = gen.draw(batch).astype(np.uint64) * uerange
        low = product & np.uint64(0xFFFFFFFF)
        accepted = (product >> np.uint64(32))[low >= threshold]
        take = min(need, accepted.shape[0])
        out[filled : filled + take] = accepted[:take].astype(np.int64) + lo
        filled += take
    return out


def gen_probe_table(
    n_rows: int, n_cols: int, rhs_size: int, use_native: bool = True
) -> np.ndarray:
    """The pipeline driver's probe table (main.cpp:41-55): int64[n_rows,
    n_cols] of uniform draws in [0, rhs_size] from mt19937(2), row-major.
    Uses the native C++ generator when available (bit-identical — tests
    assert agreement); the NumPy port is the fallback/oracle."""
    if use_native:
        from ccve import native

        lib = native.load()
        if lib is not None:
            import ctypes

            out = np.empty(n_rows * n_cols, dtype=np.int64)
            lib.ccve_gen_probe_table(
                n_rows,
                n_cols,
                rhs_size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            return out.reshape(n_rows, n_cols)
    gen = MT19937(2)
    flat = uniform_int_stream(gen, n_rows * n_cols, 0, rhs_size)
    return flat.reshape(n_rows, n_cols)


# ---------------------------------------------------------------------------
# RHS (build-side) table
# ---------------------------------------------------------------------------


def gen_rhs_table(n_rhs: int, chunk_factor: int) -> tuple[np.ndarray, np.ndarray]:
    """Build-side keys/payloads (chaining_ht.cpp:15-26): returns
    (keys int64[n_rhs], payloads int64[n_rhs]) in insertion order."""
    num_unique = n_rhs // chunk_factor + (1 if n_rhs % chunk_factor else 0)
    stride = n_rhs // num_unique
    reps = np.minimum(
        np.full(num_unique, chunk_factor, dtype=np.int64),
        n_rhs - np.arange(num_unique, dtype=np.int64) * chunk_factor,
    )
    reps = np.maximum(reps, 0)
    keys = np.repeat(np.arange(num_unique, dtype=np.int64) * stride, reps)[:n_rhs]
    payloads = np.arange(n_rhs, dtype=np.int64) + 10_000_000
    return keys, payloads


def gen_zipf_keys(
    n: int, domain: int, alpha: float = 1.1, seed: int = 7
) -> np.ndarray:
    """Zipf-skewed int64 keys in [0, domain) — BASELINE.json config 4's
    heavy-hitter workload (no reference counterpart). Rank r is drawn with
    probability ∝ 1/r^alpha via inverse-CDF sampling, then ranks are
    scattered over the domain with a fixed permutation so hot keys don't
    cluster in key space."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    pmf = ranks**-alpha
    cdf = np.cumsum(pmf)
    cdf /= cdf[-1]
    u = rng.random(n)
    r = np.searchsorted(cdf, u)  # 0-based rank
    perm = rng.permutation(domain)
    return perm[r].astype(np.int64)


# ---------------------------------------------------------------------------
# glibc rand() (TYPE_3 additive feedback) — micro-bench key stream
# ---------------------------------------------------------------------------


class GlibcRand:
    """glibc `rand()` with `srand(seed)` (default seed 1): 31-entry additive
    feedback generator r[i] = r[i-31] + r[i-3] (mod 2^32), output r[i] >> 1,
    with the standard 310-output warm-up discard."""

    def __init__(self, seed: int = 1):
        r = np.zeros(344, dtype=np.int64)
        r[0] = seed
        word = seed
        for i in range(1, 31):
            # word = (16807 * word) % 2147483647 via Schrage to avoid overflow
            hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        r = r.astype(np.uint32)
        buf = np.zeros(344, dtype=np.uint32)
        buf[:34] = r[:34]
        for i in range(34, 344):
            buf[i] = buf[i - 31] + buf[i - 3]
        self._hist = buf  # last 31 values end at index 343
        self._i = 344
        self._buf = buf

    def draw(self, n: int) -> np.ndarray:
        """Next n outputs as int64[n] (values in [0, 2^31))."""
        start = self._buf.shape[0]
        grown = np.zeros(start + n, dtype=np.uint32)
        grown[:start] = self._buf
        for i in range(start, start + n):
            grown[i] = grown[i - 31] + grown[i - 3]
        self._buf = grown
        return (grown[start:] >> np.uint32(1)).astype(np.int64)


def gen_microbench_keys(
    n_keys: int, rhs_tuples: int, hit_freq: int, use_native: bool = True
) -> np.ndarray:
    """Micro-bench probe keys (simd_micro_bench.cpp:78-79):
    rand() & (rhs_tuples * hit_freq - 1), glibc rand with default seed."""
    if use_native:
        from ccve import native

        lib = native.load()
        if lib is not None:
            import ctypes

            out = np.empty(n_keys, dtype=np.int64)
            lib.ccve_gen_microbench_keys(
                n_keys,
                rhs_tuples,
                hit_freq,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            return out
    mask = rhs_tuples * hit_freq - 1
    return GlibcRand(1).draw(n_keys) & mask
