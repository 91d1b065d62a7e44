"""64-bit murmur-style hash finalizer.

Bit-exact re-implementation of the reference's `murmurhash64`
(hash_functions.h:8-16): three rounds of `x ^= x >> 32; x *= M` with
M = 0xd6e8feb86659fd93 on uint64 with wrapping multiply. The 8-lane AVX-512
variant `mm512_murmurhash64` (hash_functions.h:18-28) computes the identical
function; under XLA the vectorization is XLA's job — one jnp definition
serves as both the "scalar" and the "SIMD" path.

Three implementations, all bit-identical:
 - murmurhash64:    jnp / traced (the device path)
 - murmurhash64_np: NumPy (host-side builds and oracles)
 - murmurhash64_py: pure-Python int (ground truth in tests)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MURMUR_MULTIPLIER = 0xD6E8FEB86659FD93


def murmurhash64(x: jnp.ndarray) -> jnp.ndarray:
    """Traced hash of an int64/uint64 array; returns uint64."""
    x = x.astype(jnp.uint64)
    m = jnp.uint64(MURMUR_MULTIPLIER)
    s = jnp.uint64(32)
    x ^= x >> s
    x *= m
    x ^= x >> s
    x *= m
    x ^= x >> s
    return x


def murmurhash64_np(x: np.ndarray) -> np.ndarray:
    """NumPy hash of an int64/uint64 array; returns uint64."""
    x = np.asarray(x).astype(np.uint64)
    m = np.uint64(MURMUR_MULTIPLIER)
    s = np.uint64(32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> s)
        x = x * m
        x = x ^ (x >> s)
        x = x * m
        x = x ^ (x >> s)
    return x


def murmurhash64_py(x: int) -> int:
    """Pure-Python hash of one value (ground truth)."""
    mask = (1 << 64) - 1
    x &= mask
    x ^= x >> 32
    x = (x * MURMUR_MULTIPLIER) & mask
    x ^= x >> 32
    x = (x * MURMUR_MULTIPLIER) & mask
    x ^= x >> 32
    return x
