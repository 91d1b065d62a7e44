"""Hash bit-exactness: jnp / NumPy / native-C++ / pure-Python must agree
(the reference function is hash_functions.h:8-16)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ccve.ops.hashing import murmurhash64, murmurhash64_np, murmurhash64_py
from ccve import native

SAMPLES = np.array(
    [0, 1, 2, 3, 255, 256, 2**31 - 1, 2**32, 2**40 + 12345,
     0xD6E8FEB86659FD93 % 2**63, 2**63 - 1],
    dtype=np.int64,
)


def test_jnp_matches_python():
    got = np.asarray(murmurhash64(jnp.asarray(SAMPLES)))
    want = np.array([murmurhash64_py(int(v)) for v in SAMPLES], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_numpy_matches_python():
    got = murmurhash64_np(SAMPLES)
    want = np.array([murmurhash64_py(int(v)) for v in SAMPLES], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_large_random_jnp_vs_numpy():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 2**63 - 1, size=10_000, dtype=np.int64)
    np.testing.assert_array_equal(
        np.asarray(murmurhash64(jnp.asarray(xs))), murmurhash64_np(xs)
    )


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_matches_python():
    import ctypes

    lib = native.load()
    out = np.zeros(SAMPLES.shape[0], dtype=np.uint64)
    lib.ccve_murmurhash64(
        SAMPLES.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        SAMPLES.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    want = np.array([murmurhash64_py(int(v)) for v in SAMPLES], dtype=np.uint64)
    np.testing.assert_array_equal(out, want)
