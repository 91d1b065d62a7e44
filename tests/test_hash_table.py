"""Hash-table build + probe paths vs the scalar oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from ccve.core.chunk import iota_sel
from ccve.core.datagen import gen_rhs_table
from ccve.exec.oracle import OracleBuildTable, oracle_join, sort_rows
from ccve.ops.hash_table import (
    build_csr,
    build_csr_device,
    build_lp,
    csr_expand_grid,
    csr_probe,
    lp_expand_grid,
    lp_probe,
    scan_next,
)


def _expected_pairs(probe_keys, build_keys, build_payloads):
    b = OracleBuildTable(build_keys, build_payloads)
    rows = oracle_join(
        probe_keys.reshape(-1, 1), 0, b, payload_mode=__import__(
            "ccve.config", fromlist=["PayloadMode"]
        ).PayloadMode.FULL,
    )
    # (probe_key, matched_key, payload)
    return sort_rows(rows)


@pytest.mark.parametrize("builder,expander", [
    (build_lp, lp_expand_grid),
    (build_csr, csr_expand_grid),
])
@pytest.mark.parametrize("chunk_factor", [1, 3])
def test_expand_grid_matches_oracle(builder, expander, chunk_factor):
    n_rhs = 64
    keys, payloads = gen_rhs_table(n_rhs, chunk_factor)
    table = builder(keys, payloads)
    rng = np.random.default_rng(0)
    probe = rng.integers(0, keys.max() + 2, size=200).astype(np.int64)

    grid = expander(table, jnp.asarray(probe))
    m = np.asarray(grid.match)
    gk = np.asarray(grid.keys)
    gp = np.asarray(grid.payloads)
    got = []
    for i in range(probe.shape[0]):
        for j in range(m.shape[1]):
            if m[i, j]:
                got.append((probe[i], gk[i, j], gp[i, j]))
    got = np.array(sorted(got), dtype=np.int64).reshape(-1, 3)
    exp = _expected_pairs(probe, keys, payloads)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("builder,prober", [
    (build_lp, lp_probe),
    (build_csr, csr_probe),
])
@pytest.mark.parametrize("chunk_factor", [1, 4])
def test_scan_drain_matches_oracle(builder, prober, chunk_factor):
    """probe + scan_next drained to exhaustion == oracle match multiset
    (the `while (ss.HasNext())` loop, main.cpp:150-161)."""
    n_rhs = 48
    block = 128
    keys, payloads = gen_rhs_table(n_rhs, chunk_factor)
    table = builder(keys, payloads)
    rng = np.random.default_rng(1)
    probe = rng.integers(0, keys.max() + 2, size=block).astype(np.int64)
    count = 100  # only first 100 rows live

    jkeys = jnp.asarray(probe)
    state = prober(table, jkeys, iota_sel(block), jnp.asarray(count))
    got = []
    for _ in range(10_000):
        if int(state.count) == 0:
            break
        res = scan_next(table, jkeys, state)
        rc = int(res.result_count)
        rv = np.asarray(res.result_vector)[:rc]
        mk = np.asarray(res.matched_keys)[:rc]
        mp = np.asarray(res.matched_payloads)[:rc]
        for r, k, p in zip(rv, mk, mp):
            got.append((probe[r], k, p))
        state = res.state
    else:
        pytest.fail("scan did not drain")

    got = np.array(sorted(got), dtype=np.int64).reshape(-1, 3)
    exp = _expected_pairs(probe[:count], keys, payloads)
    np.testing.assert_array_equal(got, exp)


def test_device_csr_build_matches_host():
    keys, payloads = gen_rhs_table(100, 2)
    host = build_csr(keys, payloads)
    dev = build_csr_device(
        jnp.asarray(keys), jnp.asarray(payloads), host.n_buckets, host.max_len
    )
    np.testing.assert_array_equal(np.asarray(host.offsets), np.asarray(dev.offsets))
    # within-bucket order must match (stable by insertion)
    np.testing.assert_array_equal(
        np.asarray(host.entry_keys), np.asarray(dev.entry_keys)
    )
    np.testing.assert_array_equal(
        np.asarray(host.entry_payloads), np.asarray(dev.entry_payloads)
    )


def test_lp_duplicate_keys_probe():
    """Duplicate build keys occupy consecutive-ish slots; the LP drain must
    emit one row per duplicate (linear_probing_ht semantics)."""
    keys = np.array([7, 7, 7, 9, 9, 1], dtype=np.int64)
    payloads = np.arange(6, dtype=np.int64)
    table = build_lp(keys, payloads)
    probe = np.array([7, 9, 1, 4], dtype=np.int64)
    grid = lp_expand_grid(table, jnp.asarray(probe))
    counts = np.asarray(grid.match).sum(axis=1)
    np.testing.assert_array_equal(counts, [3, 2, 1, 0])
