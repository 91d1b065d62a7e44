"""Distributed hash aggregate on the virtual 8-device CPU mesh — exact
group-set parity with the single-chip sort-based aggregate."""

import numpy as np
import pytest

from ccve.core.datagen import gen_zipf_keys
from ccve.ops.aggregate import hash_aggregate
from ccve.parallel.dist_aggregate import collect_groups, dist_aggregate
from ccve.parallel.distributed import make_join_mesh


def _oracle_rows(keys, values):
    res = hash_aggregate(keys, values)
    ng = int(res.n_groups)
    out = np.stack(
        [
            np.asarray(a)[:ng]
            for a in (res.keys, res.count, res.sum, res.min, res.max)
        ],
        axis=1,
    )
    return out[np.argsort(out[:, 0], kind="stable")]


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dist_aggregate_matches_single_chip(n_devices):
    mesh = make_join_mesh(n_devices)
    rng = np.random.default_rng(11)
    n = 1000
    keys = rng.integers(0, 97, size=n, dtype=np.int64)
    values = rng.integers(-50, 50, size=n, dtype=np.int64)
    res = dist_aggregate(mesh, keys, values, cap_slack=8.0)
    assert not bool(res.overflow)
    got = collect_groups(res)
    want = _oracle_rows(keys, values)
    assert int(res.n_groups) == want.shape[0]
    np.testing.assert_array_equal(got, want)


def test_dist_aggregate_zipf_skew_reported():
    """Zipf keys: the head key loads one owner; skew > 1, results exact."""
    mesh = make_join_mesh(8)
    keys = gen_zipf_keys(2000, domain=50, alpha=1.3, seed=5)
    values = np.arange(2000, dtype=np.int64)
    res = dist_aggregate(mesh, keys, values, cap_slack=32.0)
    assert not bool(res.overflow)
    np.testing.assert_array_equal(
        collect_groups(res), _oracle_rows(keys, values)
    )
    assert float(res.skew) > 1.0


def test_dist_aggregate_overflow_flag():
    """All-identical keys with tight slack must trip the overflow flag
    (never silently drop rows)."""
    mesh = make_join_mesh(8)
    keys = np.full(800, 7, dtype=np.int64)
    values = np.ones(800, dtype=np.int64)
    res = dist_aggregate(mesh, keys, values, cap_slack=1.0)
    assert bool(res.overflow)


def test_dist_aggregate_uneven_rows_padding():
    """Row count not divisible by P: sentinel padding must not create a
    phantom group or perturb any stat."""
    mesh = make_join_mesh(8)
    rng = np.random.default_rng(3)
    n = 777  # 777 = 8*97 + 1 -> 7 pad rows
    keys = rng.integers(0, 31, size=n, dtype=np.int64)
    values = rng.integers(0, 9, size=n, dtype=np.int64)
    res = dist_aggregate(mesh, keys, values, cap_slack=8.0)
    assert not bool(res.overflow)
    np.testing.assert_array_equal(
        collect_groups(res), _oracle_rows(keys, values)
    )
