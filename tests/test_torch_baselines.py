"""The port's baselines (SIX, TPL, InfZone, SLICE and their STR R-tree)
against ``repro.core.baselines``, on the CPU.

The baselines are host numpy, carried over unchanged, so each gives the
same mask and the same ``info`` entries (counters, pruning stats,
thresholds, slice signatures) as the JAX package's, exactly; only the timing entries
(``t_filter_s``, ``t_verify_s``) differ from run to run.  Inputs: the
instance generator of ``tests/test_baselines.py`` (12 seeds per method)
and two scenarios at small scale.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.baselines as jb
import repro_torch.core.baselines as tb
from repro.core.brute import rknn_brute_np
from repro.workloads import SCENARIOS

METHODS = ("six_rknn", "tpl_rknn", "infzone_rknn", "slice_rknn")
TIMING = ("t_filter_s", "t_verify_s")


def _instance(seed):
    """``tests/test_baselines.py``'s generator."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(15, 150))
    N = int(rng.integers(100, 700))
    k = int(rng.integers(1, 14))
    F = rng.random((M, 2)) * 10
    U = rng.random((N, 2)) * 10
    qi = int(rng.integers(0, M))
    return F, U, qi, k


def _same(method, F, U, qi, k):
    a_mask, a_info = getattr(jb, method)(F, U, qi, k)
    b_mask, b_info = getattr(tb, method)(F, U, qi, k)
    np.testing.assert_array_equal(a_mask, b_mask)
    assert set(a_info) == set(b_info)
    for key in set(a_info) - set(TIMING):
        a, b = a_info[key], b_info[key]
        if dataclasses.is_dataclass(a):  # InfZone's PruneStats: the same fields
            assert dataclasses.asdict(a) == dataclasses.asdict(b), key
        elif isinstance(a, (list, tuple, np.ndarray)):
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert type(a) is type(b) and a == b, key
    return b_mask


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("method", METHODS)
def test_baseline_matches_jax(method, seed):
    offset = 100 * METHODS.index(method)  # each method's seeds, as test_baselines.py
    F, U, qi, k = _instance(seed + offset)
    mask = _same(method, F, U, qi, k)
    np.testing.assert_array_equal(mask, rknn_brute_np(U, F, qi, k))


@pytest.mark.parametrize("scenario", ["sparse_facility", "clustered"])
@pytest.mark.parametrize("method", METHODS)
def test_baseline_matches_jax_on_scenarios(method, scenario):
    w = SCENARIOS[scenario].generate(0.03)
    for qi in w.qs[:2]:
        _same(method, w.facilities, w.users, qi, w.k)


def test_rtree_queries_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.random((500, 2))
    a, b = jb.STRTree(pts), tb.STRTree(pts)
    for p in (np.array([0.5, 0.5]), np.array([0.2, 0.8]), pts[7]):
        assert a.knn(p, 10) == b.knn(p, 10)
        assert a.knn(p, 5, exclude=7) == b.knn(p, 5, exclude=7)
        assert list(a.nearest_iter(p)) == list(b.nearest_iter(p))
        for r in (0.05, 0.2, 0.7):
            assert a.count_within_strict(p, r) == b.count_within_strict(p, r)
            assert a.count_within_strict(p, r, exclude=7) == b.count_within_strict(p, r, exclude=7)
    assert b.build_time > 0
