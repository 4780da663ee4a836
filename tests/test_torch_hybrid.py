"""The port's hybrid RT-vs-SLICE dispatcher against the JAX package's, on
the CPU.

``choose_engine`` keeps the JAX fallback constants (fitted on a CPU) and
its warn-once rule; under an active profile it prices the RT side with
``dense``, the backend ``hybrid_rknn_query`` runs (the JAX module prices
and runs ``dense-ref``, since there ``dense`` is interpret-mode Pallas).
``hybrid_rknn_query`` masks equal JAX's and the brute oracle.  Both
packages keep a process-wide active profile and a warn-once flag; the
fixture restores all four.
"""

import warnings

import numpy as np
import pytest

import repro.core.hybrid as jhybrid
import repro_torch.core.hybrid as hybrid
from repro.core.brute import rknn_brute_np
from repro.planner import models as jmodels
from repro.planner import profiles as jprofiles
from repro_torch.core.hybrid import SceneCache, choose_engine, hybrid_rknn_query
from repro_torch.core.geometry import Rect
from repro_torch.planner import models, profiles

from tests._torch_parity import CPU, instance


@pytest.fixture(autouse=True)
def _restore_planner_state():
    prev = (profiles.get_active_profile(), jprofiles.get_active_profile(),
            hybrid._warned_no_profile, jhybrid._warned_no_profile)
    yield
    profiles.set_active_profile(prev[0])
    jprofiles.set_active_profile(prev[1])
    hybrid._warned_no_profile, jhybrid._warned_no_profile = prev[2], prev[3]


GRID = [(f, u, k) for f in (0, 1, 30, 100, 1_000, 10_000, 100_000)
        for u in (100, 100_000, 1_000_000, 24_000_000) for k in (1, 10, 25, 200)]


def _const(mod, name, t_s):
    coef = np.zeros(len(mod.FEATURE_NAMES))
    coef[0] = np.log(t_s)
    return mod.BackendCostModel(name, mod.CostModel(coef.copy() - 50), mod.CostModel(coef))


def _scaled(mod, name, c, u_exp, k_exp):
    """A verify model ``c · U^u_exp · k^k_exp``: frontiers that move with
    the shape, so the grid has both answers."""
    m = _const(mod, name, c)
    m.verify.coef[mod.FEATURE_NAMES.index("log_u")] = u_exp
    m.verify.coef[mod.FEATURE_NAMES.index("log_k")] = k_exp
    return m


def test_choose_engine_fallback_equals_jax_and_warns_once():
    profiles.set_active_profile(None)
    jprofiles.set_active_profile(None)
    hybrid._warned_no_profile = jhybrid._warned_no_profile = False
    with pytest.warns(RuntimeWarning, match="no active planner profile"):
        assert choose_engine(100, 1_000_000, 25) == "rt"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [jhybrid.choose_engine(*c) for c in GRID]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warn-once: silent from here on
        got = [choose_engine(*c) for c in GRID]
    assert got == want
    assert {"rt", "slice"} == set(got)


@pytest.mark.parametrize("rt_name", ["dense", "dense-ref", "bvh"])
def test_choose_engine_under_rigged_profile_equals_jax(rt_name):
    """The port's RT model under ``dense`` (a card profile), ``dense-ref``
    (a CPU-calibrated one) or only another scene backend makes JAX's
    decisions with its model under ``dense-ref``."""
    def prof(mod, pmod, name):
        return pmod.PlannerProfile(models={
            name: _scaled(mod, name, 1e-6, 0.5, 0.0),
            "slice": _scaled(mod, "slice", 1e-8, 1.0, 1.5),
            "brute": _const(mod, "brute", 1e-12),  # no ray casting: never the RT side
        })

    profiles.set_active_profile(prof(models, profiles, rt_name))
    jprofiles.set_active_profile(prof(jmodels, jprofiles, "dense-ref"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a usable profile never warns
        got = [choose_engine(*c) for c in GRID]
        want = [jhybrid.choose_engine(*c) for c in GRID]
    assert got == want and {"rt", "slice"} == set(got)


def test_choose_engine_profile_without_slice_falls_back():
    profiles.set_active_profile(profiles.PlannerProfile(models={"dense": _const(models, "dense", 1.0)}))
    hybrid._warned_no_profile = False
    with pytest.warns(RuntimeWarning, match="no 'slice' model"):
        assert choose_engine(10_000, 100_000, 1) == "slice"


@pytest.mark.parametrize("force", ["rt", "slice", None])
@pytest.mark.parametrize("cached", [False, True])
def test_hybrid_rknn_query_masks_equal_jax_and_oracle(force, cached):
    F, U, rng = instance(211, M=60, N=500)
    profiles.set_active_profile(None)
    jprofiles.set_active_profile(None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallback's warn-once
        for q, k in ((3, 4), (int(rng.integers(0, len(F))), 2)):
            cache = SceneCache(8) if cached else None
            jcache = jhybrid.SceneCache(8) if cached else None
            got = hybrid_rknn_query(F, U, q, k, cache=cache, force=force, device=CPU)
            want = jhybrid.hybrid_rknn_query(F, U, q, k, cache=jcache, force=force)
            np.testing.assert_array_equal(got.mask, want.mask)
            np.testing.assert_array_equal(got.mask, rknn_brute_np(U, F, q, k))
            engine = force or choose_engine(len(F), len(U), k)
            assert got.backend == ("slice" if engine == "slice" else "dense")
            if engine == "slice":
                np.testing.assert_array_equal(got.counts, want.counts)
            if cached and engine == "rt":
                again = hybrid_rknn_query(F, U, q, k, cache=cache, force=force, device=CPU)
                assert cache.hits == 1 and again.scene is got.scene
                np.testing.assert_array_equal(again.counts, got.counts)


def test_scene_cache_contains_peeks_without_stats():
    F, U, _ = instance(5, M=30, N=100)
    rect = Rect.from_points(F, U)
    cache = SceneCache(4)
    assert not cache.contains(F, 2, 3, rect)
    cache.get_or_build(F, 2, 3, rect, users_hint=U)
    assert cache.contains(F, 2, 3, rect) and not cache.contains(F, 2, 4, rect)
    assert cache.contains(F, np.int64(2), 3, rect, fp=SceneCache.fingerprint(F))
    assert (cache.hits, cache.misses) == (0, 1)
