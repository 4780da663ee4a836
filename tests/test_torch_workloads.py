"""The port's scenario generators against ``repro.workloads``, on the CPU.

Every generator is host numpy over the port's ``data/spatial.py``, so
each workload must equal the JAX package's bit for bit: facilities,
users, query indices and ``k``.
"""

import dataclasses

import numpy as np
import pytest

import repro.workloads as jw
import repro_torch.workloads as tw


def _same_workload(a, b):
    assert (a.name, a.qs, a.k, a.shape) == (b.name, b.qs, b.k, b.shape)
    for f in ("facilities", "users"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_registry_and_regimes_match():
    assert tw.scenario_names() == jw.scenario_names()
    assert tw.SHARDING_REGIMES == jw.SHARDING_REGIMES
    for name in jw.scenario_names():
        assert dataclasses.astuple(tw.get_scenario(name)) == dataclasses.astuple(
            jw.get_scenario(name))
    with pytest.raises(ValueError, match="scenario must be one of"):
        tw.get_scenario("nope")
    # the update streams the dynamic subsystem serves, at two seeds
    F, U = np.random.default_rng(4).random((2, 80, 2))
    protect = np.array([0, 3, 11])
    for seed in (0, 9):
        for gen, pts, kw in (("drifting_users", U, {}),
                             ("facility_churn", F, dict(protect=protect)),
                             ("facility_jitter", F, dict(protect=protect))):
            a = getattr(tw, gen)(pts, steps=3, seed=seed, **kw)
            b = getattr(jw, gen)(pts, steps=3, seed=seed, **kw)
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                for field in dataclasses.fields(y):
                    xv, yv = getattr(x, field.name), getattr(y, field.name)
                    for u, v in (zip(xv, yv) if isinstance(yv, tuple) else [(xv, yv)]):
                        assert u.dtype == v.dtype
                        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("scale", [0.01, 0.08])
@pytest.mark.parametrize("name", list(jw.SCENARIOS))
def test_every_scenario_generates_the_same_workload(name, scale):
    _same_workload(jw.SCENARIOS[name].generate(scale), tw.SCENARIOS[name].generate(scale))


@pytest.mark.parametrize("fast,seed", [(True, 0), (True, 3), (False, 0)])
def test_calibration_grid_matches(fast, seed):
    a, b = jw.calibration_grid(fast=fast, seed=seed), tw.calibration_grid(fast=fast, seed=seed)
    assert [dataclasses.astuple(s) for s in a] == [dataclasses.astuple(s) for s in b]
    if fast:
        for sa, sb in zip(a[:3], b[:3]):
            _same_workload(sa.generate(0.2), sb.generate(0.2))


def test_sharding_scenarios_and_absolute_user_counts_match():
    for a, b in zip(jw.sharding_scenarios(700), tw.sharding_scenarios(700)):
        _same_workload(a, b)
    _same_workload(jw.get_scenario("large_k").generate_users(300),
                   tw.get_scenario("large_k").generate_users(300))


@pytest.mark.parametrize("distribution", ["road", "uniform", "clustered", "gaussian", "mixed"])
def test_each_distribution_matches(distribution):
    args = ("t", 30, 500, 4, 2)
    _same_workload(jw.Scenario(*args, distribution=distribution, seed=3).generate(),
                   tw.Scenario(*args, distribution=distribution, seed=3).generate())


def test_unknown_distribution_raises_the_same_error():
    for mod in (jw, tw):
        with pytest.raises(ValueError, match="distribution must be"):
            mod.Scenario("t", 10, 100, 4, 2, distribution="nope").generate()
