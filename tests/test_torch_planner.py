"""The port's query planner against the JAX package's, on the CPU.

Covers ``repro_torch.planner`` (models, profiles, backend, calibrate) and
the ``auto`` backend of ``repro_torch.core.engine``:

* the cost models carried over verbatim: features, estimates and fitted
  coefficients equal to JAX's bit for bit (``assert_array_equal``);
* profiles: one JSON schema (either package loads the other's and prices
  it identically, rtol 1e-12), the port's prior is JAX's without the
  interpret-mode penalty, and the committed H100 profile parses;
* the planner: under one loaded profile its choices equal JAX's, and on a
  CUDA device it never offers a plain twin;
* the engine (``device="cpu"``): ``auto`` masks equal every forced
  backend's, JAX's ``auto`` masks and the brute oracle (masks are the
  invariant: counts differ by route, ``bvh`` saturates at ``k`` and
  ``brute`` counts ranks).

Both packages keep a process-wide active profile; the fixture restores
each.
"""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.brute import rknn_brute_np, rknn_mono_brute_np
from repro.core.backends import timeable_backends as j_timeable
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.planner import models as jmodels
from repro.planner import profiles as jprofiles
from repro.planner.backend import PlannerBackend as JPlanner
from repro_torch.core import rknn as trknn
from repro_torch.core.backends import (
    QueryRequest,
    available_backends,
    concrete_backends,
    get_backend,
    timeable_backends,
)
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.planner import models, profiles
from repro_torch.planner.backend import PlannerBackend

from tests._torch_parity import CPU, instance

ROOT = Path(__file__).resolve().parent.parent
CAL = models.WorkloadShape(1000, 1_889_815, 10, 64, cache_hit=True)
CARD_TIMEABLE = ("dense", "grid", "grid-pallas", "bvh", "brute")


@pytest.fixture(autouse=True)
def _restore_active_profiles():
    prev_t, prev_j = profiles.get_active_profile(), jprofiles.get_active_profile()
    yield
    profiles.set_active_profile(prev_t)
    jprofiles.set_active_profile(prev_j)


def _shapes():
    """A grid over every feature, cache hits and misses included."""
    return [
        models.WorkloadShape(f, u, k, q, m_tris=m, cache_hit=hit, pad_waste=pw, shards=sh)
        for f in (1, 40, 1_000, 30_000)
        for u in (1, 900, 1_889_815)
        for k in (1, 10, 200)
        for q in (1, 16, 64)
        for m, hit, pw, sh in ((None, False, None, 1), (37.0, True, 3.5, 1), (0.5, False, 1.0, 4))
    ]


def _jshape(s):
    return jmodels.WorkloadShape(s.n_facilities, s.n_users, s.k, s.q, m_tris=s.m_tris,
                                 cache_hit=s.cache_hit, pad_waste=s.pad_waste, shards=s.shards)


def _const(name, t_s, mod=models):
    coef = np.zeros(len(mod.FEATURE_NAMES))
    coef[0] = np.log(t_s)
    return mod.BackendCostModel(name, mod.CostModel(coef.copy() - 50), mod.CostModel(coef))


# ------------------------------------------------------------------ models
def test_featurize_and_estimates_equal_jax():
    assert models.FEATURE_NAMES == jmodels.FEATURE_NAMES
    assert models.SIGN_FREE_FEATURES == jmodels.SIGN_FREE_FEATURES
    for s in _shapes():
        np.testing.assert_array_equal(models.featurize(s), jmodels.featurize(_jshape(s)))
        assert s.m() == _jshape(s).m() and s.pw() == _jshape(s).pw()
    for f in (0, 1, 2, 50, 1_000):
        for k in (1, 8, 100):
            assert models.est_scene_tris(f, k) == jmodels.est_scene_tris(f, k)
    for u in (0, 1, 7, 4_095, 4_096, 100_000, 1_889_815):
        for g in (16, 64):
            assert models.est_pad_waste(u, g) == jmodels.est_pad_waste(u, g)


def _fit_cases():
    rng = np.random.default_rng(7)
    shapes = [
        models.WorkloadShape(int(f), int(u), int(k), int(q), m_tris=float(m), pad_waste=float(pw))
        for f, u, k, q, m, pw in zip(
            rng.integers(10, 1000, 30), rng.integers(100, 10000, 30), rng.integers(1, 64, 30),
            rng.integers(1, 32, 30), rng.integers(4, 500, 30), rng.uniform(1.0, 30.0, 30),
        )
    ]
    noise = rng.lognormal(0.0, 0.3, 30)
    return shapes, {
        "power_law": (np.array([1e-7 * s.n_users * s.q for s in shapes]) * noise, ()),
        "drop_m_and_pw": (np.array([1e-6 * s.n_users * s.m() for s in shapes]) * noise,
                          ("log_m", "log_pw")),
        "negative_pinned": (np.array([1e-6 * s.n_users / s.k for s in shapes]) * noise, ()),
        "log_q_capped": (np.array([1e-8 * s.n_users * s.q**2.5 for s in shapes]) * noise, ()),
        "floored": (np.full(30, 1e-9), ()),
    }


@pytest.mark.parametrize("case", ["power_law", "drop_m_and_pw", "negative_pinned",
                                  "log_q_capped", "floored"])
def test_fits_bit_identical_to_jax(case):
    shapes, cases = _fit_cases()
    times, drop = cases[case]
    jshapes = [_jshape(s) for s in shapes]
    got = models.CostModel.fit(shapes, times, drop=drop)
    want = jmodels.CostModel.fit(jshapes, times, drop=drop)
    np.testing.assert_array_equal(got.coef, want.coef)
    if case == "negative_pinned":
        assert got.coef[models.FEATURE_NAMES.index("log_k")] == 0.0
    if case == "log_q_capped":
        assert got.coef[models.FEATURE_NAMES.index("log_q")] == 1.0
    bt = models.BackendCostModel.fit("x", shapes, times * 0.5, times, drop=drop)
    bj = jmodels.BackendCostModel.fit("x", jshapes, times * 0.5, times, drop=drop)
    np.testing.assert_array_equal(bt.filter.coef, bj.filter.coef)
    np.testing.assert_array_equal(bt.verify.coef, bj.verify.coef)
    feats = np.stack([models.featurize(s) for s in shapes])
    hits = np.array([i % 2 == 0 for i in range(len(shapes))])
    np.testing.assert_array_equal(bt.predict_total_many_s(feats, hits),
                                  bj.predict_total_many_s(feats, hits))


# ----------------------------------------------------------------- profiles
def test_profiles_load_across_packages_and_price_identically(tmp_path):
    j_json = jprofiles.builtin_profile().to_json()
    t_json = profiles.builtin_profile().to_json()
    assert j_json.keys() == t_json.keys() and t_json["version"] == jprofiles.PROFILE_VERSION
    t_from_j = profiles.PlannerProfile.from_json(json.loads(json.dumps(j_json)))
    j_from_t = jprofiles.PlannerProfile.from_json(json.loads(json.dumps(t_json)))
    for s in _shapes()[::7]:
        for name in j_json["models"]:
            np.testing.assert_allclose(t_from_j.predict_s(name, s),
                                       jprofiles.builtin_profile().predict_s(name, _jshape(s)),
                                       rtol=1e-12)
            np.testing.assert_allclose(j_from_t.predict_s(name, _jshape(s)),
                                       profiles.builtin_profile().predict_s(name, s), rtol=1e-12)
    path = str(tmp_path / "nested" / "p.json")
    profiles.builtin_profile().save(path)
    assert jprofiles.load_profile(path).models.keys() == t_json["models"].keys()
    loaded = profiles.load_profile(path)
    assert loaded.source == "builtin-prior" and loaded.version == profiles.PROFILE_VERSION


@pytest.mark.parametrize("bad", ["version", "coef_shape"])
def test_stale_profiles_are_rejected(bad, tmp_path):
    obj = jprofiles.builtin_profile().to_json()
    if bad == "version":
        obj["version"] = 999
        p = tmp_path / "bad.json"
        p.write_text(json.dumps(obj))
        with pytest.raises(ValueError, match="version"):
            profiles.load_profile(str(p))
    else:
        obj["models"]["brute"]["verify"]["coef"] = [1.0, 2.0]
        with pytest.raises(ValueError, match="stale profile"):
            profiles.PlannerProfile.from_json(obj)


def test_builtin_prior_is_jax_without_the_interpret_penalty():
    t, j = profiles.builtin_profile(), jprofiles.builtin_profile()
    assert set(t.models) == set(j.models)
    pairs = [(n, n) for n in ("dense-ref", "grid", "grid-pallas-ref", "bvh", "brute", "slice")]
    pairs += [("dense", "dense-ref"), ("grid-pallas", "grid-pallas-ref")]
    for mine, theirs in pairs:
        for phase in ("filter", "verify"):
            np.testing.assert_array_equal(getattr(t.models[mine], phase).coef,
                                          getattr(j.models[theirs], phase).coef)
    # the penalty is JAX's alone: its interpret-mode dense costs 40x more
    ratio = j.models["dense"].verify.predict_s(_jshape(CAL)) / t.models["dense"].verify.predict_s(CAL)
    assert ratio > 10.0
    assert "CPU-class" in t.meta["note"] and t.source == "builtin-prior"


def test_hardware_fingerprint_off_card_imports_no_jax():
    probe = ("import sys, json; from repro_torch.planner.profiles import hardware_fingerprint, "
             "runner_class; h = hardware_fingerprint(); "
             "print(json.dumps({'hw': h, 'rc': runner_class(h), "
             "'jax': sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["jax"] == []
    assert rep["hw"]["platform"] == "cpu" and rep["hw"]["device_kind"] == "cpu"
    assert rep["rc"].endswith("-cpu-cpu")


def test_default_store_is_the_ports_and_env_var_activates_on_first_use(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_PLANNER_PROFILE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert profiles.default_profile_path() == str(tmp_path / "repro_torch" / "planner_profile.json")
    assert jprofiles.default_profile_path() != profiles.default_profile_path()
    path = str(tmp_path / "env_profile.json")
    saved = profiles.builtin_profile()
    saved.save(path)
    monkeypatch.setenv("REPRO_PLANNER_PROFILE", path)
    monkeypatch.setattr(profiles, "_disk_checked", False)
    profiles.set_active_profile(None)
    prof = profiles.active_or_builtin()
    assert prof.source == saved.source and profiles.get_active_profile() is prof
    assert prof is not saved  # loaded from disk


def test_active_profile_and_epoch_are_the_ports_alone():
    jprofiles.set_active_profile(None)
    j_epoch = jprofiles.profile_epoch()
    mine = profiles.builtin_profile()
    before = profiles.profile_epoch()
    profiles.set_active_profile(mine)
    profiles.note_recalibrated()
    assert profiles.get_active_profile() is mine and profiles.profile_epoch() == before + 2
    assert jprofiles.get_active_profile() is None and jprofiles.profile_epoch() == j_epoch


def test_foreign_hardware_profile_warns_on_load(tmp_path):
    obj = profiles.builtin_profile().to_json()
    obj["hardware"] = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                       "machine": "riscv"}
    p = tmp_path / "foreign.json"
    p.write_text(json.dumps(obj))
    with pytest.warns(RuntimeWarning, match="different hardware"):
        profiles.load_profile(str(p))


def _committed():
    paths = sorted(glob.glob(os.path.join(profiles.PROFILE_STORE, "*.json")))
    assert paths, f"no committed profile under {profiles.PROFILE_STORE}"
    return paths


def test_committed_h100_profile_parses_and_prices_the_card_backends(monkeypatch):
    h100 = []
    for path in _committed():
        with open(path) as f:
            obj = json.load(f)
        prof = profiles.PlannerProfile.from_json(obj)
        assert prof.version == 2 and prof.source == "calibrated"
        assert os.path.basename(path) == profiles.runner_class(prof.hardware) + ".json"
        if "H100" in prof.hardware.get("device_kind", ""):
            h100.append((path, prof))
    assert len(h100) == 1
    path, prof = h100[0]
    assert prof.hardware["platform"] == "gpu"
    assert set(prof.models) == set(CARD_TIMEABLE) | {"slice"}
    assert prof.meta["backends"] == list(CARD_TIMEABLE) + ["slice"]
    for s in (CAL, models.WorkloadShape(1000, 1_889_815, 10, 64, cache_hit=False)):
        for name in prof.models:
            t = prof.predict_s(name, s)
            assert np.isfinite(t) and t > 0
    # strict per-runner-class load: refused off the card, taken on it
    assert profiles.load_runner_profile(profiles.PROFILE_STORE) is None
    monkeypatch.setattr(profiles, "hardware_fingerprint", lambda: dict(prof.hardware))
    got = profiles.load_runner_profile(profiles.PROFILE_STORE)
    assert got is not None and got.hardware == prof.hardware
    # and the JAX package reads it (one schema), warning off the card
    with pytest.warns(RuntimeWarning, match="different hardware"):
        assert set(jprofiles.load_profile(path).models) == set(prof.models)


# ------------------------------------------------------------------ planner
def test_registry_candidates_and_timeable_sets():
    assert available_backends()[-1] == "auto" and "auto" not in concrete_backends()
    assert trknn.BACKENDS == concrete_backends()
    planner = get_backend("auto")
    assert planner.is_meta and isinstance(planner, PlannerBackend)
    prof = profiles.PlannerProfile.from_json(jprofiles.builtin_profile().to_json())
    assert planner.candidates(prof, device="cpu") == JPlanner().candidates(jprofiles.builtin_profile())
    on_card = planner.candidates(prof, device="cuda")
    assert on_card == CARD_TIMEABLE and planner.candidates(prof) == on_card
    assert timeable_backends("cpu") == j_timeable()
    assert timeable_backends("cuda") == timeable_backends() == CARD_TIMEABLE


def _split_profile(mod):
    """``dense-ref`` cheap on small scenes, ``brute`` flat: a decisive split."""
    m = mod.FEATURE_NAMES.index("log_m")
    small = _const("dense-ref", 1e-3, mod)
    small.verify.coef[m] = 1.0
    return mod, {"dense-ref": small, "brute": _const("brute", 0.05, mod),
                 "bvh": _const("bvh", 0.0505, mod)}


@pytest.mark.parametrize("profile", ["builtin", "split", "close"])
def test_select_and_assign_batch_equal_jax(profile):
    if profile == "builtin":
        obj = jprofiles.builtin_profile().to_json()
    else:
        _mod, ms = _split_profile(jmodels)
        if profile == "close":
            ms = {"brute": _const("brute", 0.05, jmodels), "bvh": _const("bvh", 0.0495, jmodels)}
        obj = jprofiles.PlannerProfile(models=ms).to_json()
    jprofiles.set_active_profile(jprofiles.PlannerProfile.from_json(obj))
    profiles.set_active_profile(profiles.PlannerProfile.from_json(obj))
    mine, theirs = get_backend("auto"), JPlanner()
    cands = mine.candidates(device="cpu")
    assert cands == theirs.candidates()
    for s in _shapes()[::5]:
        got, want = mine.select(s, cands), theirs.select(_jshape(s))
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    batches = [[models.WorkloadShape(300, 5_000, 8, 1, m_tris=m, cache_hit=True)
                for m in ms_] for ms_ in ((5, 500), (5, 6, 7, 400, 900), (50,) * 4)]
    for shapes in batches:
        got = mine.assign_batch(shapes, cands)
        want = theirs.assign_batch([_jshape(s) for s in shapes])
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-12)
    if profile == "split":
        assert {n for n, _ in mine.assign_batch(batches[0], cands)} == {"dense-ref", "brute"}
    if profile == "close":
        assert len({n for n, _ in mine.assign_batch(batches[0], cands)}) == 1


def test_observe_converges_and_flips_misroute_like_jax():
    """The JAX package's convergence case, run in both packages in lockstep:
    the same choices at every step and the same nudged coefficients."""

    def profile(mod, prof_mod):
        def const(name, filter_s, verify_s):
            f = np.zeros(len(mod.FEATURE_NAMES))
            v = np.zeros(len(mod.FEATURE_NAMES))
            f[0], v[0] = np.log(filter_s), np.log(verify_s)
            return mod.BackendCostModel(name, mod.CostModel(f), mod.CostModel(v))

        return prof_mod.PlannerProfile(models={
            "grid": const("grid", 5e-5, 5e-5),  # underpriced
            "grid-pallas-ref": const("grid-pallas-ref", 2e-3, 3e-3),
        })

    profiles.set_active_profile(profile(models, profiles))
    jprofiles.set_active_profile(profile(jmodels, jprofiles))
    true_s = {"grid": 8e-3, "grid-pallas-ref": 2e-3}
    mine, theirs = PlannerBackend(), JPlanner()
    cands = ("grid", "grid-pallas-ref")
    shape = models.WorkloadShape(100, 5_000, 8, 16, m_tris=40.0, pad_waste=2.0)
    chosen = []
    for _ in range(40):
        c, pred, _ = mine.select(shape, cands)
        jc, jpred, _ = theirs.select(_jshape(shape), cands)
        assert (c, pred) == (jc, jpred)
        chosen.append(c)
        for p, pl in ((mine, pred), (theirs, jpred)):
            p.observe({"mode": "single", "backend": c, "predicted_s": pl,
                       "observed_s": true_s[c]})
    assert chosen[0] == "grid" and chosen[-10:] == ["grid-pallas-ref"] * 10
    _, pred, _ = mine.select(shape, cands)
    assert abs(np.log(pred / true_s["grid-pallas-ref"])) < 0.5
    assert mine.n_recal_nudges == theirs.n_recal_nudges == 40
    for name in cands:
        np.testing.assert_array_equal(profiles.get_active_profile().models[name].verify.coef,
                                      jprofiles.get_active_profile().models[name].verify.coef)


def test_direct_protocol_geometry_free():
    F, U, _ = instance(149, M=50, N=300)
    planner = get_backend("auto")
    counts = planner.count(QueryRequest(xs=None, ys=None, k=3, device=CPU, users=U,
                                        facilities=F, q_pt=F[2], exclude=2))
    np.testing.assert_array_equal(counts < 3, rknn_brute_np(U, F, 2, 3))
    assert planner.explain()["mode"] == "direct-single"


# ------------------------------------------------------------------- engine
def _auto(F, U, **cfg):
    return RkNNEngine(F, U, RkNNConfig(backend="auto", **cfg), device=CPU)


def test_auto_masks_equal_forced_backends_jax_auto_and_oracle():
    F, U, rng = instance(103, M=50, N=300)
    qs = [int(q) for q in rng.integers(0, len(F), 5)] + [np.array([0.4, 0.6])]
    k = 3
    eng, jeng = _auto(F, U), JEngine(F, U, JConfig(backend="auto"))
    got = eng.query_batch(qs, k)
    assert got.backend == "auto"
    np.testing.assert_array_equal(got.masks, jeng.query_batch(qs, k).masks)
    for i, q in enumerate(qs):
        np.testing.assert_array_equal(got.masks[i], rknn_brute_np(U, F, q, k))
        single = eng.query(q, k)
        assert single.backend in concrete_backends()
        np.testing.assert_array_equal(single.mask, got.masks[i])
        np.testing.assert_array_equal(single.mask, jeng.query(q, k).mask)
    for forced in concrete_backends():
        np.testing.assert_array_equal(eng.query_batch(qs, k, backend=forced).masks, got.masks)
    streamed = list(eng.stream([qs[:2], qs[2:]], k))
    np.testing.assert_array_equal(np.concatenate([m for _, m in streamed]), got.masks)
    assert eng.explain()[-1]["mode"] == "stream-batch"
    want = [m for _, m in jeng.stream([qs[:2], qs[2:]], k)]
    np.testing.assert_array_equal(np.concatenate(want), got.masks)


def test_auto_mono_and_one_shot_shims():
    P = np.random.default_rng(109).random((40, 2))
    mono = RkNNEngine(P, P, RkNNConfig(backend="auto"), device=CPU).query_mono(7, 3)
    np.testing.assert_array_equal(mono.mask, rknn_mono_brute_np(P, 7, 3))
    np.testing.assert_array_equal(
        trknn.rknn_mono_query(P, 7, 3, backend="auto", device=CPU).mask, mono.mask)
    jmono = JEngine(P, P, JConfig(backend="auto")).query_mono(7, 3)
    np.testing.assert_array_equal(jmono.mask, mono.mask)
    F, U, _ = instance(107, M=20, N=200)
    empty = trknn.rt_rknn_query_batch(F, U, [], 3, backend="auto", device=CPU)
    assert empty.masks.shape == (0, len(U))
    one = trknn.rt_rknn_query(F, U, 2, 3, backend="auto", device=CPU)
    np.testing.assert_array_equal(one.mask, rknn_brute_np(U, F, 2, 3))


def test_forced_mixed_split_recombines(monkeypatch):
    F, U, rng = instance(137, M=60, N=400)
    qs = [int(q) for q in rng.integers(0, len(F), 8)]
    k = 4
    rotation = ("dense", "brute", "grid", "bvh")
    monkeypatch.setattr(PlannerBackend, "rank",
                        lambda self, shape, candidates=None: [("dense", 1.0)])
    monkeypatch.setattr(PlannerBackend, "assign_batch",
                        lambda self, shapes, candidates=None: [
                            (rotation[i % 4], 1.0) for i in range(len(shapes))])
    eng = _auto(F, U)
    res = eng.query_batch(qs, k)
    plan = eng.explain()[-1]
    assert plan["split"] and set(plan["groups"]) == set(rotation)
    assert plan["assignments"] == [rotation[i % 4] for i in range(len(qs))]
    assert set(plan["observed_group_s"]) == set(rotation)
    for i, qi in enumerate(qs):
        np.testing.assert_array_equal(res.masks[i], rknn_brute_np(U, F, qi, k))
    for forced in rotation:
        np.testing.assert_array_equal(
            res.masks, trknn.rt_rknn_query_batch(F, U, qs, k, backend=forced, device=CPU).masks)
    assert get_backend("auto").explain()["groups"] == plan["groups"]


def test_plan_cache_hit_and_new_profile_invalidates():
    F, U, rng = instance(131, M=50, N=300)
    qs = [int(q) for q in rng.integers(0, len(F), 6)]
    eng = _auto(F, U)
    a = eng.query_batch(qs, 4)
    b = eng.query_batch(qs, 4)
    assert eng.stats.batch_cache_hits >= 1 and eng.explain()[-1].get("plan_cache_hit")
    np.testing.assert_array_equal(a.masks, b.masks)
    profiles.set_active_profile(profiles.builtin_profile())  # epoch bump
    c = eng.query_batch(qs, 4)
    assert not eng.explain()[-1].get("plan_cache_hit")
    np.testing.assert_array_equal(c.masks, a.masks)
    # a facility-index query and a point query at its coordinates build
    # different scenes: the group LRU must keep them apart (the point query
    # ties with facility 5 itself, where every backend of both packages
    # parts from the numpy oracle alike, so it is held against a cold shim
    # of the backend the planner chose and against JAX's auto)
    i = eng.query_batch([5], 4)
    np.testing.assert_array_equal(i.masks[0], rknn_brute_np(U, F, 5, 4))
    p = eng.query_batch([F[5].copy()], 4)
    chose = next(iter(eng.explain()[-1]["groups"]))
    cold = trknn.rt_rknn_query_batch(F, U, [F[5].copy()], 4, backend=chose, device=CPU)
    np.testing.assert_array_equal(p.masks, cold.masks)
    jeng = JEngine(F, U, JConfig(backend="auto"))
    jeng.query_batch([5], 4)
    np.testing.assert_array_equal(p.masks, jeng.query_batch([F[5].copy()], 4).masks)


def test_explain_stats_and_online_recalibration():
    F, U, rng = instance(127, M=50, N=300)
    profiles.set_active_profile(None)
    eng = _auto(F, U, online_recalibration=True)
    res = eng.query(1, 3)
    p = eng.explain()[0]
    assert p["mode"] == "single" and p["backend"] == res.backend
    assert p["predicted_s"] > 0 and p["observed_s"] > 0
    assert set(p["candidates"]) == set(concrete_backends())
    assert get_backend("auto").explain() is p
    qs = [int(q) for q in rng.integers(0, len(F), 4)]
    eng.query_batch(qs, 3)
    p2 = eng.explain()[-1]
    assert p2["mode"] == "batch" and len(p2["assignments"]) == len(qs)
    assert sum(eng.stats.planner_decisions.values()) == 1 + len(qs)
    assert eng.stats.planner_pred_s > 0 and eng.stats.planner_obs_s > 0
    assert eng.stats.planner_recal_nudges >= 2
    # the prior is never nudged in place: a private copy was activated
    active = profiles.get_active_profile()
    assert active is not profiles.builtin_profile() and active.source.endswith("+online")
    assert "planner_recal_nudges" in repr(eng.stats)
    assert _auto(F, U).stats.planner_recal_nudges == 0


def test_tiny_calibration_round_trips_and_drives_auto(tmp_path):
    from repro_torch.planner.calibrate import calibrate
    from repro_torch.workloads import Scenario

    tiny = [
        Scenario("cal_a", 25, 300, 3, 2, seed=1),
        Scenario("cal_b", 60, 600, 6, 4, distribution="uniform", seed=2),
        Scenario("cal_c", 120, 400, 4, 1, distribution="clustered", seed=3),
    ]
    prof = calibrate(("dense-ref", "brute"), scenarios=tiny, repeats=1, device="cpu")
    assert set(prof.models) == {"dense-ref", "brute", "slice"}
    assert prof.version == profiles.PROFILE_VERSION and prof.source == "calibrated"
    assert prof.hardware["platform"] == "cpu" and prof.meta["device"] == "cpu"
    assert len(prof.meta["measured"]["brute"]["t_verify_s"]) == len(tiny)
    m = models.FEATURE_NAMES.index("log_m")
    assert prof.models["brute"].verify.coef[m] == 0.0  # geometry-free
    s = models.WorkloadShape(100, 5000, 8, 4)
    path = str(tmp_path / "cal.json")
    prof.save(path)
    loaded = profiles.load_profile(path)
    for name in prof.models:
        t = loaded.predict_s(name, s)
        assert np.isfinite(t) and t > 0
        np.testing.assert_allclose(t, prof.predict_s(name, s), rtol=1e-12)
        np.testing.assert_allclose(jprofiles.load_profile(path).predict_s(name, _jshape(s)), t,
                                   rtol=1e-12)
    profiles.set_active_profile(loaded)
    F, U, _ = instance(139, M=50, N=300)
    res = _auto(F, U).query(1, 3)
    assert res.backend in ("dense-ref", "brute")
    np.testing.assert_array_equal(res.mask, rknn_brute_np(U, F, 1, 3))
