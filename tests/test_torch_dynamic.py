"""The port's dynamic-data subsystem against ``repro.dynamic``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

* ``UpdateBatch``, ``apply_to_points``, ``changed_positions``, the update
  stream generators and the refit functions (``scene_update_safe``,
  ``remap_scene``, ``refit_scene``) are host numpy: equal to the JAX
  package's bit for bit.
* After any seeded update sequence, every concrete backend of the port
  gives ``DynamicEngine`` masks and counts bit-identical to a cold port
  ``RkNNEngine`` on the final snapshot, and equal to the JAX
  ``DynamicEngine``'s off edge ties (``_torch_parity.edge_tie_mask``: the
  two packages round ``a*x + b*y + c`` differently) and, for ``brute``,
  off rank ties (``non_tie_mask``).  The JAX side runs ``dense-ref`` and
  ``grid-pallas-ref`` where the port runs ``dense`` and ``grid-pallas``
  (on the CPU the port's kernel backends run those plain versions; the
  JAX ones would run interpret-mode Pallas).
* The survive / refit / rebuild ladder fires, ``prepared_carries_users``
  keeps carried batches exact under user moves, continuous queries are
  exact (their counts equal a cold ``rank_counts_np`` and the JAX
  handles'), and the MVCC observability (spans, counters, gauges) is
  the JAX engine's.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import repro.dynamic as jd
import repro.dynamic.policy as jpolicy
import repro.workloads as jw
import repro_torch.dynamic as td
import repro_torch.dynamic.policy as tpolicy
import repro_torch.workloads as tw
from repro.core.backends import get_backend as j_get_backend
from repro.core.engine import RkNNConfig as JConfig
from repro.core.geometry import Rect as JRect
from repro.core.scene import build_scene as j_build_scene
from repro_torch.core.backends import concrete_backends, get_backend
from repro_torch.core.brute import rank_counts_np
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.scene import build_scene
from repro_torch.dynamic import DynamicEngine, UpdateBatch, apply_to_points
from repro_torch.obs import Tracer, set_tracer

from tests._torch_parity import CPU, edge_tie_mask

BACKENDS = ("dense", "dense-ref", "grid", "grid-pallas", "grid-pallas-ref", "bvh", "brute")
#: the JAX backend each port backend is compared with (see the docstring)
JAX_NAME = {"dense": "dense-ref", "grid-pallas": "grid-pallas-ref"}
BATCH_FIELDS = ("facility_insert", "facility_delete", "facility_move",
                "user_insert", "user_delete", "user_move")
#: UpdateReport counters that do not depend on the refit policy's timing
DETERMINISTIC = ("version", "rect_changed", "scenes_survived", "users_scattered",
                 "batches_carried", "continuous_patched", "continuous_skipped",
                 "continuous_events")


def _instance(seed, M=50, N=300, pin_hull=True):
    rng = np.random.default_rng(seed)
    F, U = rng.random((M, 2)), rng.random((N, 2))
    if pin_hull:  # corner facilities: interior churn never moves the rect
        F[:4] = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]
    return F, U, rng


def _random_batch(rng, F, U, *, protect=(), batch_cls=UpdateBatch):
    """One random mixed delta against the current snapshot (the JAX
    tests' ``tests/test_dynamic.py`` generator)."""
    protected = np.asarray(sorted(protect), np.int64)
    f_cand = np.setdiff1d(np.arange(4, len(F)), protected)
    n_fm = int(rng.integers(0, 3))
    n_fd = int(rng.integers(0, 2))
    picks = rng.choice(f_cand, size=min(n_fm + n_fd, len(f_cand)), replace=False)
    fm, fd = picks[:n_fm], picks[n_fm:]
    n_um = int(rng.integers(0, 20))
    um = rng.choice(len(U), size=n_um, replace=False)
    n_ud = int(rng.integers(0, 3))
    ud = np.setdiff1d(rng.choice(len(U), size=n_ud, replace=False), um)
    return batch_cls(
        facility_move=(fm, np.clip(F[fm] + rng.normal(0, 0.05, (len(fm), 2)), 0, 1)),
        facility_delete=fd,
        facility_insert=rng.random((int(rng.integers(0, 2)), 2)),
        user_move=(um, np.clip(U[um] + rng.normal(0, 0.02, (len(um), 2)), 0, 1)),
        user_delete=ud,
        user_insert=rng.random((int(rng.integers(0, 3)), 2)),
    )


def _shadow(F, U, batch):
    F, _ = apply_to_points(F, batch.facility_insert, batch.facility_delete, batch.facility_move)
    U, _ = apply_to_points(U, batch.user_insert, batch.user_delete, batch.user_move)
    return F, U


def _random_sequence(seed, steps, *, protect=(5, 9), M=40, N=200):
    """``(F, U, batches)``: ``steps`` random deltas, each drawn against the
    snapshot the previous ones produce."""
    F, U, rng = _instance(seed, M=M, N=N)
    batches, Fc, Uc = [], F, U
    for _ in range(steps):
        b = _random_batch(rng, Fc, Uc, protect=protect)
        batches.append(b)
        Fc, Uc = _shadow(Fc, Uc, b)
    return F, U, batches


def _to_jax(batch):
    return jd.UpdateBatch(**{f: getattr(batch, f) for f in BATCH_FIELDS})


def _same_batch(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype and u.shape == v.shape, f
            np.testing.assert_array_equal(u, v, err_msg=f)


def _same_report(a, b, fields=DETERMINISTIC):
    assert {f: getattr(a, f) for f in fields} == {f: getattr(b, f) for f in fields}
    # refit or dropped is the policy's (timed) choice; their sum is not
    assert a.scenes_refit + a.scenes_dropped == b.scenes_refit + b.scenes_dropped


def _rank_ties(U, F, q, eps=1e-6):
    """Users with a competitor at a near-tie distance to query ``q`` (a
    facility row, excluded from the competitors, or a point)."""
    if np.ndim(q) == 0:
        q_pt, comp = F[int(q)], np.delete(F, int(q), axis=0)
    else:
        q_pt, comp = np.asarray(q, np.float64), F
    d2 = np.sum((U[:, None, :] - comp[None, :, :]) ** 2, axis=-1)
    d2q = np.sum((U - q_pt) ** 2, axis=1)
    return np.any(np.abs(d2 - d2q[:, None]) < eps * (1.0 + d2q[:, None]), axis=1)


def _ties(U, F, q, scene, backend):
    """Users whose verdict may split between the packages for this query."""
    if backend == "brute":
        return _rank_ties(U, F, q)
    xs, ys = U[:, 0].astype(np.float32), U[:, 1].astype(np.float32)
    return edge_tie_mask(xs, ys, scene.coeffs[: scene.n_tris])


def _dyn(F, U, backend="dense-ref", **cfg):
    return DynamicEngine(F, U, RkNNConfig(backend=backend, **cfg), device=CPU)


def _cold(eng, backend):
    return RkNNEngine(eng.facilities, eng.users, RkNNConfig(backend=backend), device=CPU)


# ------------------------------------------------------- updates, generators
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_update_batches_apply_and_changed_positions_match_jax(seed):
    F, U, rng = _instance(seed, M=30, N=120)
    for _ in range(3):
        state = rng.bit_generator.state
        tb = _random_batch(rng, F, U)
        rng.bit_generator.state = state
        jb = _random_batch(rng, F, U, batch_cls=jd.UpdateBatch)
        _same_batch(tb, jb)
        assert (tb.touches_facilities, tb.touches_users, tb.is_empty) == (
            jb.touches_facilities, jb.touches_users, jb.is_empty)
        tb.validate(len(F), len(U))
        for pts, side in ((F, "facility"), (U, "user")):
            args = [getattr(tb, f"{side}_{w}") for w in ("insert", "delete", "move")]
            for a, b in zip(td.apply_to_points(pts, *args), jd.apply_to_points(pts, *args)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(td.changed_positions(tb, F), jd.changed_positions(jb, F))
        F, U = _shadow(F, U, tb)
    assert UpdateBatch().is_empty and jd.UpdateBatch().is_empty


@pytest.mark.parametrize(
    "bad,error",
    [
        (dict(facility_delete=[10_000]), IndexError),
        (dict(user_move=([-1], [[0.5, 0.5]])), IndexError),
        (dict(user_delete=[1], user_move=([1], [[0.5, 0.5]])), ValueError),
        (dict(facility_delete=[3, 3]), ValueError),
    ],
)
def test_update_validation_errors_match_jax(bad, error):
    F, U, _ = _instance(0)
    with pytest.raises(error):
        jd.UpdateBatch(**bad).validate(len(F), len(U))
    with pytest.raises(error):
        UpdateBatch(**bad).validate(len(F), len(U))
    dyn = _dyn(F, U)
    with pytest.raises(error):
        dyn.apply_updates(UpdateBatch(**bad))
    assert dyn.version == 0  # a refused delta publishes nothing
    with pytest.raises(ValueError):
        UpdateBatch(facility_move=([1, 2], [[0.1, 0.2]]))
    with pytest.raises(TypeError):
        dyn.apply_updates(UpdateBatch(), user_delete=[1])
    rep = dyn.apply_updates(UpdateBatch())
    assert rep.version == 1 and dyn.version == 1  # an empty delta still versions


@pytest.mark.parametrize(
    "gen,kw",
    [
        ("drifting_users", dict(frac=0.1, sigma=0.02)),
        ("drifting_users", dict(frac=0.5, bounds=(np.array([0.2, 0.2]), np.array([0.8, 0.8])))),
        ("facility_churn", dict(rate=0.1, protect=np.array([0, 1, 2, 3, 17]))),
        ("facility_jitter", dict(frac=0.2, sigma=1e-3, protect=np.array([5, 9]))),
    ],
)
@pytest.mark.parametrize("seed", [0, 7])
def test_update_stream_generators_match_jax(gen, kw, seed):
    F, U, _ = _instance(seed, M=60, N=300)
    pts = U if gen == "drifting_users" else F
    a = getattr(tw, gen)(pts, steps=4, seed=seed, **kw)
    b = getattr(jw, gen)(pts, steps=4, seed=seed, **kw)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert isinstance(x, UpdateBatch)
        _same_batch(x, y)


# ------------------------------------------------------------ refit functions
def _jrect(rect):
    return JRect(rect.xmin, rect.ymin, rect.xmax, rect.ymax)


def _scene_pair(F, q, k, rect):
    return build_scene(F, q, k, rect), j_build_scene(F, q, k, _jrect(rect))


def _same_scene(a, b):
    for f in ("tris", "coeffs", "owner", "keep", "heights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.n_tris, a.n_occluders) == (b.n_tris, b.n_occluders)
    np.testing.assert_array_equal(a.q, b.q)
    assert dataclasses.astuple(a.rect) == dataclasses.astuple(b.rect)
    sa, sb = vars(a.stats), vars(b.stats)
    assert sa.keys() == sb.keys()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


@pytest.mark.parametrize("case", ["far_insert", "delete_far", "jitter_kept", "move_query",
                                  "delete_kept", "jitter_unkept"])
def test_scene_survival_remap_and_refit_match_jax(case):
    F, U, rng = _instance(23, M=80, N=300)
    rect = Rect.from_points(F, U)
    q, k = 5, 6
    ts, js = _scene_pair(F, q, k, rect)
    _same_scene(ts, js)
    kept = np.flatnonzero(ts.keep)
    kept = kept[(kept >= 4) & (kept != q)]
    far = int(np.argmax(np.linalg.norm(F - F[q], axis=1)))
    unkept = np.setdiff1d(np.arange(4, len(F)), np.append(np.flatnonzero(ts.keep), q))
    batch = {
        "far_insert": UpdateBatch(facility_insert=[F[q] + 10.0 * ts.stats.safe_radius]),
        "delete_far": UpdateBatch(facility_delete=[far]),
        "jitter_kept": UpdateBatch(facility_move=(kept[:2], F[kept[:2]] + 1e-5)),
        "move_query": UpdateBatch(facility_move=([q], [F[q] + 1e-5])),
        "delete_kept": UpdateBatch(facility_delete=kept[:1]),
        "jitter_unkept": UpdateBatch(facility_move=(unkept[:3], F[unkept[:3]] + 1e-5)),
    }[case]
    changed = td.changed_positions(batch, F)
    assert td.scene_update_safe(ts, changed) == jd.scene_update_safe(js, changed)
    F2, map_f = td.apply_to_points(F, batch.facility_insert, batch.facility_delete,
                                   batch.facility_move)
    if td.scene_update_safe(ts, changed):
        _same_scene(td.remap_scene(ts, map_f, len(F2)), jd.remap_scene(js, map_f, len(F2)))
    moved_new = map_f[batch.facility_move[0]]
    q_new = int(map_f[q])
    a = td.refit_scene(ts, map_f, F2, q_new, k, rect, moved_new)
    b = jd.refit_scene(js, map_f, F2, q_new, k, _jrect(rect), moved_new)
    assert (a is None) == (b is None)
    if a is not None:
        _same_scene(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        _same_scene(a[0], build_scene(F2, q_new, k, rect))  # equals a cold build
    if case == "jitter_kept":
        assert a is not None and len(a[1])


# ------------------------------------------- cold-rebuild equivalence (property)
@pytest.fixture(scope="module")
def jax_runs():
    """The JAX ``DynamicEngine`` on each (seed, backend) sequence, run once."""
    cache = {}

    def run(seed, name):
        if (seed, name) not in cache:
            F, U, batches = _random_sequence(seed, 4)
            dyn = jd.DynamicEngine(F, U, JConfig(backend=name))
            dyn.query_batch([5, 9], 4)
            reports = []
            for b in batches:
                reports.append(dyn.apply_updates(_to_jax(b)))
                dyn.query_batch([5, 9], 4)
            qs = [5, 9, np.array([0.4, 0.6])]
            cache[seed, name] = (dyn.facilities, dyn.users, reports, dyn.query_batch(qs, 4),
                                 [dyn.query(q, 4) for q in qs])
        return cache[seed, name]

    return run


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_sequence_matches_cold_engine_and_jax(seed, backend, jax_runs):
    """After a seeded mixed update sequence: bit-identical to a cold port
    engine on the final snapshot (batch and single queries), and equal to
    the JAX dynamic engine's off ties, with its deterministic report
    counters."""
    F, U, batches = _random_sequence(seed, 4)
    qs, k = [5, 9, np.array([0.4, 0.6])], 4
    dyn = _dyn(F, U, backend)
    dyn.query_batch([5, 9], k)  # populate caches so migration has work
    reports = []
    for b in batches:
        F, U = _shadow(dyn.facilities, dyn.users, b)
        reports.append(dyn.apply_updates(b))
        np.testing.assert_array_equal(dyn.facilities, F)
        np.testing.assert_array_equal(dyn.users, U)
        dyn.query_batch([5, 9], k)  # interleaved: later migrations see warm caches
    assert dyn.version == len(batches)
    cold = _cold(dyn, backend)
    bd, bc = dyn.query_batch(qs, k), cold.query_batch(qs, k)
    np.testing.assert_array_equal(bd.masks, bc.masks)
    np.testing.assert_array_equal(bd.counts, bc.counts)
    assert bd.version == len(batches) and bc.version == 0
    singles = [dyn.query(q, k) for q in qs]
    for q, sd in zip(qs, singles):
        sc = cold.query(q, k)
        np.testing.assert_array_equal(sd.mask, sc.mask)
        np.testing.assert_array_equal(sd.counts, sc.counts)

    jF, jU, j_reports, jb, j_singles = jax_runs(seed, JAX_NAME.get(backend, backend))
    np.testing.assert_array_equal(jF, dyn.facilities)
    np.testing.assert_array_equal(jU, dyn.users)
    # the port's brute backend reads the snapshot's device users, so they
    # exist to scatter into; the JAX one reads the host array
    fields = tuple(f for f in DETERMINISTIC if backend != "brute" or f != "users_scattered")
    for a, b in zip(reports, j_reports):
        _same_report(a, b, fields)
    for i, q in enumerate(qs):
        scene = None if bd.scenes is None else bd.scenes[i]
        off = ~_ties(dyn.users, dyn.facilities, q, scene, backend)
        for got, want in ((bd.masks[i], jb.masks[i]), (bd.counts[i], jb.counts[i]),
                          (singles[i].mask, j_singles[i].mask),
                          (singles[i].counts, j_singles[i].counts)):
            np.testing.assert_array_equal(np.asarray(got)[off], np.asarray(want)[off])


# ------------------------------------------------------------ the cache ladder
def test_user_only_moves_keep_scenes_and_scatter_out_of_place():
    F, U, rng = _instance(11)
    dyn = _dyn(F, U)
    qs = [5, 9, 13]
    dyn.query_batch(qs, 4)
    old = dyn._snap
    old_xs, old_ys = old.xs.clone(), old.ys.clone()
    ids = rng.choice(len(U), 25, replace=False)
    pts = np.clip(U[ids] + rng.normal(0, 0.01, (25, 2)), 0.01, 0.99)
    rep = dyn.apply_updates(UpdateBatch(user_move=(ids, pts)))
    assert not rep.rect_changed
    assert rep.scenes_survived == 3 and rep.scenes_dropped == 0
    assert rep.users_scattered and dyn.update_stats.user_scatters == 1
    # the scatter is out of place: version 0's tensors are untouched, and
    # the new ones equal a cold upload of the new users bit for bit
    new = dyn._snap
    assert new.xs is not old.xs and new.ys is not old.ys
    assert torch.equal(old.xs, old_xs) and torch.equal(old.ys, old_ys)
    assert new.xs.device == old.xs.device and new.xs.dtype == torch.float32
    fresh = RkNNEngine(dyn.facilities, dyn.users, device=CPU)
    assert torch.equal(new.xs, fresh.xs) and torch.equal(new.ys, fresh.ys)
    # the users changed: the order and bucketing memo starts afresh
    assert new.kernel_memo is not old.kernel_memo
    # the scenes survive with their index stores, copied, not shared
    assert new.index_memo is not old.index_memo
    assert [id(x) for x in new.index_memo.scenes()] == [id(x) for x in old.index_memo.scenes()]
    assert all(new.index_memo.peek(x) is not old.index_memo.peek(x) for x in old.index_memo.scenes())
    # user-only move: the prepared batch is carried, re-pointed at the
    # scattered tensors — the repeat workload skips the whole filter phase
    assert rep.batches_carried >= 1
    b0 = dyn.stats.batch_cache_hits
    r = dyn.query_batch(qs, 4)
    assert dyn.stats.batch_cache_hits == b0 + 1
    cold = _cold(dyn, "dense-ref")
    np.testing.assert_array_equal(r.masks, cold.query_batch(qs, 4).masks)
    # a new batch composition misses the prepared LRU, but the surviving
    # scenes still hit the scene cache
    h0 = dyn.scene_cache.hits
    r2 = dyn.query_batch(qs[:2], 4)
    assert dyn.scene_cache.hits == h0 + 2
    np.testing.assert_array_equal(r2.masks, cold.query_batch(qs[:2], 4).masks)


def test_untouched_users_carry_tensors_and_memo_by_reference():
    F, U, _ = _instance(12)
    dyn = _dyn(F, U, "grid-pallas-ref")
    dyn.query_batch([5, 9], 4)
    old = dyn._snap
    rep = dyn.apply_updates(UpdateBatch(facility_insert=[[0.999, 0.998]]))
    new = dyn._snap
    assert new.version == 1 and not rep.users_scattered
    assert new._xs is old._xs and new._ys is old._ys
    assert new.kernel_memo is old.kernel_memo
    # inserts and deletes re-upload (lazily) instead of scattering
    dyn.apply_updates(UpdateBatch(user_insert=[[0.5, 0.5]], user_delete=[3]))
    assert dyn.update_stats.user_reuploads == 1 and dyn._snap._xs is None
    np.testing.assert_array_equal(
        dyn.query_batch([5, 9], 4).counts, _cold(dyn, "grid-pallas-ref").query_batch([5, 9], 4).counts)


def test_far_facility_change_survives_certificate():
    """A facility inserted far outside every query's pruning certificate
    leaves all cached scenes alive (and still bit-correct)."""
    F, U, _ = _instance(13)
    # queries clustered near the origin corner, insertion at the far corner
    F[5:8] = [[0.1, 0.1], [0.12, 0.08], [0.09, 0.13]]
    dyn = _dyn(F, U)
    qs = [5, 6, 7]
    dyn.query_batch(qs, 2)
    rep = dyn.apply_updates(UpdateBatch(facility_insert=[[0.999, 0.999]]))
    assert rep.scenes_survived == 3, rep
    assert dyn.scene_cache.delta_kept == 3 and dyn.scene_cache.delta_dropped == 0
    np.testing.assert_array_equal(
        dyn.query_batch(qs, 2).counts, _cold(dyn, "dense-ref").query_batch(qs, 2).counts
    )


def _refit_always(monkeypatch):
    """Pin both packages' refit policies to "refit" (their first choice is
    priced from a timed profile, later ones from measured times)."""
    for mod in (tpolicy, jpolicy):
        monkeypatch.setattr(
            mod.RefitPolicy, "price",
            lambda self, shape, n_changed, n_tris, mod=mod: mod.RefitDecision("refit", 0.0, 1.0))


@pytest.mark.parametrize("backend", ["grid", "grid-pallas", "grid-pallas-ref", "bvh"])
def test_near_jitter_refits_scene_and_indexes(backend, monkeypatch):
    _refit_always(monkeypatch)
    F, U, rng = _instance(17, M=80, N=400)
    dyn = _dyn(F, U, backend)
    dyn.query(5, 6)
    scene = dyn._build_scene(dyn._snap, 5, 6, dyn.rect)
    kept = np.flatnonzero(scene.keep)
    kept = kept[kept >= 4][:2]  # never jitter the hull-pinning corners
    jit = dyn.facilities[kept] + 1e-4
    rep = dyn.apply_updates(UpdateBatch(facility_move=(kept, jit)))
    assert rep.scenes_refit >= 1 and rep.indexes_refit >= 1, rep
    assert dyn.refit_policy.n_refit >= 1
    rd, rc = dyn.query(5, 6), _cold(dyn, backend).query(5, 6)
    np.testing.assert_array_equal(rd.counts, rc.counts)
    np.testing.assert_array_equal(rd.mask, rc.mask)


@pytest.mark.parametrize("action", ["refit", "rebuild"])
def test_refit_policy_prices_and_learns_like_jax(action):
    from repro.planner.models import WorkloadShape as JShape
    from repro_torch.planner.models import WorkloadShape

    t, j = tpolicy.RefitPolicy(), jpolicy.RefitPolicy()
    for dt in (0.5, 0.1, 0.3):
        t.observe(action, dt)
        j.observe(action, dt)
    assert (t.ema_refit_s, t.ema_rebuild_s, t.n_refit, t.n_rebuild) == (
        j.ema_refit_s, j.ema_rebuild_s, j.n_refit, j.n_rebuild)
    for n_changed in (0, 10, 100):
        shape = (1000, 5000, 10, 1)
        a = t.price(WorkloadShape(*shape, m_tris=100), n_changed, 100)
        b = j.price(JShape(*shape, m_tris=100), n_changed, 100)
        if action == "refit":
            # rebuild priced from each package's own profile prior
            assert a.predicted_refit_s == b.predicted_refit_s
        else:
            assert a.predicted_rebuild_s == b.predicted_rebuild_s
        assert a.action in ("refit", "rebuild")


def test_deleted_query_facility_drops_its_scenes_and_remaps_others():
    F, U, _ = _instance(19)
    dyn = _dyn(F, U)
    dyn.query(10, 3)
    dyn.query(20, 3)
    rep = dyn.apply_updates(UpdateBatch(facility_delete=[10]))
    assert rep.scenes_dropped >= 1
    # old row 20 is row 19 now; equivalence against a cold engine
    np.testing.assert_array_equal(
        dyn.query(19, 3).counts, _cold(dyn, "dense-ref").query(19, 3).counts
    )


@pytest.mark.parametrize("backend", ["grid-pallas", "grid-pallas-ref", "bvh", "dense"])
def test_facility_jitter_stream_stays_exact(backend):
    """Post-``refit_index`` states through the real update path: a dynamic
    engine absorbing facility jitter answers bit-identically to a cold
    engine at every version (the JAX ``tests/test_grid_pallas.py`` case,
    over every index backend)."""
    rng = np.random.default_rng(21)
    F = rng.random((40, 2))
    F[:4] = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]  # pin the hull
    U = rng.random((250, 2))
    qs = [5, 9]
    dyn = _dyn(F, U, backend)
    dyn.query_batch(qs, 4)  # warm caches so migration has work
    for batch in tw.facility_jitter(F, steps=3, frac=0.1, seed=2,
                                    protect=np.concatenate([np.arange(4), qs])):
        dyn.apply_updates(batch)
        got, want = dyn.query_batch(qs, 4), _cold(dyn, backend).query_batch(qs, 4)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.masks, want.masks)


@pytest.mark.parametrize("stream", ["drift_lo", "drift_hi", "fjitter", "fchurn"])
def test_generated_stream_reports_match_jax(stream, monkeypatch):
    """The bench's four update streams with the refit policy pinned: every
    counter of every report equals the JAX engine's, and every version's
    masks equal a cold port engine's."""
    _refit_always(monkeypatch)
    F, U, rng = _instance(7, M=60, N=250)
    qs, k = [6, 10, 14], 5
    protect = np.concatenate([np.arange(4), qs])
    batches = {
        "drift_lo": lambda: tw.drifting_users(U, steps=2, frac=0.02, seed=0),
        "drift_hi": lambda: tw.drifting_users(U, steps=2, frac=0.25, seed=1),
        "fjitter": lambda: tw.facility_jitter(F, steps=2, frac=0.05, seed=2, protect=protect),
        "fchurn": lambda: tw.facility_churn(F, steps=2, rate=0.05, seed=3, protect=protect),
    }[stream]()
    dyn = _dyn(F, U, "grid")
    jdyn = jd.DynamicEngine(F, U, JConfig(backend="grid"))
    dyn.query_batch(qs, k)
    jdyn.query_batch(qs, k)
    fields = tuple(f for f in vars(dyn.apply_updates(UpdateBatch())) if f != "t_update_s")
    jdyn.apply_updates(jd.UpdateBatch())
    for batch in batches:
        a, b = dyn.apply_updates(batch), jdyn.apply_updates(_to_jax(batch))
        _same_report(a, b, fields)
        got = dyn.query_batch(qs, k)
        np.testing.assert_array_equal(got.masks, _cold(dyn, "grid").query_batch(qs, k).masks)
        np.testing.assert_array_equal(got.masks, jdyn.query_batch(qs, k).masks)
    assert vars(dyn.update_stats).keys() == vars(jdyn.update_stats).keys()
    for f in vars(dyn.update_stats):
        if f != "t_update_s":
            assert getattr(dyn.update_stats, f) == getattr(jdyn.update_stats, f), f


# ------------------------------------------------ prepared_carries_users
def test_prepared_carries_users_flags_match_jax():
    for name in concrete_backends():
        b, jb = get_backend(name), j_get_backend(name)
        assert b.prepared_carries_users == jb.prepared_carries_users, name
        # only the cell-bucketed grid backends hold user coordinates
        assert b.prepared_carries_users == (name in ("grid-pallas", "grid-pallas-ref")), name


def _big_user_move(rng, U):
    ids = rng.choice(len(U), len(U) // 2, replace=False)
    return UpdateBatch(user_move=(ids, rng.random((len(ids), 2))))


@pytest.mark.parametrize("backend", ["grid-pallas", "grid-pallas-ref"])
def test_user_move_through_carried_grid_pallas_batch_equals_cold(backend, monkeypatch):
    """The cell buckets in a grid-pallas prepared batch are the users
    sorted by cell: a user move must not carry them.  With the flag True
    the repeat batch equals a cold engine; forced False, the carried
    buckets are stale and it does not (the check this test exists for)."""
    F, U, rng = _instance(61, M=40, N=300)
    qs, k = [5, 9, 13], 4
    move = _big_user_move(rng, U)

    def after_move():
        dyn = _dyn(F, U, backend)
        dyn.query_batch(qs, k)
        rep = dyn.apply_updates(move)
        return dyn, rep, dyn.query_batch(qs, k)

    dyn, rep, got = after_move()
    want = _cold(dyn, backend).query_batch(qs, k)
    assert rep.batches_carried == 0 and rep.users_scattered
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.masks, want.masks)

    monkeypatch.setattr(type(get_backend(backend)), "prepared_carries_users", False)
    _dyn_f, rep_f, stale = after_move()
    assert rep_f.batches_carried == 1
    assert not np.array_equal(stale.counts, want.counts)


@pytest.mark.parametrize("backend", ["dense", "dense-ref", "grid", "bvh"])
def test_carried_batches_stay_exact_under_user_moves(backend):
    """Backends whose prepared state is scene geometry only (planes, grid
    tables, BVH records) carry it across user moves, inserts and deletes:
    the users' order comes from the new snapshot's memo through the
    re-pointed request."""
    F, U, rng = _instance(62, M=40, N=300)
    qs, k = [5, 9, 13], 4
    dyn = _dyn(F, U, backend)
    dyn.query_batch(qs, k)
    for batch in (_big_user_move(rng, U),
                  UpdateBatch(user_insert=rng.random((7, 2)), user_delete=[0, 4, 8])):
        rep = dyn.apply_updates(batch)
        assert rep.batches_carried == 1
        hits = dyn.stats.batch_cache_hits
        got = dyn.query_batch(qs, k)
        assert dyn.stats.batch_cache_hits == hits + 1  # served from the carried batch
        want = _cold(dyn, backend).query_batch(qs, k)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.masks, want.masks)


# ------------------------------------------------------------- continuous
def test_continuous_query_exact_under_churn_and_equal_to_jax():
    F, U, rng = _instance(31, M=50, N=250)
    dyn = _dyn(F, U)
    jdyn = jd.DynamicEngine(F, U, JConfig(backend="dense-ref"))
    cq, cp = dyn.register_continuous(8, 4), dyn.register_continuous(np.array([0.3, 0.6]), 3)
    jq, jp = jdyn.register_continuous(8, 4), jdyn.register_continuous(np.array([0.3, 0.6]), 3)
    np.testing.assert_array_equal(cq.mask, rank_counts_np(U, F, F[8], exclude=8) < 4)
    versions = []
    for _ in range(5):
        batch = _random_batch(rng, dyn.facilities, dyn.users, protect=(8,))
        rep, jrep = dyn.apply_updates(batch), jdyn.apply_updates(_to_jax(batch))
        _same_report(rep, jrep)
        truth = rank_counts_np(
            dyn.users, dyn.facilities, dyn.facilities[cq.q_idx], exclude=cq.q_idx
        )
        np.testing.assert_array_equal(cq.counts, truth)  # bitwise-exact patching
        np.testing.assert_array_equal(cq.mask, truth < 4)
        np.testing.assert_array_equal(
            cp.counts, rank_counts_np(dyn.users, dyn.facilities, np.array([0.3, 0.6])))
        for h, j in ((cq, jq), (cp, jp)):
            np.testing.assert_array_equal(h.counts, j.counts)
            assert (h.q_idx, h.n_patched, h.n_skipped, h.n_full, h.n_events) == (
                j.q_idx, j.n_patched, j.n_skipped, j.n_full, j.n_events)
            assert [v for v, _ in h.poll()] == [v for v, _ in j.poll()]
        versions.append(dyn.version)
    assert cq.alive and cq.version == dyn.version
    assert versions == sorted(versions)


def test_continuous_query_skips_far_updates_and_emits_on_change_only():
    F, U, _ = _instance(37)
    F[5] = [0.1, 0.1]
    U_local = np.clip(np.random.default_rng(1).normal(0.1, 0.03, (100, 2)), 0.0, 0.3)
    dyn = _dyn(F, U_local)
    k = 1  # any adjacent facility steals q's nearest users
    cq = dyn.register_continuous(5, k)
    # far corner insert: provably outside the influence zone -> no event
    dyn.apply_updates(UpdateBatch(facility_insert=[[0.99, 0.99]]))
    assert cq.n_skipped == 1 and not cq.poll()
    # a facility dropped onto the query's doorstep must emit
    dyn.apply_updates(UpdateBatch(facility_insert=[[0.1, 0.11]]))
    events = cq.poll()
    assert len(events) == 1
    version, res = events[0]
    assert version == dyn.version and res.backend == "continuous"
    truth = rank_counts_np(dyn.users, dyn.facilities, dyn.facilities[5], exclude=5)
    np.testing.assert_array_equal(res.mask, truth < k)
    assert res.counts.dtype == np.int32


def test_vectorized_dirty_test_routes_handles(monkeypatch):
    """One batched influence-zone test decides per update which handles
    run the exact patch: provably clean handles never enter
    ``_on_update``, user deltas dirty every handle, and results stay
    bitwise-exact either way."""
    from repro_torch.dynamic.continuous import ContinuousQuery, influence_dirty_mask

    F, U, _ = _instance(45)
    F[5] = [0.1, 0.1]
    F[9] = [0.15, 0.12]
    U_local = np.clip(np.random.default_rng(2).normal(0.12, 0.03, (120, 2)), 0.0, 0.3)
    dyn = _dyn(F, U_local)
    h1 = dyn.register_continuous(5, 2)
    h2 = dyn.register_continuous(9, 2)

    calls = []
    orig = ContinuousQuery._on_update

    def spy(self, ctx):
        calls.append(self)
        return orig(self, ctx)

    monkeypatch.setattr(ContinuousQuery, "_on_update", spy)

    dyn.apply_updates(UpdateBatch(facility_insert=[[0.99, 0.99]]))
    assert calls == []
    assert h1.n_skipped == 1 and h2.n_skipped == 1
    assert h1.version == dyn.version and h2.version == dyn.version

    far, near = np.array([[0.99, 0.99]]), np.array([[0.1, 0.12]])
    assert not influence_dirty_mask([h1, h2], far).any()
    assert influence_dirty_mask([h1, h2], near).all()
    assert influence_dirty_mask([], near).shape == (0,)

    dyn.apply_updates(UpdateBatch(facility_insert=near))
    assert len(calls) == 2
    dyn.apply_updates(UpdateBatch(user_insert=[[0.2, 0.2]]))
    assert len(calls) == 4

    for h in (h1, h2):
        truth = rank_counts_np(dyn.users, dyn.facilities, dyn.facilities[h.q_idx],
                               exclude=h.q_idx)
        np.testing.assert_array_equal(h.counts, truth)


def test_clean_skip_still_remaps_tracked_facility(monkeypatch):
    from repro_torch.dynamic.continuous import ContinuousQuery

    F, U, _ = _instance(46)
    F[9] = [0.1, 0.1]
    U_local = np.clip(np.random.default_rng(3).normal(0.1, 0.02, (80, 2)), 0.0, 0.25)
    dyn = _dyn(F, U_local)
    cq = dyn.register_continuous(9, 3)
    monkeypatch.setattr(
        ContinuousQuery, "_on_update",
        lambda self, ctx: pytest.fail("clean handle entered the exact patch"),
    )
    far_row = int(np.argmax(np.linalg.norm(dyn.facilities - [0.1, 0.1], axis=1)))
    assert far_row < 9  # deletion shifts the tracked id down
    dyn.apply_updates(UpdateBatch(facility_delete=[far_row]))
    assert cq.q_idx == 8 and cq.n_skipped == 1
    truth = rank_counts_np(dyn.users, dyn.facilities, dyn.facilities[8], exclude=8)
    np.testing.assert_array_equal(cq.counts, truth)


def test_continuous_query_dies_with_its_facility_and_close_accounting():
    F, U, _ = _instance(41)
    dyn = _dyn(F, U)
    cq = dyn.register_continuous(7, 3)
    dyn.apply_updates(UpdateBatch(facility_delete=[7]))
    assert not cq.alive
    dyn.apply_updates(UpdateBatch(user_insert=[[0.5, 0.5]]))  # no crash
    assert cq not in dyn._continuous  # dead handles are dropped
    assert dyn.stats.continuous_pruned == 1

    cq = dyn.register_continuous(6, 2)
    rep = dyn.apply_updates(UpdateBatch(facility_insert=[dyn.facilities[6] + 1e-3]))
    assert rep.continuous_events == cq.n_events  # counter, not buffer length
    cq.close()
    assert not cq.alive and not cq.poll()
    n = cq.n_events
    dyn.apply_updates(UpdateBatch(facility_insert=[dyn.facilities[6] + 2e-3]))
    assert cq not in dyn._continuous and cq.n_events == n  # no longer maintained
    assert dyn.stats.continuous_pruned == 2


def test_continuous_point_query_and_moved_query_facility():
    F, U, _ = _instance(43)
    dyn = _dyn(F, U)
    cp = dyn.register_continuous(np.array([0.3, 0.3]), 4)
    cf = dyn.register_continuous(6, 4)
    dyn.apply_updates(UpdateBatch(facility_move=([6], [[0.7, 0.2]])))
    assert cf.n_full == 1  # its own facility moved: full recount
    t_pt = rank_counts_np(dyn.users, dyn.facilities, np.array([0.3, 0.3]))
    t_f = rank_counts_np(dyn.users, dyn.facilities, dyn.facilities[6], exclude=6)
    np.testing.assert_array_equal(cp.counts, t_pt)
    np.testing.assert_array_equal(cf.counts, t_f)
    res = cf.result()
    assert res.backend == "continuous" and res.counts.dtype == np.int32
    np.testing.assert_array_equal(res.mask, t_f < 4)


# ----------------------------------------------------------- observability
@pytest.fixture
def tracer():
    """A fresh enabled tracer installed as the port's global one."""
    t = Tracer(capacity=1 << 10)
    prev = set_tracer(t)
    t.enable()
    yield t
    set_tracer(prev)


def test_continuous_drop_and_prune_counters():
    rng = np.random.default_rng(11)
    F = rng.uniform(0, 100, (40, 2))
    U = rng.uniform(0, 100, (150, 2))
    eng = DynamicEngine(F, U, backend="grid", device=CPU)
    cq = eng.register_continuous(2, 2)
    # shrink the event buffer so drops are reachable in-test
    cq._events = collections.deque(cq._events, maxlen=1)
    for _ in range(6):
        eng.apply_updates(facility_move=(np.array([2]), rng.uniform(0, 100, (1, 2))))
    assert cq.events_dropped + len(cq._events) == cq.n_events
    assert cq.events_dropped > 0
    assert eng.stats.events_dropped == cq.events_dropped
    assert eng.metrics.snapshot()["continuous.events_dropped"] == cq.events_dropped
    cq.close()
    eng.apply_updates(user_move=(np.array([0]), rng.uniform(0, 100, (1, 2))))
    assert eng.stats.continuous_pruned == 1
    assert "events_dropped=" in repr(eng.stats)


def test_writer_throttle_duty_is_zero_when_idle_and_version_metrics():
    rng = np.random.default_rng(13)
    F = rng.uniform(0, 100, (40, 2))
    U = rng.uniform(0, 100, (150, 2))
    eng = DynamicEngine(F, U, backend="grid", device=CPU)
    eng.query(1, k=2)
    eng.apply_updates(facility_move=(np.array([4]), rng.uniform(0, 100, (1, 2))))
    snap = eng.metrics.snapshot()
    # no concurrent reader bumped the clock mid-update: duty must be 0
    assert snap.get("mvcc.writer_throttle_duty", 0.0) == 0.0
    assert snap["mvcc.version"] == 1.0
    # a reader holding version 0 while version 1 is published lags by 1
    old = eng._snap
    eng.apply_updates(UpdateBatch())
    eng._query_batch(old, [1], 2)
    assert eng.metrics.snapshot()["mvcc.version_lag"] == 1.0
    eng.query_batch([1], 2)
    assert eng.metrics.snapshot()["mvcc.version_lag"] == 0.0


def test_update_spans_recorded(tracer):
    rng = np.random.default_rng(17)
    F = rng.uniform(0, 100, (40, 2))
    U = rng.uniform(0, 100, (150, 2))
    eng = DynamicEngine(F, U, backend="grid", device=CPU)
    eng.query(1, k=2)  # standing scene -> migrate has work to do
    eng.apply_updates(facility_move=(np.array([1]), rng.uniform(0, 100, (1, 2))))
    names = {r["name"] for r in tracer.records()}
    assert "update" in names and "migrate" in names
    # the query facility moved: its scene is dropped and prewarmed
    assert {"prewarm", "prewarm-scene", "scene-build"} <= names
    upd = next(r for r in tracer.records() if r["name"] == "update")
    assert upd["attrs"]["version"] == 1


def test_read_clock_and_flight_hook_on_every_entry_point():
    """Each query entry point bumps the lock-free read clock (the writer's
    contention signal) and hands an exception to ``_flight_exception``,
    which with no recorder armed does nothing and lets it propagate."""
    F, U, _ = _instance(3, M=30, N=100)
    eng = RkNNEngine(F, U, backend="dense-ref", device=CPU)
    assert eng._read_clock == 0 and eng.flight is None
    eng.query(1, 2)
    eng.query_batch([1, 2], 2)
    eng.query_mono(1, 2)
    list(eng.stream([[1], [2]], 2))
    assert eng._read_clock == 5  # one per stream batch
    seen = []
    eng._flight_exception = lambda where, exc: seen.append(where)
    for call in (lambda: eng.query(10_000, 2), lambda: eng.query_batch([10_000], 2),
                 lambda: eng.query_mono(10_000, 2), lambda: list(eng.stream([[10_000]], 2))):
        with pytest.raises(IndexError):
            call()
    assert seen == ["query", "query_batch", "query_mono", "stream"]
    snap = eng._make_snapshot(3, F, U, scene_cache=None)
    assert snap.version == 3 and snap.scene_cache is None and not snap.explicit_rect
