"""The port's sharded serving against ``repro.shard``, on the CPU.

Inputs are made with numpy from a seed (the JAX tests' instance,
``tests/test_shard.py::_instance``: M = 36, N = 420, k = 4) and handed to
both packages.

* ``repro_torch.shard.ShardedEngine(device="cpu")`` at 1, 2 and 4 shards,
  for every backend of the port: masks equal to the JAX ``ShardedEngine``'s
  exactly, counts off edge ties (``_torch_parity.edge_tie_mask``: the two
  packages round ``a*x + b*y + c`` differently) and, for ``brute``, off
  rank ties; and masks and counts bit-identical to the meshless port
  engine, with no tie rule.  The JAX side runs ``dense-ref`` and
  ``grid-pallas-ref`` where the port runs ``dense`` and ``grid-pallas``
  (on the CPU the port's kernel backends run those plain versions).  For
  ``auto`` only masks are compared: the planner may split a batch
  differently on a sharded engine, and count semantics differ per
  backend.
* The same after an update stream (moves, churn, facility jitter), against
  the JAX ``ShardedEngine`` taken through it and a cold port engine.
* The host helpers (``_spatial_perm``, ``user_shard_bounds``, ``tree_psum``,
  ``assemble_counts``, ``result_sizes``) equal JAX's; the reassembly of the
  dispatch equals ``assemble_counts``.
* Version lockstep, the carries of the copy-on-write update path, the
  single-query and stream paths, ``explain()``'s shard records, the
  engine's own ``mesh=`` path (several row slabs on the CPU), the
  ``RkNNServer`` alias, and the engines' ``metrics.snapshot()`` keys
  (``pad_waste`` and the seven ``mem.bytes`` gauges included) equal to
  JAX's.
"""

import warnings

import numpy as np
import pytest
import torch

import repro.dynamic as jd
import repro.shard as js
import repro.shard.engine as js_engine
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.distributed.sharding import user_shard_bounds as j_user_shard_bounds
from repro_torch.core.backends import available_backends, concrete_backends, get_backend
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.distributed.sharding import user_shard_bounds
from repro_torch.dynamic import DynamicEngine, UpdateBatch
from repro_torch.launch import serve
from repro_torch.shard import (
    ShardedEngine,
    assemble_counts,
    mesh_shards,
    result_sizes,
    shard_devices,
    tree_psum,
    user_mesh,
)
from repro_torch.shard import engine as t_engine

from tests._torch_parity import CPU, edge_tie_mask

SHARD_COUNTS = (1, 2, 4)
K = 4
#: the JAX backend each port backend is compared with (see the docstring)
JAX_NAME = {"dense": "dense-ref", "grid-pallas": "grid-pallas-ref"}


def _instance(seed, M=36, N=420):
    rng = np.random.default_rng(seed)
    F = rng.random((M, 2))
    F[:4] = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]  # pin the hull
    U = rng.random((N, 2))
    # mixed facility-index and point queries
    qs = [0, 7, np.array([0.5, 0.5]), 13, np.array([0.21, 0.77]), 5]
    return F, U, qs, rng


def _sharded(F, U, backend, shards, **kw):
    return ShardedEngine(F, U, RkNNConfig(backend=backend), shards=shards, device=CPU, **kw)


def _engine(F, U, backend, **kw):
    return RkNNEngine(F, U, RkNNConfig(backend=backend), device=CPU, **kw)


def _rank_ties(U, F, q, eps=1e-6):
    """Users with a competitor at a near-tie distance to query ``q``."""
    if np.ndim(q) == 0:
        q_pt, comp = F[int(q)], np.delete(F, int(q), axis=0)
    else:
        q_pt, comp = np.asarray(q, np.float64), F
    d2 = np.sum((U[:, None, :] - comp[None, :, :]) ** 2, axis=-1)
    d2q = np.sum((U - q_pt) ** 2, axis=1)
    return np.any(np.abs(d2 - d2q[:, None]) < eps * (1.0 + d2q[:, None]), axis=1)


def _same_as_jax(got, want, U, F, qs, backend):
    """Masks exact; counts off edge ties (rank ties for ``brute``); for
    ``auto`` masks only."""
    np.testing.assert_array_equal(got.masks, np.asarray(want.masks))
    if backend not in concrete_backends():
        return
    for i, q in enumerate(qs):
        if backend == "brute":
            ties = _rank_ties(U, F, q)
        else:
            sc = got.scenes[i]
            ties = edge_tie_mask(U[:, 0].astype(np.float32), U[:, 1].astype(np.float32),
                                 sc.coeffs[: sc.n_tris])
        np.testing.assert_array_equal(got.counts[i][~ties], np.asarray(want.counts[i])[~ties])


def _bit_identical(a, b):
    np.testing.assert_array_equal(a.masks, b.masks)
    np.testing.assert_array_equal(a.counts, b.counts)


# ---------------------------------------------------------------------------
# the core property: backends x shard counts, against JAX and the meshless port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("backend", available_backends())
def test_sharded_matches_jax_and_meshless_engine(backend, shards):
    F, U, qs, _ = _instance(11)
    got = _sharded(F, U, backend, shards).query_batch(qs, K)
    want = js.ShardedEngine(F, U, backend=JAX_NAME.get(backend, backend),
                            shards=shards).query_batch(qs, K)
    _same_as_jax(got, want, U, F, qs, backend)
    oracle = _engine(F, U, backend).query_batch(qs, K)
    np.testing.assert_array_equal(got.masks, oracle.masks)
    if backend in concrete_backends():
        np.testing.assert_array_equal(got.counts, oracle.counts)


def _stream_updates(eng, F, U, rng, batch_cls):
    """The update stream of the JAX ``test_sharded_matches_after_update_stream``."""
    mv = 100 + rng.choice(len(U) - 100, 25, replace=False)
    eng.apply_updates(batch_cls(user_move=(mv, rng.random((25, 2)))))
    yield
    eng.apply_updates(
        batch_cls(user_insert=rng.uniform(0.2, 0.8, (12, 2)), user_delete=np.arange(8))
    )
    fb = np.array([17, 23, 29])
    eng.apply_updates(batch_cls(facility_move=(fb, np.clip(F[fb] + 0.03, 0, 1))))


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("backend", available_backends())
def test_sharded_matches_after_update_stream(backend, shards):
    F, U, qs, rng = _instance(23)
    jrng = np.random.default_rng()
    jrng.bit_generator.state = rng.bit_generator.state  # one stream for both
    eng = _sharded(F, U, backend, shards)
    jeng = js.ShardedEngine(F, U, backend=JAX_NAME.get(backend, backend), shards=shards)
    for e, r, cls in ((eng, rng, UpdateBatch), (jeng, jrng, jd.UpdateBatch)):
        e.query_batch(qs, K)  # warm caches so the carry has work to do
        for _ in _stream_updates(e, F, U, r, cls):
            e.query_batch(qs, K)
    np.testing.assert_array_equal(eng.facilities, jeng.facilities)
    np.testing.assert_array_equal(eng.users, jeng.users)
    got = eng.query_batch(qs, K)
    assert got.version == 3
    if backend in concrete_backends() and backend != "brute":  # lockstep
        st = eng._snap.shard_state
        assert st is not None and st.version == eng.version
        assert all(v.version == eng.version for v in st.views)
    _same_as_jax(got, jeng.query_batch(qs, K), eng.users, eng.facilities, qs, backend)
    cold = _engine(eng.facilities, eng.users, backend).query_batch(qs, K)
    np.testing.assert_array_equal(got.masks, cold.masks)
    if backend in concrete_backends():
        np.testing.assert_array_equal(got.counts, cold.counts)


def test_single_query_and_stream_paths_match(shards=3):
    F, U, qs, _ = _instance(5)
    oracle = _engine(F, U, "grid-pallas")
    eng = _sharded(F, U, "grid-pallas", shards)
    jeng = js.ShardedEngine(F, U, backend="grid-pallas-ref", shards=shards)
    for q in qs:
        a, b = oracle.query(q, K), eng.query(q, K)  # single queries do not shard
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(b.mask, jeng.query(q, K).mask)
    batches = [qs[:3], qs[3:], qs]
    ref = [m for _, m in oracle.stream(batches, K)]
    got = [m for _, m in eng.stream(batches, K)]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    assert len([e for e in eng.explain() if e.get("mode") == "shard-batch"]) == 3


# ---------------------------------------------------------------------------
# host helpers and the reassembly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 23, 5, 7])
def test_spatial_perm_and_bounds_equal_jax(seed):
    F, U, _, _ = _instance(seed)
    rect = _engine(F, U, "dense").rect
    jrect = JEngine(F, U).rect
    for g in (1, 8, 64):
        np.testing.assert_array_equal(t_engine._spatial_perm(U, rect, g),
                                      js_engine._spatial_perm(U, jrect, g))
    for n in (0, 1, 5, 97, 420):
        for s in (1, 2, 3, 4, 7):
            b = user_shard_bounds(n, s)
            assert b.dtype == np.int64
            np.testing.assert_array_equal(b, j_user_shard_bounds(n, s))


def test_reductions_equal_jax():
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 100, 17).astype(np.int64) for _ in range(5)]
    np.testing.assert_array_equal(tree_psum(parts), js.tree_psum(parts))
    np.testing.assert_array_equal(tree_psum(parts), np.sum(parts, axis=0))
    with pytest.raises(ValueError):
        tree_psum([])
    n, q, s = 103, 3, 4
    full = rng.integers(0, 9, (q, n)).astype(np.int32)
    perm = rng.permutation(n)
    bounds = user_shard_bounds(n, s)
    slabs = [full[:, perm[bounds[i] : bounds[i + 1]]] for i in range(s)]
    got = assemble_counts(slabs, perm, bounds, n)
    np.testing.assert_array_equal(got, js.assemble_counts(slabs, perm, bounds, n))
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(result_sizes(slabs, 5), js.result_sizes(slabs, 5))
    np.testing.assert_array_equal(result_sizes(slabs, 5), (full < 5).sum(axis=1))


@pytest.mark.parametrize("backend", ["dense", "grid", "grid-pallas", "bvh"])
def test_dispatch_reassembly_equals_assemble_counts(backend):
    """The dispatch's scatter on the device equals ``assemble_counts`` of
    the per-shard slabs (each counted alone in its view's order), and its
    psum-reduced result sizes the slabs' ``result_sizes``."""
    F, U, qs, _ = _instance(7)
    eng = _sharded(F, U, backend, 3)
    got = eng.query_batch(qs, K)
    st = eng._snap.shard_state
    b = get_backend(backend)
    req, prepared, _ = eng._snap.batch_cache.items()[-1][1]
    kind, payload = prepared
    slabs = []
    for i, view in enumerate(st.views):
        if kind == "shard":
            slab = b.count_batch_device(None, payload[i][0])
        else:
            slab = b.count_batch_device(req.dispatch._request(view), payload)
        assert slab.shape == (len(qs), view.n_users)
        slabs.append(slab.numpy())
    np.testing.assert_array_equal(got.counts, assemble_counts(slabs, st.perm, st.bounds, len(U)))
    rec = [e for e in eng.explain() if e.get("mode") == "shard-batch"][-1]
    assert rec["result_sizes"] == [int(x) for x in result_sizes(slabs, K)]
    assert rec["result_sizes"] == [int(m.sum()) for m in got.masks]


# ---------------------------------------------------------------------------
# version lockstep + copy-on-write shard-state carries
# ---------------------------------------------------------------------------


def test_shard_state_version_lockstep():
    F, U, qs, rng = _instance(7)
    eng = _sharded(F, U, "dense", 4)
    eng.query_batch(qs, K)
    st = eng._snap.shard_state
    assert st is not None and st.version == eng.version
    assert all(v.version == st.version for v in st.views)
    assert sum(v.n_users for v in st.views) == len(U)
    for v in st.views:  # a view's users are its rows of the user set
        np.testing.assert_array_equal(v.users, U[st.perm[v.lo : v.hi]])
        np.testing.assert_array_equal(v.rows.numpy(), st.perm[v.lo : v.hi])
        assert torch.equal(v.xs, torch.from_numpy(v.users[:, 0].astype(np.float32)))

    # pure move: out-of-place scatter, same partition, new version stamp;
    # the moved views get new tensors and a fresh memo, the others carry
    mv = rng.choice(len(U), 10, replace=False)
    old_xs = [v.xs.clone() for v in st.views]
    eng.apply_updates(user_move=(mv, rng.random((10, 2))))
    st2 = eng._snap.shard_state
    assert st2 is not None and st2.version == eng.version
    assert st2.perm is st.perm  # partition carried, not rebuilt
    assert all(v.version == st2.version for v in st2.views)
    moved = set(np.searchsorted(st.bounds, st.pos[mv], side="right") - 1)
    for a, b, x0 in zip(st.views, st2.views, old_xs):
        assert torch.equal(a.xs, x0)  # version N's tensors untouched
        if a.index in moved:
            assert b.xs is not a.xs and b.memo is not a.memo
        else:
            assert b.xs is a.xs and b.ys is a.ys and b.memo is a.memo
        np.testing.assert_array_equal(b.users, eng.users[st.perm[b.lo : b.hi]])
        assert torch.equal(b.xs, torch.from_numpy(b.users[:, 0].astype(np.float32)))
    _bit_identical(eng.query_batch(qs, K),
                   _engine(eng.facilities, eng.users, "dense").query_batch(qs, K))

    # facility-only delta: user tensors carried by reference, re-stamped
    eng.apply_updates(facility_move=(np.array([9]), np.array([[0.4, 0.4]])))
    st3 = eng._snap.shard_state
    assert st3 is not None and st3.version == eng.version
    assert all(a.xs is b.xs and a.memo is b.memo for a, b in zip(st2.views, st3.views))

    # shape change: the partition is stale — rebuilt lazily on next query
    eng.apply_updates(user_insert=rng.uniform(0.3, 0.7, (6, 2)))
    assert eng._snap.shard_state is None
    eng.query_batch(qs, K)
    st4 = eng._snap.shard_state
    assert st4 is not None and st4.n_users == len(U) + 6
    assert st4.version == eng.version
    summary = st4.summary()
    assert summary["n_users"] == len(U) + 6 and len(summary["shards"]) == 4
    assert summary["shards"][0]["device"] == "cpu" and summary["imbalance"] >= 1.0


def test_per_shard_stats_and_explain_records_match_jax():
    F, U, qs, _ = _instance(3)
    eng = _sharded(F, U, "grid-pallas", 4)
    jeng = js.ShardedEngine(F, U, backend="grid-pallas-ref", shards=4)
    eng.query_batch(qs, K)
    jeng.query_batch(qs, K)
    assert len(eng.stats.shard_verify_s) == 4
    assert len(eng.stats.shard_filter_s) == 4
    assert any(t > 0 for t in eng.stats.shard_verify_s)
    assert eng.stats.shard_imbalance >= 1.0
    assert "shard_imbalance=" in repr(eng.stats)
    recs = [e for e in eng.explain() if e.get("mode") == "shard-batch"]
    jrecs = [e for e in jeng.explain() if e.get("mode") == "shard-batch"]
    assert recs and set(recs[-1]) == set(jrecs[-1])
    rec = recs[-1]
    assert rec["shards"] == 4 and rec["backend"] == "grid-pallas"
    assert sum(rec["per_shard_users"]) == len(U)
    assert rec["per_shard_users"] == jrecs[-1]["per_shard_users"]
    assert len(rec["per_shard_verify_s"]) == 4
    got = eng.query_batch(qs, K)
    recs2 = [e for e in eng.explain() if e.get("mode") == "shard-batch"]
    assert recs2[-1]["result_sizes"] == [int(m.sum()) for m in got.masks]
    # the per-shard views keep their own memo: the snapshot's holds nothing
    # of theirs (the user tensors it was keyed on never went through it)
    st = eng._snap.shard_state
    assert all(len(v.memo.items()) >= 2 for v in st.views)  # buckets + their dest
    assert not eng._snap.kernel_memo.items()


@pytest.mark.parametrize("backend", ["dense", "grid", "bvh"])
def test_batch_cache_carry_across_user_churn(backend):
    """The prepared-batch LRU survives user insert/delete for backends
    whose prepared state is scene-only; the carried request's dispatch is
    re-pointed at the new snapshot."""
    F, U, qs, rng = _instance(13)
    eng = _sharded(F, U, backend, 2)
    eng.query_batch(qs, K)
    h0 = eng.stats.batch_cache_hits
    old = eng._snap.batch_cache.items()[-1][1][0].dispatch
    rep = eng.apply_updates(user_insert=rng.uniform(0.2, 0.8, (9, 2)))
    assert rep.batches_carried > 0
    carried = eng._snap.batch_cache.items()[-1][1][0].dispatch
    assert carried is not old and carried.state.version == eng.version
    got = eng.query_batch(qs, K)
    assert eng.stats.batch_cache_hits > h0
    _bit_identical(got, _engine(eng.facilities, eng.users, backend).query_batch(qs, K))


def test_brute_is_not_sharded_and_auto_prices_the_shards():
    F, U, qs, _ = _instance(11)
    eng = _sharded(F, U, "brute", 4)
    got = eng.query_batch(qs, K)
    assert not [e for e in eng.explain() if e.get("mode") == "shard-batch"]
    assert eng._snap.shard_state is None
    _bit_identical(got, _engine(F, U, "brute").query_batch(qs, K))
    auto = _sharded(F, U, "auto", 4)
    auto.query_batch(qs, K)
    assert auto._workload_shards() == 4


# ---------------------------------------------------------------------------
# mesh + devices
# ---------------------------------------------------------------------------


def test_user_mesh_and_devices():
    mesh = user_mesh(3, devices=[CPU] * 3)
    assert mesh_shards(mesh) == 3 and mesh.axis_names == ("users",)
    assert mesh.shape == {"users": 3}
    assert shard_devices(3, mesh) == [CPU] * 3
    assert shard_devices(5, device="cpu") == [CPU] * 5
    with pytest.raises(ValueError):
        shard_devices(2, mesh)
    with pytest.raises(ValueError):
        user_mesh(4, devices=[CPU] * 3)
    F, U, qs, _ = _instance(2, M=20, N=64)
    eng = ShardedEngine(F, U, RkNNConfig(backend="dense"), mesh=mesh, device=CPU)
    assert eng.n_shards == 3
    with pytest.raises(ValueError):
        ShardedEngine(F, U, mesh=mesh, shards=4, device=CPU)
    assert ShardedEngine(F, U, device=CPU).n_shards == 1


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is served")
    F, U, _, _ = _instance(2, M=20, N=64)
    with pytest.raises(RuntimeError, match="cuda"):
        shard_devices(2)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedEngine(F, U, shards=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedEngine(F, U)
    with pytest.raises(ValueError):
        user_mesh(1)  # no card visible
    with pytest.raises(RuntimeError, match="cuda"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        serve.RkNNServer(F, U)


@pytest.mark.parametrize("backend", ["dense", "dense-ref", "grid", "bvh", "grid-pallas", "brute"])
def test_engine_mesh_path_matches_meshless_engine(backend):
    """The engine's own ``mesh=`` path: users cut in row order into three
    slabs (N not a multiple of 3), bit-identical to the meshless engine
    through ``query_batch``, ``stream`` and ``auto``'s groups; backends it
    does not serve take the single-device dispatch."""
    F, U, qs, _ = _instance(89, N=257)
    mesh = user_mesh(3, devices=[CPU] * 3)
    eng = _engine(F, U, backend, mesh=mesh)
    plain = _engine(F, U, backend)
    snap = eng._snap
    assert [x.shape[0] for x in snap.mesh_xs] == [85, 86, 86] and snap.mesh_n == 257
    a, b = eng.query_batch(qs, K), plain.query_batch(qs, K)
    _bit_identical(a, b)
    req = snap.batch_cache.items()[-1][1][0] if get_backend(backend).uses_scene else None
    sharded = backend in ("dense", "dense-ref", "grid", "bvh")
    if req is not None:
        assert (req.dispatch is not None) == sharded and (req.xs is None) == sharded
    for _qb, masks in eng.stream([qs], K):
        np.testing.assert_array_equal(masks, b.masks)


def test_dynamic_engine_with_mesh_scatters_and_stays_exact():
    F, U, _, rng = _instance(59, M=40, N=256)
    mesh = user_mesh(2, devices=[CPU] * 2)
    dyn = DynamicEngine(F, U, RkNNConfig(backend="dense"), mesh=mesh, device=CPU)
    qs = [5, 9, 13, 17]
    dyn.query_batch(qs, 4)
    old = dyn._snap
    ids = rng.choice(128, 16, replace=False)  # the first slab only
    pts = np.clip(U[ids] + rng.normal(0, 0.01, (16, 2)), 0.01, 0.99)
    rep = dyn.apply_updates(UpdateBatch(user_move=(ids, pts)))
    new = dyn._snap
    assert rep.batches_carried >= 1
    assert new.mesh_xs[0] is not old.mesh_xs[0] and new.mesh_memos[0] is not old.mesh_memos[0]
    assert new.mesh_xs[1] is old.mesh_xs[1] and new.mesh_memos[1] is old.mesh_memos[1]
    assert torch.equal(torch.cat(new.mesh_xs), torch.from_numpy(dyn.users[:, 0].astype(np.float32)))
    cold = _engine(dyn.facilities, dyn.users, "dense")
    _bit_identical(dyn.query_batch(qs, 4), cold.query_batch(qs, 4))
    # a facility-only delta carries the slabs; a shape-changing one re-cuts them
    dyn.apply_updates(UpdateBatch(facility_move=(np.array([9]), np.array([[0.4, 0.4]]))))
    assert dyn._snap.mesh_xs is new.mesh_xs
    dyn.apply_updates(UpdateBatch(user_insert=[[0.5, 0.5], [0.6, 0.6], [0.4, 0.4]]))
    assert [x.shape[0] for x in dyn._snap.mesh_xs] == [129, 130]
    cold = _engine(dyn.facilities, dyn.users, "dense")
    _bit_identical(dyn.query_batch(qs, 4), cold.query_batch(qs, 4))


# ---------------------------------------------------------------------------
# the RkNNServer alias
# ---------------------------------------------------------------------------


def test_rknn_server_alias_matches_engine(monkeypatch):
    F, U, qs, _ = _instance(31)
    q_idx = [0, 7, 13, 5]
    monkeypatch.setattr(serve, "_deprecation_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        server = serve.RkNNServer(F, U, device=CPU)
        serve.RkNNServer(F, U, device=CPU, mesh=user_mesh(2, devices=[CPU] * 2))
    assert sum(issubclass(w.category, DeprecationWarning) for w in caught) == 1
    assert server.engine.config.backend == "dense" and server.pad == 128
    eng = _engine(F, U, "dense")
    want = eng.query_batch(q_idx, K)
    np.testing.assert_array_equal(server.query_batch(q_idx, K), want.masks)
    for (_b, m), w in zip(server.serve_stream([q_idx[:2], q_idx[2:]], K),
                          (want.masks[:2], want.masks[2:])):
        np.testing.assert_array_equal(m, w)
    st = server.stats
    assert isinstance(st, serve.ServeStats)
    assert st.n_queries == 8 and st.m_max == eng.stats.m_max
    assert st.t_scene_s > 0 and st.t_device_s > 0
    coeffs = eng._snap.batch_cache.items()[0][1][1]  # the batch's stacked scenes
    xs, ys = (torch.from_numpy(U[:, i].astype(np.float32)) for i in (0, 1))
    np.testing.assert_array_equal(serve.batched_raycast_counts(xs, ys, coeffs).numpy(),
                                  want.counts)


# ---------------------------------------------------------------------------
# metrics: the JAX keys, and the memory walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["engine", "dynamic", "sharded"])
def test_metrics_snapshot_keys_equal_jax(kind):
    F, U, qs, _ = _instance(11)
    port = {"engine": RkNNEngine, "dynamic": DynamicEngine, "sharded": ShardedEngine}[kind]
    ref = {"engine": JEngine, "dynamic": jd.DynamicEngine, "sharded": js.ShardedEngine}[kind]
    kw = {"shards": 2} if kind == "sharded" else {}
    for backend in ("dense-ref", "grid-pallas-ref", "bvh"):
        t = port(F, U, RkNNConfig(backend=backend), device=CPU, **kw)
        j = ref(F, U, JConfig(backend=backend), **kw)
        keys = []
        for e in (t, j):
            e.query_batch(qs, K)
            e.query(3, K)
            keys.append(set(e.metrics.snapshot()))
        assert keys[0] == keys[1], backend
        assert "pad_waste" in keys[0]
        assert {f"mem.bytes{{category={c}}}" for c in
                ("users", "shards", "indexes", "kernel", "batches", "scenes", "total")} <= keys[0]


def test_device_bytes_total_and_carried_tensors_counted_once():
    F, U, qs, rng = _instance(7)
    eng = _sharded(F, U, "grid-pallas", 2)
    eng.query_batch(qs, K)
    eng.query_batch(qs, K, backend="dense")
    by = eng._snap.device_bytes()
    assert set(by) == {"users", "shards", "scenes", "indexes", "kernel", "batches", "total"}
    assert by["total"] == sum(v for c, v in by.items() if c != "total")
    assert by["shards"] > 0 and by["users"] >= U.nbytes + F.nbytes
    snap = eng.metrics.snapshot()
    assert snap["mem.bytes{category=total}"] == float(by["total"])
    # a facility-only delta carries every view by reference: the new
    # version's walk charges each carried tensor once, as the old one did
    eng.apply_updates(facility_move=(np.array([9]), np.array([[0.4, 0.4]])))
    new = eng._snap.device_bytes()
    assert new["shards"] == by["shards"]
    view = eng._snap.shard_state.views[0]
    seen: set = set()
    from repro_torch.core.snapshot import _nbytes_walk

    once = _nbytes_walk([view.xs, view.xs, (view.xs, [view.xs])], seen)
    assert once == view.xs.nbytes
