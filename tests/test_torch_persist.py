"""The port's persistence (``repro_torch.checkpoint``, ``repro_torch.persist``)
on the CPU, against the JAX package's ``rknn-store/1``.

Engines run on ``device="cpu"``.  Tolerances: masks, counts and
fingerprints exact; against the JAX package, counts exact off edge ties
(``tests/_torch_parity.py`` ``edge_tie_mask``: the packages round
``a*x + b*y + c`` differently at a knife-edge).

* crash mid-write: stranded ``.tmp`` steps and steps with a lost leaf
  are skipped; the checkpoint's leaf paths are JAX's;
* save → warm start → query bit-identical to cold, for every concrete
  backend × shards {1, 4}, and again after an update step on both;
* a fresh interpreter (a fresh hash salt) restores without a rebuild;
* per-category invalidation, schema rejection, MVCC hot adopt (N+1);
* ``expected_fingerprints`` equal to JAX's on every category but
  ``planner``, which is salted with the package name (a JAX profile reads
  ``stale``);
* a store written by ``repro`` warm-starts the port: ``dataset``,
  ``scenes`` and ``indexes`` restored, the JAX kernel entries skipped and
  the cell buckets rebuilt, masks equal to JAX's;
* the kernel category's encoding tag, the adopted buckets and planes
  (nothing rebuilt), the metrics, ``/snapshot`` and the CLI.
"""

import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.planner.profiles as jprof
import repro_torch.planner.profiles as tprof
from repro.checkpoint.store import _flatten as j_flatten
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.persist import expected_fingerprints as j_expected_fingerprints
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_state,
)
from repro_torch.checkpoint.store import _flatten
from repro_torch.core.backends import GridPallasBackend, concrete_backends, get_backend
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.dynamic import DynamicEngine
from repro_torch.persist import SCHEMA, expected_fingerprints
from repro_torch.persist.store import KERNEL_ENCODING
from repro_torch.shard import ShardedEngine

from tests._torch_parity import CPU, edge_tie_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _instance(seed, M=40, N=250):
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.0, 100.0, (M, 2))
    U = rng.uniform(0.0, 100.0, (N, 2))
    return F, U, rng


def _same(a, b):
    return bool(np.array_equal(a.mask, b.mask) and np.array_equal(a.counts, b.counts))


def _statuses(eng):
    return {name: st["status"] for name, st in eng.persist_info["categories"].items()}


@pytest.fixture(autouse=True)
def _no_active_profile():
    """Both packages keep a process-wide planner profile: none while a
    test runs, the previous ones restored after it."""
    prev = tprof.get_active_profile(), jprof.get_active_profile()
    tprof.set_active_profile(None)
    jprof.set_active_profile(None)
    yield
    tprof.set_active_profile(prev[0])
    jprof.set_active_profile(prev[1])


# ------------------------------------------------------------ checkpoints
def test_crash_mid_write_recovery(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": np.arange(12.0).reshape(3, 4), "b": np.zeros(3)}
    save_checkpoint(d, 0, tree)
    tree2 = {"w": tree["w"] + 1, "b": tree["b"] + 1}
    save_checkpoint(d, 1, tree2)
    # a stranded .tmp dir from a save that died mid-write
    os.makedirs(os.path.join(d, "step_000000000002.tmp"))
    # step 3's manifest exists but a leaf was lost
    save_checkpoint(d, 3, tree2)
    victim = os.path.join(d, "step_000000000003")
    leaf = json.load(open(os.path.join(victim, "manifest.json")))["leaves"]["w"]["file"]
    os.remove(os.path.join(victim, leaf))

    assert latest_step(d) == 1
    restored, manifest = restore_checkpoint(d, tree)
    assert manifest["step"] == 1
    np.testing.assert_array_equal(restored["w"], tree2["w"])
    with pytest.raises(FileNotFoundError, match="incomplete"):
        restore_checkpoint(d, tree, step=3)
    # the state-store reader obeys the same completeness contract
    save_state(d, 5, {"c": {"fingerprint": "x", "meta": {}, "arrays": {"a": np.ones(4)}}},
               schema=SCHEMA)
    os.remove(os.path.join(d, "step_000000000005", "c__a.npy"))
    assert latest_step(d) == 1


TREES = {
    "flat": {"w": np.ones((2, 3)), "b": np.zeros(3)},
    "nested": {"layer": [{"w": np.ones(2), "b": np.zeros(1)}, (np.ones(3), None)],
               "a/b c": np.arange(4.0)},
    "sequence": [np.ones(1), [np.zeros(2), {"z": np.ones(2), "y": np.zeros(1)}]],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_checkpoint_leaf_paths_are_jax_tree_paths(name, tmp_path):
    tree = TREES[name]
    assert list(_flatten(tree)) == list(j_flatten(tree))
    save_checkpoint(str(tmp_path), 0, tree)
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert list(manifest["leaves"]) == list(j_flatten(tree))
    for (k, a), (_, b) in zip(_flatten(tree).items(), _flatten(restored).items()):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_restore_gives_each_leaf_as_the_template_has_it(tmp_path):
    tree = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": np.arange(3),
            "s": 2.5}
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": np.int64(3)})
    got, manifest = restore_checkpoint(str(tmp_path), tree)
    assert isinstance(got["t"], torch.Tensor) and got["t"].device == tree["t"].device
    assert torch.equal(got["t"], tree["t"])
    assert isinstance(got["n"], np.ndarray) and float(got["s"]) == 2.5
    assert manifest["extra"] == {"note": 3}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {**tree, "n": np.arange(4)})


def test_restore_into_writes_each_leaf_in_place(tmp_path):
    """``into=True`` copies each stored leaf into the template's own leaf (a
    tensor, an array, or a stacked view over per-layer tensors) and returns
    the template; the stacked view saves as the stack of its parts."""
    from repro_torch.models.convert import StackedLeaf

    parts = [torch.full((2, 3), float(r)) for r in range(3)]
    tree = {"t": torch.arange(4.0), "n": np.arange(3.0), "s": StackedLeaf(parts)}
    ck = AsyncCheckpointer(str(tmp_path))
    assert ck.save(5, tree) == 4 * 4 + 3 * 8 + 3 * 6 * 4  # the bytes copied to the host
    ck.wait()
    stored, _ = restore_checkpoint(str(tmp_path), {"t": np.zeros(4, np.float32),
                                                   "n": np.zeros(3), "s": np.zeros((3, 2, 3),
                                                                                   np.float32)})
    np.testing.assert_array_equal(stored["s"], np.stack([p.numpy() for p in parts]))
    ids = (tree["t"].data_ptr(), tree["n"].ctypes.data, [p.data_ptr() for p in parts])
    for leaf in (tree["t"], *parts):
        leaf.zero_()
    tree["n"][:] = 0
    got, manifest = restore_checkpoint(str(tmp_path), tree, into=True)
    assert got is tree and manifest["step"] == 5
    assert (tree["t"].data_ptr(), tree["n"].ctypes.data, [p.data_ptr() for p in parts]) == ids
    assert torch.equal(tree["t"], torch.arange(4.0))
    np.testing.assert_array_equal(tree["n"], np.arange(3.0))
    assert all(torch.equal(p, torch.full((2, 3), float(r))) for r, p in enumerate(parts))


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = torch.zeros(4)
    for step in range(3):
        t += 1
        ck.save(step, {"t": t})
        t += 100  # an in-place write after the save is not in the step
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_000000000001", "step_000000000002"]
    got, _ = restore_checkpoint(str(tmp_path), {"t": torch.zeros(4)})
    assert torch.equal(got["t"], torch.full((4,), 203.0))


# ------------------------------------------------------------ round trip
@pytest.mark.parametrize("backend", concrete_backends())
@pytest.mark.parametrize("n_shards", [1, 4])
def test_roundtrip_bit_identical(tmp_path, backend, n_shards):
    """save → warm start → query ≡ cold, per backend × shard count, and
    again after an update step on both engines."""
    F, U, rng = _instance(seed=7 + n_shards)
    queries, k = [0, 3, 11], 6
    cold = ShardedEngine(F, U, RkNNConfig(backend=backend, grid_g=16), shards=n_shards,
                         device=CPU)
    want = [cold.query(q, k) for q in queries]
    want_b = cold.query_batch(queries, k)
    d = str(tmp_path / "store")
    cold.save_state(d)

    warm = ShardedEngine(F, U, RkNNConfig(backend=backend, grid_g=16, warm_store=d),
                         shards=n_shards, device=CPU)
    cats = _statuses(warm)
    assert cats["dataset"] == cats["shards"] == "restored"
    if get_backend(backend).uses_scene:
        assert cats["scenes"] == cats["indexes"] == "restored"
    got = [warm.query(q, k) for q in queries]
    assert all(_same(c, w) for c, w in zip(want, got))
    got_b = warm.query_batch(queries, k)
    np.testing.assert_array_equal(got_b.counts, want_b.counts)
    np.testing.assert_array_equal(got_b.masks, want_b.masks)
    assert warm._snap.scene_cache.misses == 0  # the working set was adopted
    assert _same(cold.query_mono(queries[0], k), warm.query_mono(queries[0], k))

    ins = rng.uniform(0.0, 100.0, (3, 2))
    mv = rng.choice(len(U), 10, replace=False)
    pts = rng.uniform(0.0, 100.0, (10, 2))
    for eng in (cold, warm):
        eng.apply_updates(facility_insert=ins, user_move=(mv, pts))
    assert all(_same(c, w) for c, w in zip(
        [cold.query(q, k) for q in queries], [warm.query(q, k) for q in queries]))
    np.testing.assert_array_equal(warm.query_batch(queries, k).counts,
                                  cold.query_batch(queries, k).counts)


def test_cross_process_restore(tmp_path):
    """A fresh interpreter (a fresh hash salt) restores the store and
    serves identical masks with zero scene rebuilds: no salted in-memory
    fingerprint leaked into the manifest."""
    F, U, _ = _instance(seed=11)
    d = str(tmp_path / "store")
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16), device=CPU)
    want = eng.query_batch([0, 2, 5], 8)
    eng.save_state(d)
    np.save(tmp_path / "F.npy", F)
    np.save(tmp_path / "U.npy", U)
    prog = f"""
import numpy as np
from repro_torch.core.engine import RkNNConfig, RkNNEngine
F = np.load({str(tmp_path / 'F.npy')!r}); U = np.load({str(tmp_path / 'U.npy')!r})
eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16, warm_store={d!r}),
                 device="cpu")
cats = eng.persist_info["categories"]
assert all(cats[c]["status"] == "restored" for c in ("scenes", "indexes", "kernel")), cats
r = eng.query_batch([0, 2, 5], 8)
assert eng._snap.scene_cache.misses == 0, "restored working set was rebuilt"
np.save({str(tmp_path / 'warm.npy')!r}, r.counts)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("PYTHONHASHSEED", None)  # a fresh random salt is the point
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "warm.npy"), want.counts)


# ------------------------------------------------------- invalidation
def test_partial_invalidation_user_change(tmp_path):
    """A user-set change invalidates the data-keyed categories; the
    hardware-keyed planner profile is adopted, and an installed profile
    is never clobbered."""
    F, U, rng = _instance(seed=13)
    tprof.set_active_profile(tprof.PlannerProfile(
        hardware=tprof.hardware_fingerprint(), source="test", models={}))
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16), device=CPU)
    eng.query_batch([0, 1], 6)
    d = str(tmp_path / "store")
    eng.save_state(d)
    assert "planner" in eng.persist_info["categories"]

    tprof.set_active_profile(None)
    U2 = rng.uniform(0.0, 150.0, (len(U) + 40, 2))  # moves the hull rect too
    warm = RkNNEngine(F, U2, RkNNConfig(backend="grid", grid_g=16, warm_store=d), device=CPU)
    cats = _statuses(warm)
    assert cats["planner"] == "restored" and tprof.get_active_profile() is not None
    assert cats["dataset"] == cats["scenes"] == cats["indexes"] == "stale"
    assert len(warm._snap.scene_cache) == 0

    marker = tprof.PlannerProfile(hardware=tprof.hardware_fingerprint(), source="op", models={})
    tprof.set_active_profile(marker)
    warm2 = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16, warm_store=d), device=CPU)
    assert _statuses(warm2)["planner"] == "skipped"
    assert tprof.get_active_profile() is marker


def test_schema_mismatch_and_missing_store_leave_a_cold_engine(tmp_path):
    F, U, _ = _instance(seed=17)
    d = str(tmp_path / "store")
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16), device=CPU)
    want = eng.query(0, 6)
    eng.save_state(d)
    path = os.path.join(d, f"step_{0:012d}", "manifest.json")
    m = json.load(open(path))
    m["schema"] = "rknn-store/999"
    json.dump(m, open(path, "w"))
    for store in (d, str(tmp_path / "nowhere")):
        warm = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16, warm_store=store),
                          device=CPU)
        assert "error" in warm.persist_info and warm.persist_info["categories"] == {}
        assert len(warm._snap.scene_cache) == 0
        assert _same(warm.query(0, 6), want)


# ------------------------------------------------------- hot adopt
def test_hot_adopt_publishes_next_version_under_a_reader(tmp_path):
    F, U, rng = _instance(seed=23)
    d = str(tmp_path / "store")
    src = DynamicEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16), device=CPU)
    want_new = src.query_batch([0, 4], 6)
    src.save_state(d)

    F0, U0 = rng.uniform(0, 100, (20, 2)), rng.uniform(0, 100, (80, 2))
    live = DynamicEngine(F0, U0, RkNNConfig(backend="grid-pallas", grid_g=16), device=CPU)
    want_old = live.query_batch([0, 4], 6)
    v0 = live.version
    stop, seen, errors = threading.Event(), [], []

    def reader():
        try:
            while not stop.is_set():
                r = live.query_batch([0, 4], 6)
                ref = want_old if r.version == v0 else want_new
                seen.append((r.version, np.array_equal(r.counts, ref.counts)))
        except Exception as e:  # surfaced after the join
            errors.append(e)

    th = threading.Thread(target=reader)
    th.start()
    info = live.restore(d)
    stop.set()
    th.join()
    assert not errors and all(ok for _, ok in seen)
    assert {v for v, _ in seen} <= {v0, v0 + 1}
    assert info["mode"] == "hot-adopt" and info["version"] == v0 + 1
    assert live.version == v0 + 1  # published as MVCC N+1
    assert all(st["status"] in ("restored", "absent") for st in info["categories"].values())
    got = live.query_batch([0, 4], 6)
    np.testing.assert_array_equal(got.counts, want_new.counts)
    assert live._snap.scene_cache.misses == 0


# ------------------------------------------------- fingerprints vs JAX
@pytest.mark.parametrize("kind", ["RkNNEngine", "ShardedEngine"])
def test_expected_fingerprints_equal_jax_but_the_planner(kind):
    import repro.shard as js

    F, U, rng = _instance(seed=19)
    if kind == "RkNNEngine":
        ours = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16), device=CPU)
        theirs = JEngine(F, U, JConfig(backend="grid", grid_g=16))
    else:
        ours = ShardedEngine(F, U, RkNNConfig(backend="grid", grid_g=16), shards=4, device=CPU)
        theirs = js.ShardedEngine(F, U, JConfig(backend="grid", grid_g=16), shards=4)
    got = expected_fingerprints(ours, ours._snap)
    want = j_expected_fingerprints(theirs, theirs._snap)
    assert got.keys() == want.keys()
    assert {c: v for c, v in got.items() if c != "planner"} == {
        c: v for c, v in want.items() if c != "planner"}
    assert got["planner"] != want["planner"]
    if kind == "ShardedEngine":
        assert "shards" in got
    moved = RkNNEngine(F, rng.uniform(0, 100, U.shape), RkNNConfig(backend="grid", grid_g=16),
                       device=CPU)
    other = expected_fingerprints(moved, moved._snap)
    assert other["dataset"] != got["dataset"] and other["kernel"] != got["kernel"]
    assert other["planner"] == got["planner"]  # data-independent


def test_a_jax_planner_profile_reads_stale(tmp_path):
    F, U, _ = _instance(seed=41)
    jprof.set_active_profile(jprof.builtin_profile())
    jeng = JEngine(F, U, JConfig(backend="grid", grid_g=16))
    jeng.query(0, 6)
    d = str(tmp_path / "jax")
    jeng.save_state(d)
    assert "planner" in jeng.persist_info["categories"]
    warm = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16, warm_store=d), device=CPU)
    assert _statuses(warm)["planner"] == "stale"
    assert tprof.get_active_profile() is None  # never adopted

    tprof.set_active_profile(tprof.builtin_profile())
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16), device=CPU)
    d2 = str(tmp_path / "port")
    eng.save_state(d2)
    tprof.set_active_profile(None)
    warm = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16, warm_store=d2), device=CPU)
    assert _statuses(warm)["planner"] == "restored"
    assert tprof.get_active_profile().to_json() == tprof.builtin_profile().to_json()


#: the JAX backend whose store each port backend warm-starts from (the
#: ``-ref`` twins: the Pallas kernels would run in interpret mode)
JAX_OF = {"dense": "dense-ref", "grid": "grid", "grid-pallas": "grid-pallas-ref", "bvh": "bvh"}


@pytest.mark.parametrize("backend", sorted(JAX_OF))
def test_a_jax_store_warm_starts_the_port(tmp_path, backend, monkeypatch):
    F, U, _ = _instance(seed=43)
    qs, k = [0, 5, 9], 6
    jeng = JEngine(F, U, JConfig(backend=JAX_OF[backend], grid_g=16))
    want = jeng.query_batch(qs, k)
    d = str(tmp_path / "jax")
    jeng.save_state(d)

    bucketed = []
    real = GridPallasBackend._bucket
    monkeypatch.setattr(GridPallasBackend, "_bucket",
                        lambda self, *a: bucketed.append(1) or real(self, *a))
    warm = RkNNEngine(F, U, RkNNConfig(backend=backend, grid_g=16, warm_store=d), device=CPU)
    cats = warm.persist_info["categories"]
    assert {c: cats[c]["status"] for c in ("dataset", "scenes", "indexes")} == {
        c: "restored" for c in ("dataset", "scenes", "indexes")}
    if backend == "grid-pallas":
        assert cats["kernel"]["status"] == "restored" and cats["kernel"]["items"] == 0
    got = warm.query_batch(qs, k)
    assert warm._snap.scene_cache.misses == 0
    assert len(bucketed) == (1 if backend == "grid-pallas" else 0)  # rebuilt, never misread
    np.testing.assert_array_equal(got.masks, np.asarray(want.masks))
    for i, sc in enumerate(got.scenes):
        ties = edge_tie_mask(U[:, 0].astype(np.float32), U[:, 1].astype(np.float32),
                             sc.coeffs[: sc.n_tris])
        np.testing.assert_array_equal(got.counts[i][~ties], np.asarray(want.counts[i])[~ties])
    cold = RkNNEngine(F, U, RkNNConfig(backend=backend, grid_g=16), device=CPU)
    np.testing.assert_array_equal(got.counts, cold.query_batch(qs, k).counts)


# ------------------------------------------------- the kernel category
def test_kernel_entries_are_tagged_adopted_and_equal_a_cold_bucketing(tmp_path, monkeypatch):
    F, U, _ = _instance(seed=47, N=600)
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16), device=CPU)
    want = eng.query_batch([1, 2, 3], 6)
    d = str(tmp_path / "store")
    eng.save_state(d)
    manifest = json.load(open(os.path.join(d, f"step_{0:012d}", "manifest.json")))
    [entry] = manifest["categories"]["kernel"]["meta"]["entries"]
    assert entry["encoding"] == KERNEL_ENCODING
    assert {a.split("_", 1)[1] for a in manifest["categories"]["kernel"]["arrays"]} == {
        "xs_s", "ys_s", "ranks", "occ", "unsort", "boxes"}

    rebuilt = []
    monkeypatch.setattr(GridPallasBackend, "_bucket", lambda *a: rebuilt.append(1))
    import repro_torch.core.backends as tb

    monkeypatch.setattr(tb, "pack_cell_coeff_planes", lambda *a: rebuilt.append(2))
    warm = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16, warm_store=d),
                      device=CPU)
    got = warm.query_batch([1, 2, 3], 6)
    assert rebuilt == []  # the buckets and the planes were adopted
    np.testing.assert_array_equal(got.counts, want.counts)
    [cold_b] = [v[1] for key, v in eng._snap.kernel_memo.items() if key[0] == "gp-buckets"]
    [warm_b] = [v[1] for key, v in warm._snap.kernel_memo.items() if key[0] == "gp-buckets"]
    for name in ("xs_s", "ys_s", "ranks", "unsort", "boxes"):
        a, b = getattr(cold_b, name), getattr(warm_b, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    np.testing.assert_array_equal(cold_b.occ, warm_b.occ)
    assert cold_b.block == warm_b.block

    # an entry without the tag is another encoding: skipped, rebuilt cold
    del manifest["categories"]["kernel"]["meta"]["entries"][0]["encoding"]
    json.dump(manifest, open(os.path.join(d, f"step_{0:012d}", "manifest.json"), "w"))
    monkeypatch.undo()
    bucketed = []
    real = GridPallasBackend._bucket
    monkeypatch.setattr(GridPallasBackend, "_bucket",
                        lambda self, *a: bucketed.append(1) or real(self, *a))
    warm2 = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16, warm_store=d),
                       device=CPU)
    assert warm2.persist_info["categories"]["kernel"]["items"] == 0
    np.testing.assert_array_equal(warm2.query_batch([1, 2, 3], 6).counts, want.counts)
    assert bucketed == [1]


# ------------------------------------------------------- observability
def test_persist_metrics_and_snapshot_endpoint(tmp_path):
    F, U, _ = _instance(seed=29)
    d = str(tmp_path / "store")
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=16), device=CPU)
    eng.query_batch([0, 1], 6)
    eng.save_state(d)
    assert eng.metrics.find("persist.bytes")
    assert eng.persist_info["mode"] == "save" and eng.persist_info["step"] == 0

    warm = DynamicEngine(F, U, RkNNConfig(backend="grid", grid_g=16, warm_store=d), device=CPU)
    assert warm.metrics.find("persist.restore_s")
    with warm.serve_obs(port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/snapshot")
        payload = json.loads(conn.getresponse().read())
        conn.close()
    assert payload["persist"]["schema"] == SCHEMA
    assert payload["persist"]["store"] == os.path.abspath(d)
    assert payload["persist"]["categories"]["scenes"]["status"] == "restored"


# ------------------------------------------------------------------- CLI
def test_cli_inspect_and_verify_on_the_cpu(tmp_path, capsys):
    from repro_torch.persist.__main__ import main

    F, U, _ = _instance(seed=31)
    d = str(tmp_path / "store")
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", grid_g=16), device=CPU)
    for q in (0, 1, 2):
        eng.query(q, 6)
    eng.save_state(d)

    assert main(["--inspect", d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert SCHEMA in out and "scenes" in out and "fresh" in out and "STALE" not in out
    assert main(["--verify", d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bit-identical" in out and "first answer" in out
    assert main(["--inspect", d, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["schema"] == SCHEMA

    # a mutated store fails verification: every stored edge test inverted
    folder = os.path.join(d, f"step_{0:012d}")
    m = json.load(open(os.path.join(folder, "manifest.json")))
    victims = [m["categories"]["scenes"]["arrays"]["coeffs"]["file"]] + [
        v["file"] for key, v in m["categories"]["indexes"]["arrays"].items()
        if key.endswith(("coeffs", "planes"))
    ]
    for fn in victims:
        np.save(os.path.join(folder, fn), -np.load(os.path.join(folder, fn)))
    rc = main(["--verify", d, "--device", "cpu"])
    assert rc == 1 and "MISMATCH" in capsys.readouterr().out


def test_cli_verify_runs_on_the_card_by_default(tmp_path, monkeypatch):
    from repro_torch.persist.__main__ import main

    F, U, _ = _instance(seed=33)
    d = str(tmp_path / "store")
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    eng.query(0, 6)
    eng.save_state(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--verify", d])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        RkNNEngine(F, U, RkNNConfig(warm_store=d))
