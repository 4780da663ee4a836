"""Versioned persistent engine state: the ``rknn-store/1`` codec
(``repro.persist.store``, carried over to this package).

A process restart used to throw away exactly the amortized state the
serving layers spend their lifetime accumulating: built scenes (InfZone
pruning + occluder construction), grid/BVH indexes with their packed
per-cell coefficient planes, the grid-pallas user cell bucketing, the
shard partition, and the calibrated planner profile.  This module gives
all of it a canonical serializable form and persists it through the
atomic-rename manifest machinery in :mod:`repro_torch.checkpoint.store`.

Store layout (one ``step_<N>`` folder per save, newest complete wins)::

    <dir>/step_<N>/manifest.json        # schema, per-category fingerprints
    <dir>/step_<N>/<category>__<k>.npy  # array leaves

Categories and their **content fingerprints** (hashlib digests — the
in-process ``SceneCache.fingerprint`` uses salted ``hash()`` and is NOT
stable across processes, so it never appears in a manifest):

=========  ============================================================
dataset    facilities/users/rect.  fp(facilities, users, rect).
scenes     the SceneCache entries keyed under the snapshot's own
           fingerprint+rect, stored unpadded and re-padded/re-keyed on
           restore.  fp(facilities, rect, strategy, prune_grid).
indexes    per-scene backend index state via ``Backend.export_state``,
           deduplicated across registry entries that share one object
           (the grid family).  fp(scenes fp + grid_g).
kernel     the grid-pallas user cell bucketing, this package's
           :class:`~repro_torch.core.backends.CellBuckets` (Morton-ordered
           cell runs, block ranks, occupied cells, the unsort index and
           the block boxes), each entry tagged ``encoding =
           "repro_torch.cell-buckets/1"`` and uploaded to the snapshot's
           device on restore; an entry without that tag (the JAX
           package's bucketing) is skipped and rebuilt cold.
           fp(users, rect, grid_g).
shards     the spatial user partition (perm/pos/bounds); the per-shard
           device views are re-placed with ``.to(device)`` on restore.
           fp(users, rect, grid_g, n_shards).  ShardedEngine only.
planner    the active profile's versioned JSON (the existing
           ``planner/profiles.py`` schema — not a second format) plus
           its epoch.  fp("repro_torch", runner_class, PROFILE_VERSION):
           salted with the package name, so a JAX package's profile (the
           same runner class and version on a CPU host, priced for
           interpret-mode kernels) reads stale here.
=========  ============================================================

For the same data every fingerprint but ``planner`` equals the JAX
package's, so a store the JAX package wrote warm-starts this one (its
dataset, scenes and indexes; its kernel entries are skipped).

A mismatch invalidates only the stale category: a user-set change moves
the hull rect and so invalidates scenes/indexes/kernel/shards, while the
planner profile (hardware-keyed, data-independent) survives; a
hardware-class change invalidates only the planner.

Single-writer contract: concurrent :func:`save_engine_state` calls into
one directory are last-writer-wins per step number (each save is atomic
via rename); readers always see a complete step.  Restoring publishes a
new MVCC snapshot version through the engine's existing atomic swap, so
a *live* engine can hot-adopt a store without blocking readers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

import torch

from repro_torch.checkpoint.store import (
    latest_step,
    load_arrays,
    load_state,
    save_state,
)
from repro_torch.core.geometry import Rect
from repro_torch.core.pruning import PruneStats
from repro_torch.core.scene import Scene, pad_scene_arrays

__all__ = [
    "SCHEMA",
    "content_digest",
    "expected_fingerprints",
    "export_categories",
    "save_engine_state",
    "warm_start",
    "restore_engine",
    "adopt_categories",
]

SCHEMA = "rknn-store/1"
#: Tag of this package's kernel-category entries (its ``CellBuckets``);
#: entries without it are another encoding and are never adopted.
KERNEL_ENCODING = "repro_torch.cell-buckets/1"
#: Salt of the planner category's fingerprint: a profile is priced for one
#: package's kernels, so the JAX package's never reads fresh here.
PLANNER_SALT = "repro_torch"


# --------------------------------------------------------------------------
# content fingerprints (cross-process stable, unlike salted hash())
# --------------------------------------------------------------------------


def content_digest(*parts) -> str:
    """Stable short digest over arrays and JSON-able scalars."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()[:16]


def _rect_parts(rect: Rect | None):
    if rect is None:
        return None
    return (float(rect.xmin), float(rect.ymin), float(rect.xmax), float(rect.ymax))


def expected_fingerprints(engine, snap) -> dict[str, str]:
    """What each category's fingerprint *should* be for this live engine
    — the restore path adopts a stored category only on an exact match,
    so a data/hardware/code change invalidates per category."""
    from repro_torch.planner.profiles import PROFILE_VERSION, runner_class

    cfg = engine.config
    rect = _rect_parts(snap.rect)
    out = {
        "dataset": content_digest(
            "dataset", snap.facilities, snap.users, rect, snap.explicit_rect
        ),
        "scenes": content_digest(
            "scenes", snap.facilities, rect, cfg.strategy, cfg.prune_grid
        ),
        "indexes": content_digest(
            "indexes", snap.facilities, rect, cfg.strategy, cfg.prune_grid,
            int(cfg.grid_g),
        ),
        "kernel": content_digest("kernel", snap.users, rect, int(cfg.grid_g)),
        "planner": content_digest(
            "planner", PLANNER_SALT, runner_class(), PROFILE_VERSION
        ),
    }
    out.update(engine._persist_extra_fingerprints(snap))
    return out


# --------------------------------------------------------------------------
# export: engine snapshot -> named categories
# --------------------------------------------------------------------------


def _q_key_json(qk):
    return int(qk) if isinstance(qk, (int, np.integer)) else list(qk)


def _q_key_load(qk):
    if isinstance(qk, (int, np.integer)):
        return int(qk)
    return tuple(float(v) for v in qk)


def _export_dataset(engine, snap) -> tuple[dict, dict]:
    arrays = {"facilities": snap.facilities, "users": snap.users}
    meta = {
        "explicit_rect": bool(snap.explicit_rect),
        "rect": list(_rect_parts(snap.rect)),
        "n_facilities": int(len(snap.facilities)),
        "n_users": int(len(snap.users)),
    }
    return arrays, meta


def _persistable_scenes(snap) -> list[tuple[tuple, Scene]]:
    """The cache entries that belong to this snapshot: keyed under its
    own facility fingerprint and its shared rect (transient out-of-hull
    rects are per-call state, not engine state)."""
    sc = snap.scene_cache
    if sc is None:
        return []
    fp = snap.fingerprint()
    rect = snap.rect
    return [
        (key, scene)
        for key, scene in sc.items()
        if key[0] == fp and key[3] == rect
    ]


def _export_scenes(entries: list[tuple[tuple, Scene]]) -> tuple[dict, dict]:
    scenes = [scene for _key, scene in entries]
    offsets = np.zeros(len(scenes) + 1, np.int64)
    for i, s in enumerate(scenes):
        offsets[i + 1] = offsets[i] + s.n_tris
    t = int(offsets[-1])
    tris = np.zeros((t, 3, 2), np.float32)
    coeffs = np.zeros((t, 3, 3), np.float32)
    owner = np.zeros((t,), np.int32)
    for i, s in enumerate(scenes):
        sl = slice(int(offsets[i]), int(offsets[i + 1]))
        tris[sl] = s.tris[: s.n_tris]
        coeffs[sl] = s.coeffs[: s.n_tris]
        owner[sl] = s.owner[: s.n_tris]
    arrays = {
        "offsets": offsets,
        "tris": tris,
        "coeffs": coeffs,
        "owner": owner,
        "keep": np.stack([s.keep for s in scenes]) if scenes else np.zeros((0, 0), bool),
        "q": np.stack([np.asarray(s.q, np.float64) for s in scenes])
        if scenes
        else np.zeros((0, 2), np.float64),
    }
    meta = {
        "entries": [
            {
                "q_key": _q_key_json(key[1]),
                "k": int(key[2]),
                "n_occluders": int(scene.n_occluders),
                "stats": dataclasses.asdict(scene.stats),
            }
            for key, scene in entries
        ]
    }
    return arrays, meta


def _export_indexes(engine, snap, entries) -> tuple[dict, dict]:
    """Per-scene index stores, deduplicated: registry entries that share
    one built object (grid / grid-pallas / grid-pallas-ref share their
    ``OccluderGrid``) reference one serialized object."""
    from repro_torch.core.backends import available_backends, get_backend

    arrays: dict = {}
    objects: list[dict] = []
    obj_of: dict[int, int] = {}  # id(index) -> object slot (-2 = unserializable)
    scene_keys: list[list] = []
    names = set(available_backends())
    for _key, scene in entries:
        store = snap.index_memo.peek(scene)
        keys = []
        for skey, index in (store or {}).items():
            if not (isinstance(skey, tuple) and len(skey) == 2 and skey[0] in names):
                continue
            bname, g = skey
            if index is None:
                keys.append([bname, int(g), -1])
                continue
            slot = obj_of.get(id(index))
            if slot is None:
                exported = get_backend(bname).export_state(index)
                if exported is None:
                    slot = -2
                else:
                    kind, obj_arrays, obj_meta = exported
                    slot = len(objects)
                    prefix = f"obj{slot}_"
                    objects.append(
                        {
                            "kind": kind,
                            "backend": bname,
                            "meta": obj_meta,
                            "array_keys": [prefix + a for a in obj_arrays],
                        }
                    )
                    for aname, arr in obj_arrays.items():
                        arrays[prefix + aname] = arr
                obj_of[id(index)] = slot
            if slot >= 0:
                keys.append([bname, int(g), slot])
            elif slot == -1:
                keys.append([bname, int(g), -1])
        scene_keys.append(keys)
    return arrays, {"objects": objects, "scene_keys": scene_keys}


def _export_kernel(snap) -> tuple[dict, dict]:
    """The grid-pallas cell bucketing memo entries pinned to this
    snapshot's own user tensor (identity-keyed; re-keyed on restore under
    the new process's tensor identity).  All seven ``CellBuckets``
    fields are stored, the device ones copied to the host."""
    arrays: dict = {}
    metas = []
    xs_live = snap._xs
    if xs_live is not None:
        for key, value in snap.kernel_memo.items():
            if not (isinstance(key, tuple) and key and key[0] == "gp-buckets"):
                continue
            if value[0] is not xs_live or key[3] != snap.rect:
                continue
            b = value[1]
            i = len(metas)
            arrays[f"b{i}_xs_s"] = b.xs_s.cpu().numpy()
            arrays[f"b{i}_ys_s"] = b.ys_s.cpu().numpy()
            arrays[f"b{i}_ranks"] = b.ranks.cpu().numpy()
            arrays[f"b{i}_occ"] = np.asarray(b.occ)
            arrays[f"b{i}_unsort"] = b.unsort.cpu().numpy()
            arrays[f"b{i}_boxes"] = b.boxes.cpu().numpy()
            metas.append({"n": int(key[2]), "G": int(key[4]), "block": int(b.block),
                          "encoding": KERNEL_ENCODING})
    return arrays, {"entries": metas}


def _export_planner() -> tuple[dict, dict] | None:
    from repro_torch.planner.profiles import get_active_profile, profile_epoch

    prof = get_active_profile()
    if prof is None:
        return None
    return {}, {"profile": prof.to_json(), "epoch": int(profile_epoch())}


def export_categories(engine, snap) -> dict:
    """``{name: {"fingerprint", "meta", "arrays"}}`` for everything this
    engine can persist (empty/disabled layers are simply omitted)."""
    from repro_torch.obs import span

    fps = expected_fingerprints(engine, snap)
    out: dict = {}

    with span("save", category="dataset"):
        arrays, meta = _export_dataset(engine, snap)
        out["dataset"] = {
            "fingerprint": fps["dataset"], "meta": meta, "arrays": arrays
        }

    entries = _persistable_scenes(snap)
    if entries:
        with span("save", category="scenes"):
            arrays, meta = _export_scenes(entries)
            out["scenes"] = {
                "fingerprint": fps["scenes"], "meta": meta, "arrays": arrays
            }
        with span("save", category="indexes"):
            arrays, meta = _export_indexes(engine, snap, entries)
        if meta["objects"] or any(meta["scene_keys"]):
            out["indexes"] = {
                "fingerprint": fps["indexes"], "meta": meta, "arrays": arrays
            }

    with span("save", category="kernel"):
        arrays, meta = _export_kernel(snap)
    if meta["entries"]:
        out["kernel"] = {"fingerprint": fps["kernel"], "meta": meta, "arrays": arrays}

    planner = _export_planner()
    if planner is not None:
        arrays, meta = planner
        out["planner"] = {
            "fingerprint": fps["planner"], "meta": meta, "arrays": arrays
        }

    for name, cat in engine._persist_extra_categories(snap).items():
        cat.setdefault("fingerprint", fps.get(name, ""))
        out[name] = cat
    return out


# --------------------------------------------------------------------------
# adopt: stored categories -> a live snapshot
# --------------------------------------------------------------------------


def _adopt_scenes(engine, snap, meta, arrays) -> list[Scene]:
    """Re-pad and re-key stored scenes into the snapshot's cache.  The
    restored arrays are the exact float32 arrays a cold build produces
    (stored post-cast, unpadded; the pad rule and heights are recomputed
    the same way ``build_scene`` does), so restored queries are
    bit-identical to cold ones."""
    sc = snap.scene_cache
    if sc is None:
        return []
    fp = snap.fingerprint()
    rect = snap.rect
    offsets = arrays["offsets"]
    restored = []
    for i, ent in enumerate(meta["entries"]):
        sl = slice(int(offsets[i]), int(offsets[i + 1]))
        tris_p, coeffs_p, owner_p, n = pad_scene_arrays(
            arrays["tris"][sl], arrays["coeffs"][sl], arrays["owner"][sl], None
        )
        heights = np.zeros((len(tris_p),), np.float32)
        heights[:n] = np.arange(1, n + 1, dtype=np.float32)
        scene = Scene(
            tris=tris_p,
            coeffs=coeffs_p,
            owner=owner_p,
            n_tris=n,
            n_occluders=int(ent["n_occluders"]),
            keep=np.ascontiguousarray(arrays["keep"][i], bool),
            q=np.ascontiguousarray(arrays["q"][i], np.float64),
            rect=rect,
            heights=heights,
            stats=PruneStats(**ent["stats"]),
        )
        sc.seed((fp, _q_key_load(ent["q_key"]), int(ent["k"]), rect), scene)
        restored.append(scene)
    return restored


def _adopt_indexes(engine, snap, meta, arrays, scenes: list[Scene]) -> int:
    from repro_torch.core.backends import available_backends, get_backend

    names = set(available_backends())
    objects: list = []
    for slot, obj in enumerate(meta["objects"]):
        if obj["backend"] not in names:
            objects.append(None)
            continue
        prefix = f"obj{slot}_"
        try:
            objects.append(
                get_backend(obj["backend"]).import_state(
                    obj["kind"],
                    {k[len(prefix):]: arrays[k] for k in obj["array_keys"]},
                    obj["meta"],
                )
            )
        except (ValueError, KeyError):
            objects.append(None)
    adopted = 0
    for scene, keys in zip(scenes, meta["scene_keys"]):
        store: dict = {}
        for bname, g, slot in keys:
            if slot == -1:
                store[(bname, int(g))] = None
            elif 0 <= slot < len(objects) and objects[slot] is not None:
                store[(bname, int(g))] = objects[slot]
        if store:
            # the grid family's build memo key rides along so a restored
            # grid is shared exactly like a cold-built one
            for key in list(store):
                if store[key] is not None and key[0] in (
                    "grid", "grid-pallas", "grid-pallas-ref"
                ):
                    store.setdefault(("grid", int(key[1])), store[key])
            snap.index_memo.adopt(scene, store)
            adopted += 1
    return adopted


def _adopt_kernel(engine, snap, meta, arrays) -> int:
    """Upload each stored ``CellBuckets`` to the snapshot's device and key
    it as the grid-pallas backends look it up (``("gp-buckets", id(xs),
    n, rect, G)`` → ``(xs, buckets)``).  Entries of another encoding (the
    JAX package's bucketing) or another user count are skipped: the
    backend buckets those users cold at first use."""
    from repro_torch.core.backends import CellBuckets

    xs = snap.xs  # materializes the live device tensors the key pins
    dev = xs.device
    n_adopted = 0
    for i, ent in enumerate(meta["entries"]):
        if ent.get("encoding") != KERNEL_ENCODING or int(ent["n"]) != int(xs.shape[0]):
            continue

        def up(name, dtype):
            return torch.from_numpy(np.ascontiguousarray(arrays[f"b{i}_{name}"], dtype)).to(dev)

        buckets = CellBuckets(
            xs_s=up("xs_s", np.float32),
            ys_s=up("ys_s", np.float32),
            ranks=up("ranks", np.int32),
            occ=np.ascontiguousarray(arrays[f"b{i}_occ"]),
            block=int(ent["block"]),
            unsort=up("unsort", np.int64),
            boxes=up("boxes", np.float32),
        )
        key = ("gp-buckets", id(xs), int(ent["n"]), snap.rect, int(ent["G"]))
        snap.kernel_memo.put(key, (xs, buckets))
        n_adopted += 1
    return n_adopted


def _adopt_planner(meta) -> str:
    from repro_torch.planner.profiles import (
        PlannerProfile,
        get_active_profile,
        set_active_profile,
    )

    if get_active_profile() is not None:
        return "skipped"  # never clobber an operator-installed profile
    set_active_profile(PlannerProfile.from_json(meta["profile"]))
    return "restored"


def adopt_categories(engine, snap, manifest: dict, folder: str) -> dict:
    """Adopt every fingerprint-matching category from a loaded store into
    ``snap`` (which must not be published to readers yet, or be freshly
    constructed — adoption appends to the snapshot's caches in the same
    way a cold query would).  Returns per-category status records."""
    import time as _time

    from repro_torch.obs import span

    fps = expected_fingerprints(engine, snap)
    cats = manifest.get("categories", {})
    status: dict = {}
    restored_scenes: list[Scene] = []
    order = ["dataset", "scenes", "indexes", "kernel", "planner"]
    order += [n for n in cats if n not in order]
    for name in order:
        entry = cats.get(name)
        if entry is None:
            status[name] = {"status": "absent"}
            continue
        nbytes = sum(
            int(np.prod(a["shape"])) * np.dtype(a["dtype"]).itemsize
            for a in entry.get("arrays", {}).values()
        )
        if fps.get(name) != entry.get("fingerprint"):
            status[name] = {"status": "stale", "bytes": nbytes}
            continue
        t0 = _time.perf_counter()
        try:
            with span("restore", category=name):
                arrays = load_arrays(folder, entry)
                if name == "dataset":
                    items = 2  # the arrays themselves; validated by fingerprint
                elif name == "scenes":
                    restored_scenes = _adopt_scenes(
                        engine, snap, entry["meta"], arrays
                    )
                    items = len(restored_scenes)
                elif name == "indexes":
                    items = _adopt_indexes(
                        engine, snap, entry["meta"], arrays, restored_scenes
                    )
                elif name == "kernel":
                    items = _adopt_kernel(engine, snap, entry["meta"], arrays)
                elif name == "planner":
                    state = _adopt_planner(entry["meta"])
                    status[name] = {
                        "status": state,
                        "bytes": nbytes,
                        "seconds": _time.perf_counter() - t0,
                    }
                    continue
                else:
                    state = engine._persist_adopt_extra(snap, name, entry, arrays)
                    if state is None:
                        status[name] = {"status": "ignored", "bytes": nbytes}
                        continue
                    items = int(state)
        except Exception as e:  # one broken category must not sink the rest
            status[name] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            continue
        dt = _time.perf_counter() - t0
        status[name] = {
            "status": "restored", "bytes": nbytes, "seconds": dt, "items": items
        }
        engine._persist_note("restore", name, nbytes, dt)
    return status


# --------------------------------------------------------------------------
# engine-level orchestration
# --------------------------------------------------------------------------


def _engine_extra(engine) -> dict:
    cfg = dataclasses.asdict(engine.config)
    cfg.pop("warm_store", None)  # a store never points at itself
    return {
        "engine": {
            "class": type(engine).__name__,
            "config": cfg,
            "n_shards": int(getattr(engine, "n_shards", 1)),
        }
    }


def save_engine_state(engine, directory: str, *, keep: int = 3) -> str:
    """Export the engine's served snapshot as the next store step.
    Returns the published step folder path."""
    import time as _time

    from repro_torch.obs import span

    snap = engine._snap  # resolved once, like a reader
    t0 = _time.perf_counter()
    with span("save", category="all"):
        categories = export_categories(engine, snap)
        last = latest_step(directory)
        step = 0 if last is None else last + 1
        path = save_state(
            directory,
            step,
            categories,
            schema=SCHEMA,
            keep=keep,
            extra=_engine_extra(engine),
        )
    dt = _time.perf_counter() - t0
    cat_status = {}
    for name, cat in categories.items():
        nbytes = sum(np.asarray(a).nbytes for a in cat["arrays"].values())
        engine._persist_note("save", name, nbytes, None)
        cat_status[name] = {"status": "saved", "bytes": nbytes}
    engine.persist_info = {
        "store": os.path.abspath(directory),
        "schema": SCHEMA,
        "step": step,
        "mode": "save",
        "seconds": dt,
        "categories": cat_status,
    }
    return path


def warm_start(engine, directory: str) -> dict:
    """Construction-time warm restore (``RkNNConfig(warm_store=...)``):
    adopt every fingerprint-matching category into the freshly built
    version-0 snapshot in place.  Best-effort — a missing, foreign, or
    stale store leaves a fully functional cold engine."""
    try:
        manifest, folder = load_state(directory, schema=SCHEMA)
    except (FileNotFoundError, ValueError, OSError) as e:
        engine.persist_info = {
            "store": os.path.abspath(directory),
            "schema": None,
            "mode": "warm-construct",
            "error": f"{type(e).__name__}: {e}",
            "categories": {},
        }
        return engine.persist_info
    status = adopt_categories(engine, engine._snap, manifest, folder)
    engine.persist_info = {
        "store": os.path.abspath(directory),
        "schema": manifest.get("schema"),
        "step": manifest.get("step"),
        "mode": "warm-construct",
        "categories": status,
    }
    return engine.persist_info


def restore_engine(engine, directory: str) -> dict:
    """Hot-adopt a store into a LIVE engine: build snapshot N+1 around
    the store's dataset, adopt every matching category, publish via the
    engine's atomic swap (under the writer lock where one exists).
    In-flight readers keep serving version N throughout."""
    import contextlib

    manifest, folder = load_state(directory, schema=SCHEMA)
    cats = manifest.get("categories", {})
    if "dataset" not in cats:
        raise ValueError(f"store under {directory} has no dataset category")
    lock = getattr(engine, "_writer_lock", None)
    with (lock if lock is not None else contextlib.nullcontext()):
        old = engine._snap
        data = load_arrays(folder, cats["dataset"])
        dmeta = cats["dataset"].get("meta", {})
        explicit = bool(dmeta.get("explicit_rect"))
        rect = Rect(*(float(v) for v in dmeta["rect"])) if explicit else None
        snap = engine._make_snapshot(
            old.version + 1,
            np.ascontiguousarray(data["facilities"], np.float64),
            np.ascontiguousarray(data["users"], np.float64),
            rect=rect,
            explicit_rect=explicit,
        )
        status = adopt_categories(engine, snap, manifest, folder)
        if engine.mesh is not None:
            engine._init_mesh(snap, engine.mesh)
        engine._snap = snap  # the MVCC publish — readers flip atomically
    engine.persist_info = {
        "store": os.path.abspath(directory),
        "schema": manifest.get("schema"),
        "step": manifest.get("step"),
        "mode": "hot-adopt",
        "version": snap.version,
        "categories": status,
    }
    return engine.persist_info
