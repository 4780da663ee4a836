"""Paper future-work items (Conclusions §5, directions 2–3), from
``repro.core.hybrid``.

* **Scene cache** (direction 2): per-(facility-set, q, k, rect) LRU of
  built scenes: a repeated query skips InfZone pruning and occluder
  construction entirely.  The long-lived owner of a cache is
  :class:`repro_torch.core.engine.RkNNEngine`, which wires it into the
  single, batched and streaming paths.

* **Hybrid dispatcher** (direction 3): :func:`choose_engine` prices the
  RT-vs-SLICE frontier from the active planner profile
  (:mod:`repro_torch.planner`); with none installed it falls back, warning
  once, to the JAX package's constants, which were fitted on a CPU.
  :func:`hybrid_rknn_query` runs the choice.  The RT side is ``dense``,
  the CUDA kernel, where the JAX module runs ``dense-ref`` (there the
  Pallas ``dense`` is interpret mode off a TPU).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from repro_torch.core.results import RkNNResult
from repro_torch.core.scene import Scene, build_scene

__all__ = ["SceneCache", "choose_engine", "hybrid_rknn_query"]


def _q_key(q):
    """Hashable cache key component for a query (index or [2] point)."""
    if np.isscalar(q) or isinstance(q, (int, np.integer)):
        return int(q)
    return tuple(np.asarray(q, np.float64).reshape(-1).tolist())


class SceneCache:
    """LRU of built scenes keyed by (facility-set fingerprint, q, k, rect).

    ``rect`` participates in the key because occluder triangles are clipped
    against the domain rectangle — the same query under a different rect is
    a different scene (the batched grid path additionally requires every
    stacked scene to share one rect).  Long-lived callers (the engine) pass
    a precomputed ``fp`` so the facility array is fingerprinted once, not
    per query.

    The *read* path (``contains`` / a ``get_or_build`` hit) is lock-free:
    a plain GIL-atomic dict read, no recency update — so concurrent
    readers of one engine snapshot never block each other.  Insertions
    take the internal lock for eviction safety, which makes eviction
    insertion-ordered (FIFO) rather than strict LRU.  The hit/miss
    counters are racy-increment statistics by design.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._store: "collections.OrderedDict[tuple, Scene]" = collections.OrderedDict()
        self._lock = threading.Lock()  # engine may build scenes from a pool
        self.hits = 0
        self.misses = 0
        self.delta_kept = 0
        self.delta_dropped = 0

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def fingerprint(facilities: np.ndarray) -> int:
        f = np.ascontiguousarray(facilities, dtype=np.float64)
        return hash((f.shape, f.tobytes()[:4096], float(f.sum())))

    def contains(self, facilities, q, k, rect=None, *, fp: int | None = None) -> bool:
        """Peek (no stats) — the planner prices a cache hit as "filter
        phase free" before deciding where to dispatch.  Lock-free."""
        if fp is None:
            fp = self.fingerprint(facilities)
        return (fp, _q_key(q), k, rect) in self._store

    def get_or_build(
        self, facilities, q, k, rect=None, *, fp: int | None = None, **kw
    ) -> tuple[Scene, bool]:
        if fp is None:
            fp = self.fingerprint(facilities)
        key = (fp, _q_key(q), k, rect)
        scene = self._store.get(key)  # lock-free hit path
        if scene is not None:
            self.hits += 1
            return scene, True
        scene = build_scene(facilities, q, k, rect, **kw)
        with self._lock:
            self._store[key] = scene
            if len(self._store) > self.capacity:
                self._store.popitem(last=False)
            self.misses += 1
        return scene, False

    def cow_migrate(self, select, migrate) -> tuple["SceneCache", int, int]:
        """Copy-on-write delta migration: build the **next version's**
        cache without touching this one (readers of the current engine
        snapshot keep serving it unchanged).

        For every entry whose key satisfies ``select(key)``, ``migrate(key,
        scene)`` is called; a ``(new_key, new_scene)`` return carries the
        entry into the new cache under its post-update key, ``None`` drops
        it; non-selected entries are carried as-is.  This is how the
        dynamic subsystem keeps scenes that provably survive an update
        across the facility-fingerprint change that would otherwise strand
        them.  The cumulative hit/miss/delta counters carry into the new
        cache (they are engine-lifetime statistics, not per-version).
        Returns ``(new_cache, n_migrated, n_dropped)``.
        """
        kept = dropped = 0
        with self._lock:
            items = list(self._store.items())
        new = SceneCache(capacity=self.capacity)
        for key, scene in items:
            if not select(key):
                new._store[key] = scene
                continue
            res = migrate(key, scene)
            if res is None:
                dropped += 1
                continue
            new_key, new_scene = res
            new._store[new_key] = new_scene
            kept += 1
        new.hits, new.misses = self.hits, self.misses
        new.delta_kept = self.delta_kept + kept
        new.delta_dropped = self.delta_dropped + dropped
        return new, kept, dropped


_warned_no_profile = False


def choose_engine(n_facilities: int, n_users: int, k: int) -> str:
    """'rt' or 'slice' from the RT-vs-filter–refine cost frontier.

    With an *active* planner profile (:func:`repro_torch.planner.profiles.
    set_active_profile`, typically installed after running
    :mod:`repro_torch.planner.calibrate` on the card), the frontier is a
    live lookup: the RT path's backend vs. the profile's ``"slice"``
    pseudo-backend model.  The RT path is what :func:`hybrid_rknn_query`
    runs, ``dense``; a profile calibrated on the CPU times ``dense-ref``
    in its place (the CPU path of ``dense`` is that plain twin), so it
    stands in for ``dense`` there; else the cheapest scene-using backend
    that is no plain twin.

    With no profile, falls back — warning once — to the JAX package's
    constants, fitted offline to a CPU benchmark (CPU crossovers, neither
    the paper's GPU ones nor this card's):

        rt_ms    ≈ 30 + 1.5·k + 0.35·|U|/1e3            (scene + cast)
        slice_ms ≈ 0.002·|F| + 0.4·k^1.5·(|U|/|F|)/1e3  (filter + verify)
    """
    if n_facilities <= 0:
        return "rt"

    from repro_torch.planner.profiles import get_active_profile

    prof = get_active_profile()
    reason = None
    if prof is None:
        reason = "no active planner profile"
    elif "slice" not in prof.models:
        reason = (
            "the active profile has no 'slice' model (calibrated with "
            "--no-slice?)"
        )
    else:
        from repro_torch.planner.models import WorkloadShape

        shape = WorkloadShape(n_facilities, n_users, k, 1)
        # price the 'rt' side with what the rt branch actually executes:
        # dense (or, in a CPU-calibrated profile, its plain twin); brute
        # (no ray casting) is not the rt path and must not stand in
        if "dense" in prof.models:
            rt_candidates: tuple[str, ...] = ("dense",)
        elif "dense-ref" in prof.models:
            rt_candidates = ("dense-ref",)
        else:
            from repro_torch.core.backends import concrete_backends, get_backend

            rt_candidates = tuple(
                n
                for n in prof.models
                if n in concrete_backends()
                and get_backend(n).uses_scene
                and get_backend(n).plain_twin_of is None
            )
        if rt_candidates:
            _, rt_s = prof.best_backend(shape, rt_candidates)
            slice_s = prof.predict_s("slice", shape)
            return "rt" if rt_s < slice_s else "slice"
        reason = "the active profile has no usable RT-path backend model"

    global _warned_no_profile
    if not _warned_no_profile:
        _warned_no_profile = True
        import warnings

        warnings.warn(
            f"choose_engine: {reason} — falling back to hard-coded cost "
            "constants fitted offline (likely stale for this hardware). "
            "Run repro_torch.planner.calibrate and set_active_profile() to use "
            "measured costs.",
            RuntimeWarning,
            stacklevel=2,
        )
    rt_ms = 30.0 + 1.5 * k + 0.35 * n_users / 1e3
    slice_ms = 0.002 * n_facilities + 0.4 * (k**1.5) * (n_users / max(n_facilities, 1)) / 1e3
    return "rt" if rt_ms < slice_ms else "slice"


def hybrid_rknn_query(
    facilities: np.ndarray,
    users: np.ndarray,
    q: int,
    k: int,
    *,
    cache: SceneCache | None = None,
    force: str | None = None,
    device=None,
) -> RkNNResult:
    """Dispatch to the predicted-faster engine (paper future-work 3),
    optionally amortizing scene construction through ``cache`` (future-
    work 2).  Returns an :class:`RkNNResult` either way.  The RT side runs
    the ``dense`` backend on ``device`` (``None``: CUDA)."""
    engine = force or choose_engine(len(facilities), len(users), k)
    if engine == "slice":
        from repro_torch.core.baselines.slice import slice_rknn

        mask, info = slice_rknn(facilities, users, q, k)
        return RkNNResult(
            mask=mask,
            counts=np.where(mask, 0, k).astype(np.int32),  # verdicts only
            scene=None,
            t_filter_s=info["t_filter_s"],
            t_verify_s=info["t_verify_s"],
            backend="slice",
        )
    if cache is not None:
        import torch

        from repro_torch.core.backends import QueryRequest, get_backend
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        t0 = time.perf_counter()
        scene, hit = cache.get_or_build(facilities, q, k, users_hint=users)
        t1 = time.perf_counter()
        users = np.asarray(users, np.float64)
        counts = get_backend("dense").count(
            QueryRequest(
                xs=torch.from_numpy(np.ascontiguousarray(users[:, 0], np.float32)).to(dev),
                ys=torch.from_numpy(np.ascontiguousarray(users[:, 1], np.float32)).to(dev),
                k=k,
                device=dev,
                scene=scene,
            )
        )
        t2 = time.perf_counter()
        return RkNNResult(counts < k, counts, scene, t1 - t0, t2 - t1, "dense")
    from repro_torch.core.rknn import rt_rknn_query

    return rt_rknn_query(facilities, users, q, k, backend="dense", device=device)
