"""Stateful RkNN query engine: build once, serve many query waves.

The port of ``repro.core.engine``.  :class:`RkNNEngine` is the long-lived
object state hangs off:

* the shared domain :class:`~repro_torch.core.geometry.Rect` and the user
  coordinates as float32 tensors on the engine's device (uploaded once,
  like the paper's "plain GPU transfer" of Table 2);
* a :class:`~repro_torch.core.hybrid.SceneCache` so hot queries skip
  InfZone pruning + occluder construction entirely (cache hits show up
  directly as a collapsed ``t_filter_s``);
* a batch-level LRU of prepared backend state (the stacked coefficients,
  already on the device), so a repeated query workload skips the whole
  host filter phase;
* sticky power-of-two scene pads, so repeat workloads stack to one shape.

Verification backends are pluggable via :mod:`repro_torch.core.backends`
(every backend, the ``bvh`` one included, goes through the same generic
paths);
the free functions (``rt_rknn_query`` etc.) are one-shot shims over a
throwaway engine.  The JAX engine's device mesh, query planner,
persistence, flight recorder and health endpoints are not part of this
package yet.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.backends import Backend, BatchRequest, QueryRequest, get_backend
from repro_torch.core.geometry import Rect
from repro_torch.core.hybrid import SceneCache, _q_key
from repro_torch.core.results import RkNNBatchResult, RkNNResult
from repro_torch.core.scene import Scene, build_scene
from repro_torch.core.snapshot import EngineSnapshot
from repro_torch.device import resolve_device
from repro_torch.obs import Histogram, MetricsRegistry, span

__all__ = ["RkNNConfig", "EngineStats", "RkNNEngine"]

#: Config fields of the JAX engine whose subsystems this package does not
#: have yet; setting one raises instead of being ignored.
_NOT_IMPLEMENTED = ("online_recalibration", "flight_recorder", "warm_store")


@dataclasses.dataclass(frozen=True)
class RkNNConfig:
    """Construction-time knobs of :class:`RkNNEngine`.

    ``scene_cache`` / ``batch_cache`` are LRU capacities (0 disables).
    ``grid_g`` is the ``G x G`` raster of the grid index that the ``grid``,
    ``grid-pallas`` and ``grid-pallas-ref`` backends build per scene.
    ``pad_scene_to`` seeds the sticky power-of-two triangle pad bucket;
    ``pad_to`` pins it exactly (overriding bucketing) when not ``None``.

    ``backend`` defaults to ``"dense"``, the CUDA kernel.  The JAX engine
    defaults to ``"dense-ref"`` only because off a TPU its Pallas kernel
    runs in interpret mode; here the kernel is the fast path on the card.
    ``online_recalibration``, ``flight_recorder`` and ``warm_store`` exist
    for parity with the JAX config; their subsystems are not ported yet,
    and setting any of them raises ``NotImplementedError``.
    """

    backend: str = "dense"
    strategy: str = "infzone"
    grid_g: int = 64
    prune_grid: int | None = None
    pad_to: int | None = None
    scene_workers: int = 0
    scene_cache: int = 256
    batch_cache: int = 8
    pad_scene_to: int = 128
    online_recalibration: bool = False
    flight_recorder: bool = False
    warm_store: str | None = None

    def __post_init__(self):
        for name in _NOT_IMPLEMENTED:
            if getattr(self, name):
                raise NotImplementedError(
                    f"RkNNConfig.{name} is not implemented in repro_torch yet"
                )


class EngineStats:
    """Cumulative engine statistics as live **views** over the engine's
    :class:`~repro_torch.obs.MetricsRegistry` (``engine.metrics
    .snapshot()`` carries the full per-``(phase, backend)``
    distributions)."""

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics

    def _phase_sum(self, name: str, phase: str) -> float:
        return sum(
            h.sum
            for labels, h in self.metrics.find(name)
            if labels.get("phase") == phase
        )

    @property
    def n_queries(self) -> int:
        return self.metrics.counter("queries").value

    @property
    def n_batches(self) -> int:
        return self.metrics.counter("batches").value

    @property
    def t_filter_s(self) -> float:
        return self._phase_sum("phase_s", "filter")

    @property
    def t_verify_s(self) -> float:
        return self._phase_sum("phase_s", "verify")

    @property
    def m_max(self) -> int:
        return int(self.metrics.gauge("m_max").value)

    @property
    def batch_cache_hits(self) -> int:
        return self.metrics.counter("batch_cache.hits").value

    def __repr__(self) -> str:
        fields = ("n_queries", "n_batches", "t_filter_s", "t_verify_s", "m_max",
                  "batch_cache_hits")
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in fields)
        return f"EngineStats({inner})"


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def _normalize_queries(
    facilities: np.ndarray, qs
) -> tuple[list[int | np.ndarray], np.ndarray, list[int | None]]:
    """Split a query batch into per-query build args, points, and excludes."""
    queries: list[int | np.ndarray] = []
    q_pts = np.zeros((len(qs), 2), np.float64)
    excludes: list[int | None] = []
    for i, q in enumerate(qs):
        arr = np.asarray(q)
        if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
            qi = int(arr)
            queries.append(qi)
            q_pts[i] = facilities[qi]
            excludes.append(qi)
        else:
            pt = np.asarray(q, np.float64).reshape(2)
            queries.append(pt)
            q_pts[i] = pt
            excludes.append(None)
    return queries, q_pts, excludes


class RkNNEngine:
    """Build once from ``(facilities, users, RkNNConfig)``; query many times.

    Exposes :meth:`query`, :meth:`query_batch`, :meth:`query_mono`, and
    :meth:`stream` (double-buffered host scene builds overlapping device
    dispatch).  Backend selection defaults to ``config.backend`` and can be
    overridden per call with any name in the backend registry.

    ``device=None`` means ``"cuda"`` and raises when no card is visible;
    pass ``device="cpu"`` to run the plain PyTorch versions on the host.
    """

    def __init__(
        self,
        facilities: np.ndarray,
        users: np.ndarray,
        config: RkNNConfig | None = None,
        *,
        rect: Rect | None = None,
        device: str | torch.device | None = None,
        **overrides,
    ):
        config = config or RkNNConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        get_backend(config.backend)  # validate eagerly
        self.config = config
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self._init_metrics()
        self._snap = self._make_snapshot(
            np.asarray(facilities, dtype=np.float64),
            np.asarray(users, dtype=np.float64),
            rect=rect,
        )
        self._pad_bucket = max(int(config.pad_scene_to), 1)

    def _make_snapshot(
        self, facilities: np.ndarray, users: np.ndarray, *, rect: Rect | None
    ) -> EngineSnapshot:
        """A fresh :class:`EngineSnapshot` sized from the engine config."""
        scene_cache = (
            SceneCache(capacity=self.config.scene_cache)
            if self.config.scene_cache > 0
            else None
        )
        return EngineSnapshot(
            0,
            facilities,
            users,
            self.device,
            rect=rect,
            explicit_rect=rect is not None,
            scene_cache=scene_cache,
            batch_capacity=self.config.batch_cache,
        )

    # ------------------------------------------------------------------
    # observability (the engine's metrics registry; EngineStats is a view)
    # ------------------------------------------------------------------
    def _init_metrics(self) -> None:
        """Eager scalar metrics + derived gauges.  Per-(phase, backend)
        histograms are created lazily through the handle cache so the
        steady-state query cost is one dict hit + one observe."""
        m = self.metrics
        self._m_queries = m.counter("queries")
        self._m_batches = m.counter("batches")
        self._m_cache_hits = m.counter("batch_cache.hits")
        self._m_mmax = m.gauge("m_max")
        self._metric_cache: dict = {}
        m.derived("scene_cache.hit_ratio", self._scene_cache_hit_ratio)
        m.derived("batch_cache.hit_ratio", self._batch_cache_hit_ratio)

    def _scene_cache_hit_ratio(self) -> float | None:
        sc = self._snap.scene_cache
        if sc is None:
            return None
        total = sc.hits + sc.misses
        return sc.hits / total if total else None

    def _batch_cache_hit_ratio(self) -> float | None:
        n = self._m_batches.value
        return self._m_cache_hits.value / n if n else None

    def _phase_hist(self, phase: str, backend: str) -> Histogram:
        key = (phase, backend)
        h = self._metric_cache.get(key)
        if h is None:
            h = self._metric_cache[key] = self.metrics.histogram(
                "phase_s", phase=phase, backend=backend
            )
        return h

    # ------------------------------------------------------------------
    # snapshot delegation
    # ------------------------------------------------------------------
    @property
    def facilities(self) -> np.ndarray:
        return self._snap.facilities

    @property
    def users(self) -> np.ndarray:
        return self._snap.users

    @property
    def scene_cache(self) -> SceneCache | None:
        return self._snap.scene_cache

    @property
    def rect(self) -> Rect:
        """The shared domain rectangle (facilities ∪ users, padded)."""
        return self._snap.rect

    @property
    def xs(self) -> torch.Tensor:
        return self._snap.xs

    @property
    def ys(self) -> torch.Tensor:
        return self._snap.ys

    def _rect_for(self, snap: EngineSnapshot, q_pts: np.ndarray) -> Rect:
        """Snapshot rect, extended only when a query point falls outside
        the facility∪user hull (keeps one-shot shims bit-compatible with
        the per-call ``Rect.from_points(F, q, U)``)."""
        if snap.explicit_rect:
            return snap.rect
        lo, hi = snap.hull_bounds()
        if np.all(q_pts >= lo) and np.all(q_pts <= hi):
            return snap.rect
        return Rect.from_points(snap.facilities, q_pts, snap.users)

    # ------------------------------------------------------------------
    # filter phase helpers (host)
    # ------------------------------------------------------------------
    def _build_scene(
        self, snap: EngineSnapshot, q, k: int, rect: Rect, *, pad_to: int | None = None
    ):
        if snap.scene_cache is not None and pad_to is None:
            scene, _hit = snap.scene_cache.get_or_build(
                snap.facilities,
                q,
                k,
                rect,
                fp=snap.fingerprint(),
                strategy=self.config.strategy,
                grid=self.config.prune_grid,
                users_hint=snap.users,
            )
            return scene
        return build_scene(
            snap.facilities,
            q,
            k,
            rect,
            strategy=self.config.strategy,
            grid=self.config.prune_grid,
            pad_to=pad_to,
            users_hint=snap.users,
        )

    def _index_for(self, snap: EngineSnapshot, backend: Backend, scene: Scene) -> Any:
        """Per-scene index from the snapshot's memo, so cached scenes carry
        their grid across repeated queries."""
        store = snap.index_memo.store_for(scene)
        key = (backend.name, self.config.grid_g)
        if key not in store:
            # the backend's own build memo shares the store: grid and
            # grid-pallas dedupe their underlying grid build through it
            store[key] = backend.build_index(
                scene, grid_g=self.config.grid_g, memo=store
            )
        return store[key]

    def _build_scenes(
        self, snap: EngineSnapshot, queries: list, k: int, rect: Rect, workers: int
    ):
        """Cache-aware host scene builds, optionally thread-pooled."""

        def one(q):
            return self._build_scene(snap, q, k, rect)

        if workers > 0 and len(queries) > 1:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                return list(pool.map(one, queries))
        return [one(q) for q in queries]

    def _mp_bucket(self, scenes: list[Scene]) -> int:
        if self.config.pad_to is not None:
            return self.config.pad_to
        mmax = max(s.tris.shape[0] for s in scenes)
        # lock-free monotone max: concurrent batches may briefly lose an
        # update, costing at most one extra stacked shape — never a wrong pad
        bucket = max(self._pad_bucket, _next_pow2(mmax))
        self._pad_bucket = bucket
        return bucket

    def _filter_batch(
        self,
        snap: EngineSnapshot,
        backend: Backend,
        queries: list,
        q_pts: np.ndarray,
        excludes: list,
        k: int,
        rect: Rect,
        scene_workers: int,
    ) -> tuple[BatchRequest, Any, list[Scene]]:
        """Host filter phase for one batch: scenes + stacked backend state,
        LRU-cached by (backend, k, queries, rect) so a repeated workload
        collapses to a dictionary lookup."""
        cache_key = None
        if self.config.batch_cache > 0:
            cache_key = (backend.name, k, tuple(_q_key(q) for q in queries), rect)
            hit = snap.batch_cache.get(cache_key)
            if hit is not None:
                self._m_cache_hits.inc()
                return hit

        scenes = self._build_scenes(snap, queries, k, rect, scene_workers)
        req = BatchRequest(
            xs=snap.xs,
            ys=snap.ys,
            k=k,
            device=snap.device,
            rect=rect,
            grid_g=self.config.grid_g,
            scenes=scenes,
            indexes=[self._index_for(snap, backend, s) for s in scenes],
            users=snap.users,
            facilities=snap.facilities,
            q_pts=q_pts,
            excludes=excludes,
            mp=self._mp_bucket(scenes),
            memo=snap.kernel_memo,
        )
        prepared = backend.prepare_batch(req)
        if cache_key is not None:
            snap.batch_cache.put(cache_key, (req, prepared, scenes))
        return req, prepared, scenes

    def _brute_batch(self, snap: EngineSnapshot, k: int, q_pts, excludes) -> BatchRequest:
        """Batch request of a geometry-free backend: no scenes; the device
        users (uploaded once per snapshot) and the snapshot's memo, where
        the rank-count kernel's user order is kept."""
        return BatchRequest(
            xs=snap.xs,
            ys=snap.ys,
            k=k,
            device=snap.device,
            users=snap.users,
            facilities=snap.facilities,
            q_pts=q_pts,
            excludes=excludes,
            memo=snap.kernel_memo,
        )

    # ------------------------------------------------------------------
    # public query surface
    # ------------------------------------------------------------------
    def query(self, q, k: int, *, backend: str | None = None) -> RkNNResult:
        """Bichromatic RkNN of one query (facility index or ``[2]`` point)."""
        return self._query(self._snap, q, k, backend=backend)

    def _query(
        self, snap: EngineSnapshot, q, k: int, *, backend: str | None = None
    ) -> RkNNResult:
        b = get_backend(backend or self.config.backend)
        arr = np.asarray(q)
        if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
            q_build: int | np.ndarray = int(arr)
            q_pt, exclude = snap.facilities[int(arr)], int(arr)
        else:
            q_pt = np.asarray(q, np.float64).reshape(2)
            q_build, exclude = q_pt, None

        if not b.uses_scene:
            # geometry-free: never materialize the device user arrays
            with span("query", backend=b.name, version=snap.version):
                with span("verify", backend=b.name) as sv:
                    counts = b.count(
                        QueryRequest(
                            xs=None,
                            ys=None,
                            k=k,
                            device=snap.device,
                            users=snap.users,
                            facilities=snap.facilities,
                            q_pt=q_pt,
                            exclude=exclude,
                        )
                    )
            t_verify = sv.elapsed_s
            self._m_queries.inc()
            self._phase_hist("verify", b.name).observe(t_verify)
            return RkNNResult(
                counts < k, counts, None, 0.0, t_verify, b.name, snap.version
            )

        with span("query", backend=b.name, version=snap.version):
            with span("filter", backend=b.name) as sf:
                rect = self._rect_for(snap, q_pt[None])
                scene = self._build_scene(
                    snap, q_build, k, rect, pad_to=self.config.pad_to
                )
                index = self._index_for(snap, b, scene)
                xs, ys = snap.xs, snap.ys
            with span("verify", backend=b.name) as sv:
                counts = b.count(
                    QueryRequest(
                        xs=xs,
                        ys=ys,
                        k=k,
                        device=snap.device,
                        grid_g=self.config.grid_g,
                        scene=scene,
                        index=index,
                        users=snap.users,
                        memo=snap.kernel_memo,
                    )
                )
        t_filter, t_verify = sf.elapsed_s, sv.elapsed_s
        self._m_queries.inc()
        self._phase_hist("filter", b.name).observe(t_filter)
        self._phase_hist("verify", b.name).observe(t_verify)
        self._m_mmax.set_max(scene.n_tris)
        return RkNNResult(
            counts < k, counts, scene, t_filter, t_verify, b.name, snap.version
        )

    def query_batch(
        self,
        qs,
        k: int,
        *,
        backend: str | None = None,
        scene_workers: int | None = None,
    ) -> RkNNBatchResult:
        """Batched bichromatic RkNN: all of ``qs`` against the shared users.

        One host filter phase (scene builds — cache-aware — plus backend
        stacking) and ONE batched device dispatch.  Masks are bit-identical
        to looping :meth:`query` per query.
        """
        snap = self._snap
        b = get_backend(backend or self.config.backend)
        workers = (
            self.config.scene_workers if scene_workers is None else scene_workers
        )
        qs = list(qs)
        n_users = len(snap.users)
        if not qs:
            return RkNNBatchResult(
                masks=np.zeros((0, n_users), bool),
                counts=np.zeros((0, n_users), np.int32),
                scenes=None if not b.uses_scene else [],
                t_filter_s=0.0,
                t_verify_s=0.0,
                backend=b.name,
                k=k,
                version=snap.version,
            )
        queries, q_pts, excludes = _normalize_queries(snap.facilities, qs)

        if not b.uses_scene:
            with span("batch", backend=b.name, q=len(qs), version=snap.version):
                with span("verify", backend=b.name) as sv:
                    counts = b.count_batch(
                        self._brute_batch(snap, k, q_pts, excludes), None
                    )
            t_verify = sv.elapsed_s
            self._m_queries.inc(len(qs))
            self._m_batches.inc()
            self._phase_hist("verify", b.name).observe(t_verify)
            return RkNNBatchResult(
                counts < k, counts, None, 0.0, t_verify, b.name, k, snap.version
            )

        with span("batch", backend=b.name, q=len(qs), version=snap.version):
            with span("filter", backend=b.name) as sf:
                rect = self._rect_for(snap, q_pts)
                req, prepared, scenes = self._filter_batch(
                    snap, b, queries, q_pts, excludes, k, rect, workers
                )
            with span("verify", backend=b.name) as sv:
                counts = b.count_batch(req, prepared)
        t_filter, t_verify = sf.elapsed_s, sv.elapsed_s
        self._m_queries.inc(len(qs))
        self._m_batches.inc()
        self._phase_hist("filter", b.name).observe(t_filter)
        self._phase_hist("verify", b.name).observe(t_verify)
        self._m_mmax.set_max(max(s.n_tris for s in scenes))
        return RkNNBatchResult(
            counts < k, counts, scenes, t_filter, t_verify, b.name, k, snap.version
        )

    def query_mono(self, q_idx: int, k: int, *, backend: str | None = None) -> RkNNResult:
        """Monochromatic RkNN over the facility set (paper §2.1 / §4.5).

        Reduces to the bichromatic machinery with ``F = U = facilities`` at
        threshold ``k + 1`` (every point's ray hits its own occluder), then
        self-hit-corrects the counts (see :func:`repro_torch.core.rknn.
        rknn_mono_query` for the derivation).  The ``bvh`` backend's counts
        saturate at ``k + 1`` before the correction, so at ``k`` after it.
        """
        q_idx = int(q_idx)
        snap = self._snap
        if snap._is_mono is None:
            snap._is_mono = snap.users is snap.facilities or (
                snap.users.shape == snap.facilities.shape
                and np.array_equal(snap.users, snap.facilities)
            )
        if snap._is_mono:
            res = self._query(snap, q_idx, k + 1, backend=backend)
        else:
            if snap._mono is None:
                # the sub-engine is pinned to this snapshot's facilities, so
                # it rides the snapshot (benign first-touch race: two racing
                # builders produce equal engines, last assignment wins)
                snap._mono = RkNNEngine(
                    snap.facilities,
                    snap.facilities,
                    self.config,
                    rect=snap._rect if snap.explicit_rect else None,
                    device=self.device,
                )
            res = snap._mono.query(q_idx, k + 1, backend=backend)
            # mirror the sub-engine's work into our metrics
            self._m_queries.inc()
            self._phase_hist("filter", res.backend).observe(res.t_filter_s)
            self._phase_hist("verify", res.backend).observe(res.t_verify_s)
        counts = np.asarray(res.counts, np.int32).copy()
        # self-hit correction: every point except q hits its own occluder
        # (q's occluder is excluded from the scene, so its count is already
        # "others")
        counts[np.arange(len(counts)) != q_idx] -= 1
        np.maximum(counts, 0, out=counts)
        mask = counts < k
        mask[q_idx] = False
        return RkNNResult(
            mask,
            counts,
            res.scene,
            res.t_filter_s,
            res.t_verify_s,
            res.backend,
            snap.version,
        )

    def stream(self, batches, k: int, *, backend: str | None = None):
        """Double-buffered batch stream: the host filter phase of batch
        ``i+1`` (scene builds + stacking, in a producer thread) overlaps the
        device dispatch of batch ``i``.  Yields ``(batch, masks[Q, N])``.

        Producer exceptions are re-raised in the consumer — the generator
        never hangs on a failed build.
        """
        b = get_backend(backend or self.config.backend)
        buf: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            try:
                for batch in batches:
                    snap = self._snap
                    qs = list(batch)
                    with span("filter", backend=b.name, stream=1,
                              version=snap.version) as sf:
                        queries, q_pts, excludes = _normalize_queries(
                            snap.facilities, qs
                        )
                        if b.uses_scene:
                            rect = self._rect_for(snap, q_pts)
                            built = self._filter_batch(
                                snap, b, queries, q_pts, excludes, k, rect,
                                self.config.scene_workers,
                            )
                        else:
                            built = (self._brute_batch(snap, k, q_pts, excludes),
                                     None, None)
                    self._phase_hist("filter", b.name).observe(sf.elapsed_s)
                    buf.put((batch, len(qs), built))
                buf.put(None)
            except BaseException as e:  # surface in the consumer, no deadlock
                buf.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = buf.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            batch, q_n, (req, prepared, scenes) = item
            with span("verify", backend=b.name, stream=1) as sv:
                counts = b.count_batch(req, prepared)
            self._phase_hist("verify", b.name).observe(sv.elapsed_s)
            self._m_queries.inc(q_n)
            self._m_batches.inc()
            if scenes:
                self._m_mmax.set_max(max(s.n_tris for s in scenes))
            yield batch, counts < k
