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
paths); the ``auto`` backend is the query planner
(:mod:`repro_torch.planner`), which prices the concrete backends and
routes each request, or each group of a batch, to the cheapest, with
:meth:`RkNNEngine.explain` and the ``planner_*`` stats showing its plans.
The free functions (``rt_rknn_query`` etc.) are one-shot shims over a
throwaway engine.  Versioned updates are served by the subclass
:class:`repro_torch.dynamic.DynamicEngine`: every query path resolves the
engine's snapshot once at entry and serves that version to the end.
Batches can be served sharded: the engine's own ``mesh=`` path (a
:class:`~repro_torch.shard.mesh.UserMesh`; users cut in row order into one
slab per mesh device) and :class:`repro_torch.shard.ShardedEngine` (a
spatial partition with per-shard state) both inject their dispatch as
``BatchRequest.dispatch``.  The health layer hangs off the engine
(:meth:`RkNNEngine.serve_obs`, :attr:`RkNNEngine.sentinel`, the flight
recorder armed by ``RkNNConfig.flight_recorder``; :mod:`repro_torch.obs`),
and so does persistence (:meth:`RkNNEngine.save_state`,
:meth:`RkNNEngine.restore`, ``RkNNConfig.warm_store``;
:mod:`repro_torch.persist`).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import math
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.backends import (
    Backend,
    BatchRequest,
    QueryRequest,
    get_backend,
    on_device,
)
from repro_torch.core.geometry import Rect
from repro_torch.core.hybrid import SceneCache, _q_key
from repro_torch.core.results import RkNNBatchResult, RkNNResult
from repro_torch.core.scene import Scene, build_scene
from repro_torch.core.snapshot import EngineSnapshot, LruCache
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import user_shard_bounds
from repro_torch.obs import Histogram, MetricsRegistry, span
from repro_torch.planner.models import WorkloadShape

__all__ = ["RkNNConfig", "EngineStats", "RkNNEngine"]

#: Backends the engine's ``mesh=`` path serves: the JAX engine's
#: (``dense-ref``, ``grid``, ``bvh``) and ``dense``, the port's default.
_MESH_BACKENDS = frozenset({"dense", "dense-ref", "grid", "bvh"})


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
    ``"auto"`` routes through the query planner.

    ``online_recalibration`` feeds the planner's observed-vs-predicted
    residuals back into the active profile's coefficients (damped;
    ``auto`` backend only).  ``flight_recorder`` arms a
    :class:`repro_torch.obs.FlightRecorder` at construction: any reader or
    writer exception (and sentinel trips) dumps a postmortem bundle under
    ``flight_dir``.  ``warm_store`` warm-starts from a ``rknn-store/1``
    directory (:mod:`repro_torch.persist`): at construction every
    fingerprint-matching state category (scenes, indexes, the kernel
    bucketing, shards, the planner profile) is adopted into the fresh
    snapshot.  Best-effort — a missing or stale store leaves a fully
    functional cold engine.
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
    flight_dir: str = "flight"
    warm_store: str | None = None


class EngineStats:
    """Cumulative engine statistics as live **views** over the engine's
    :class:`~repro_torch.obs.MetricsRegistry` (``engine.metrics
    .snapshot()`` carries the full per-``(phase, backend)``
    distributions).

    The ``planner_*`` fields only move when queries route through the
    ``auto`` backend: per-backend dispatch counts and the running
    predicted-vs-observed cost totals (the planner's calibration error is
    ``planner_obs_s / planner_pred_s`` drifting from 1).

    ``events_dropped`` / ``continuous_pruned`` surface the dynamic
    engine's standing-query bookkeeping: events lost to saturated
    :class:`~repro_torch.dynamic.continuous.ContinuousQuery` buffers and
    dead handles pruned on the update path."""

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics

    def _phase_sum(self, name: str, phase: str) -> float:
        return sum(
            h.sum
            for labels, h in self.metrics.find(name)
            if labels.get("phase") == phase
        )

    def _shard_list(self, phase: str) -> list[float]:
        per = {
            int(labels["shard"]): h.sum
            for labels, h in self.metrics.find("shard.phase_s")
            if labels.get("phase") == phase
        }
        if not per:
            return []
        return [per.get(i, 0.0) for i in range(max(per) + 1)]

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

    @property
    def planner_decisions(self) -> dict:
        return {
            labels["backend"]: c.value
            for labels, c in self.metrics.find("planner.decisions")
        }

    @property
    def planner_pred_s(self) -> float:
        return sum(
            h.sum
            for labels, h in self.metrics.find("planner.plan_s")
            if labels.get("kind") == "pred"
        )

    @property
    def planner_obs_s(self) -> float:
        return sum(
            h.sum
            for labels, h in self.metrics.find("planner.plan_s")
            if labels.get("kind") == "obs"
        )

    @property
    def planner_recal_nudges(self) -> int:
        return self.metrics.counter("planner.recal_nudges").value

    @property
    def shard_filter_s(self) -> list[float]:
        return self._shard_list("filter")

    @property
    def shard_verify_s(self) -> list[float]:
        return self._shard_list("verify")

    @property
    def shard_imbalance(self) -> float:
        found = self.metrics.find("shard.imbalance")
        return found[0][1].value if found else 1.0

    @property
    def events_dropped(self) -> int:
        return self.metrics.counter("continuous.events_dropped").value

    @property
    def continuous_pruned(self) -> int:
        return self.metrics.counter("continuous.pruned").value

    def __repr__(self) -> str:
        fields = ("n_queries", "n_batches", "t_filter_s", "t_verify_s", "m_max",
                  "batch_cache_hits", "planner_decisions", "planner_pred_s",
                  "planner_obs_s", "planner_recal_nudges", "shard_filter_s",
                  "shard_verify_s", "shard_imbalance", "events_dropped",
                  "continuous_pruned")
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
    ``mesh`` (a :class:`~repro_torch.shard.mesh.UserMesh`) serves the
    ``dense``, ``dense-ref``, ``grid`` and ``bvh`` batches sharded: users
    cut in row order into one slab per mesh device, queries whole, the
    slabs' counts written into one ``[Q, N]`` tensor and copied back once.
    """

    def __init__(
        self,
        facilities: np.ndarray,
        users: np.ndarray,
        config: RkNNConfig | None = None,
        *,
        mesh=None,
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
        self.mesh = mesh
        self._devbytes_cache: tuple | None = None
        self.metrics = MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self._init_metrics()
        self._snap = self._make_snapshot(
            0,
            np.asarray(facilities, dtype=np.float64),
            np.asarray(users, dtype=np.float64),
            rect=rect,
            explicit_rect=rect is not None,
        )
        self._pad_bucket = max(int(config.pad_scene_to), 1)
        #: Lock-free read-activity clock: query entry points bump it, the
        #: dynamic writer samples it to decide whether its scene work should
        #: run deprioritized.  Races just lose a tick — it is a heuristic, so
        #: no lock touches the read path.
        self._read_clock = 0
        self._plan_log: "collections.deque[dict]" = collections.deque(maxlen=128)
        #: Health layer (all optional, never on the hot path): a flight
        #: recorder armed by config, a lazily-built sentinel and any live
        #: introspection servers.
        self.flight = None
        self._sentinel = None
        self._obs_servers: list = []
        #: Last persist operation's report (:mod:`repro_torch.persist`):
        #: store path, schema, and per-category restored/stale/absent
        #: statuses.
        self.persist_info: dict | None = None
        if config.flight_recorder:
            from repro_torch.obs.flight import FlightRecorder

            self.flight = FlightRecorder(self, dir=config.flight_dir)
        if mesh is not None:
            self._init_mesh(self._snap, mesh)
        if config.warm_store:
            from repro_torch.persist import warm_start

            warm_start(self, config.warm_store)

    def _make_snapshot(
        self,
        version: int,
        facilities: np.ndarray,
        users: np.ndarray,
        *,
        rect: Rect | None = None,
        explicit_rect: bool = False,
        scene_cache: SceneCache | None | str = "new",
    ) -> EngineSnapshot:
        """A fresh :class:`EngineSnapshot` sized from the engine config.
        ``scene_cache="new"`` allocates one (respecting the capacity
        knob); the copy-on-write update path passes its migrated cache
        instead."""
        if scene_cache == "new":
            scene_cache = (
                SceneCache(capacity=self.config.scene_cache)
                if self.config.scene_cache > 0
                else None
            )
        return EngineSnapshot(
            version,
            facilities,
            users,
            self.device,
            rect=rect,
            explicit_rect=explicit_rect,
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
        self._m_lag = m.gauge("mvcc.version_lag")
        self._m_pred = m.histogram("planner.plan_s", kind="pred")
        self._m_obs = m.histogram("planner.plan_s", kind="obs")
        self._m_nudges = m.counter("planner.recal_nudges")
        self._metric_cache: dict = {}
        m.derived("scene_cache.hit_ratio", self._scene_cache_hit_ratio)
        m.derived("batch_cache.hit_ratio", self._batch_cache_hit_ratio)
        m.derived("mvcc.version", lambda: float(self._snap.version))
        m.derived("pad_waste", self._pad_waste_ratio)
        # Memory of the *served* snapshot version, by category (evaluated
        # only at snapshot time; one memoized walk serves all categories —
        # see _device_bytes_cached).
        for cat in ("users", "shards", "indexes", "kernel", "batches",
                    "scenes", "total"):
            m.derived(
                "mem.bytes",
                (lambda cat=cat: float(
                    self._device_bytes_cached(self._snap).get(cat, 0)
                )),
                category=cat,
            )

    def _scene_cache_hit_ratio(self) -> float | None:
        sc = self._snap.scene_cache
        if sc is None:
            return None
        total = sc.hits + sc.misses
        return sc.hits / total if total else None

    def _batch_cache_hit_ratio(self) -> float | None:
        n = self._m_batches.value
        return self._m_cache_hits.value / n if n else None

    def _pad_waste_ratio(self) -> float:
        """The served snapshot's measured cell-bucketing pad waste (the
        planner's occupancy feature); a failure omits the row, as every
        derived gauge's does (``MetricsRegistry.snapshot``)."""
        return float(self._snap.pad_waste(self._snap.rect, self.config.grid_g))

    def _device_bytes_cached(self, snap: EngineSnapshot) -> dict[str, int]:
        """Memoized :meth:`EngineSnapshot.device_bytes` — one walk per
        snapshot version per ~250 ms, so a scrape reading all seven
        ``mem.bytes`` gauges pays once."""
        now = time.monotonic()
        hit = self._devbytes_cache
        if hit is not None and hit[0] is snap and now - hit[1] < 0.25:
            return hit[2]
        out = snap.device_bytes()
        self._devbytes_cache = (snap, now, out)
        return out

    def _note_lag(self, snap: EngineSnapshot) -> None:
        """``mvcc.version_lag``: versions published while a query served
        ``snap`` (0 unless a writer raced it)."""
        self._m_lag.set(float(self._snap.version - snap.version))

    def _flight_exception(self, where: str, exc: BaseException) -> None:
        """Dump a postmortem bundle when a recorder is armed (never
        raises; never runs when flight is off — the common case costs
        one attribute read on the exception path only)."""
        fr = self.flight
        if fr is not None:
            fr.record_exception(where, exc)

    # ------------------------------------------------------------------
    # health layer (live introspection, SLO sentinel, flight recorder)
    # ------------------------------------------------------------------
    def serve_obs(self, port: int = 0, host: str = "127.0.0.1"):
        """Boot the live introspection endpoint for this engine
        (``/metrics``, ``/spans``, ``/explain``, ``/snapshot``,
        ``/healthz``) on a daemon thread.  ``port=0`` binds an ephemeral
        port — read it back from the returned server's ``.port``/``.url``.
        Read-only and lock-free; see :mod:`repro_torch.obs.health.server`."""
        from repro_torch.obs.health import ObsServer

        srv = ObsServer(self, port=port, host=host)
        self._obs_servers.append(srv)
        return srv

    @property
    def sentinel(self):
        """The engine's SLO sentinel (built on first touch with the
        default rule families — see :func:`repro_torch.obs.engine_rules`).
        Drives ``/healthz``; a sustained breach dumps a flight bundle
        when a recorder is armed."""
        s = self._sentinel
        if s is None:
            from repro_torch.obs.sentinel import Sentinel, engine_rules

            rules, discover = engine_rules(self)

            def on_trip(st) -> None:
                fr = self.flight
                if fr is not None:
                    fr.dump(f"slo:{st.rule.name}")

            # benign first-touch race: two racing builders produce
            # equivalent sentinels, last assignment wins
            s = self._sentinel = Sentinel(
                rules, on_trip=on_trip, discover=discover
            )
        return s

    # ------------------------------------------------------------------
    # persistence (repro_torch.persist — versioned warm-start state store)
    # ------------------------------------------------------------------
    def save_state(self, directory: str, *, keep: int = 3) -> str:
        """Export the served snapshot's amortized state (scenes, packed
        indexes, the kernel bucketing, planner profile, shard partition)
        as the next ``rknn-store/1`` step under ``directory``.  Atomic:
        readers of the store always see a complete step.  Returns the
        published step folder."""
        from repro_torch.persist import save_engine_state

        return save_engine_state(self, directory, keep=keep)

    def restore(self, directory: str) -> dict:
        """Hot-adopt a ``rknn-store/1`` store into this **live** engine:
        builds a snapshot around the store's dataset, adopts every
        fingerprint-matching category, and publishes it as MVCC version
        N+1 via the atomic swap — in-flight readers keep serving N.
        Returns the per-category status report (also on
        ``self.persist_info``)."""
        from repro_torch.persist import restore_engine

        return restore_engine(self, directory)

    def _persist_note(self, op: str, category: str, nbytes: int, seconds) -> None:
        """Record one category's persist traffic (registry dedupes by
        label, so these are stable per-category instruments)."""
        self.metrics.gauge("persist.bytes", category=category, op=op).set(
            float(nbytes)
        )
        if seconds is not None:
            self.metrics.histogram(f"persist.{op}_s", category=category).observe(
                float(seconds)
            )

    def _persist_extra_fingerprints(self, snap: EngineSnapshot) -> dict:
        """Subclass hook: expected fingerprints for engine-specific
        categories (ShardedEngine adds ``shards``)."""
        return {}

    def _persist_extra_categories(self, snap: EngineSnapshot) -> dict:
        """Subclass hook: extra ``{name: {fingerprint, meta, arrays}}``
        categories to persist."""
        return {}

    def _persist_adopt_extra(self, snap: EngineSnapshot, name: str, entry, arrays):
        """Subclass hook: adopt one engine-specific category (fingerprint
        already matched).  Return the adopted item count, or ``None`` if
        the category is not recognized."""
        return None

    def _phase_hist(self, phase: str, backend: str) -> Histogram:
        key = (phase, backend)
        h = self._metric_cache.get(key)
        if h is None:
            h = self._metric_cache[key] = self.metrics.histogram(
                "phase_s", phase=phase, backend=backend
            )
        return h

    def _decision_counter(self, backend: str):
        key = ("dec", backend)
        c = self._metric_cache.get(key)
        if c is None:
            c = self._metric_cache[key] = self.metrics.counter(
                "planner.decisions", backend=backend
            )
        return c

    def _residual_hist(self, backend: str) -> Histogram:
        key = ("res", backend)
        h = self._metric_cache.get(key)
        if h is None:
            h = self._metric_cache[key] = self.metrics.histogram(
                "planner.residual", signed=True, backend=backend
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

    def _workload_shards(self) -> int:
        """Shard count the planner prices workloads at (the ``log_s``
        feature).  1 here; ``ShardedEngine`` overrides with its shard
        count."""
        return 1

    # ------------------------------------------------------------------
    # the mesh path: users cut in row order over the mesh's devices
    # ------------------------------------------------------------------
    def _init_mesh(self, snap: EngineSnapshot, mesh) -> None:
        """Upload the snapshot's users as one contiguous row slab per mesh
        device (float32, cast on the host as the snapshot's upload), with
        one kernel memo per slab."""
        devs = mesh.devices
        bounds = user_shard_bounds(len(snap.users), len(devs))
        xs = snap.users[:, 0].astype(np.float32)
        ys = snap.users[:, 1].astype(np.float32)
        cut = list(zip(bounds[:-1], bounds[1:], devs))
        snap.mesh_ys = tuple(torch.from_numpy(ys[lo:hi]).to(d) for lo, hi, d in cut)
        snap.mesh_xs = tuple(torch.from_numpy(xs[lo:hi]).to(d) for lo, hi, d in cut)
        snap.mesh_memos = tuple(LruCache(4) for _ in devs)
        snap.mesh_n = len(snap.users)

    def _mesh_dispatch_for(
        self, snap: EngineSnapshot, backend: Backend, *, rect: Rect, k: int
    ):
        """Engine-held device-dispatch override for ``count_batch``, or
        ``None`` (no mesh, no users, or a backend the mesh path does not
        serve: ``brute``, the ``grid-pallas`` family and ``auto``'s groups
        of those stay single-device, as in the JAX package).

        The dispatch counts every slab through the backend's
        :meth:`~repro_torch.core.backends.Backend.count_batch_device`
        (the slab's own user order in its own memo), writes it into its
        columns of one ``[Q, N]`` int32 tensor on the first slab's device
        and copies that back once.  It captures this snapshot's slabs, so
        a carried batch is re-pointed at a new version by asking again.
        """
        if (self.mesh is None or snap.mesh_xs is None or snap.mesh_n == 0
                or backend.name not in _MESH_BACKENDS):
            return None
        slabs = tuple(zip(snap.mesh_xs, snap.mesh_ys, snap.mesh_memos))
        n, grid_g = snap.mesh_n, self.config.grid_g

        def dispatch(prepared) -> np.ndarray:
            out, lo = None, 0
            for xs, ys, memo in slabs:
                if xs.shape[0] == 0:
                    continue  # fewer users than devices
                req = BatchRequest(xs=xs, ys=ys, k=k, device=xs.device, rect=rect,
                                   grid_g=grid_g, memo=memo)
                counts = backend.count_batch_device(req, on_device(prepared, xs.device))
                if out is None:
                    out = torch.empty((counts.shape[0], n), dtype=torch.int32,
                                      device=counts.device)
                out[:, lo : lo + xs.shape[0]] = counts
                lo += xs.shape[0]
            return out.cpu().numpy()

        return dispatch

    def _prepare_batch(self, backend: Backend, req: BatchRequest):
        """Backend stacking for one batch, honoring a dispatch that owns
        its own prepare step (``req.dispatch.prepare``): the sharded
        dispatch builds *per-shard* prepared state (cell buckets, planes
        compacted to the shard's cells) that the plain
        ``Backend.prepare_batch`` — which sees no partition — cannot."""
        prep = getattr(req.dispatch, "prepare", None)
        if prep is not None:
            return prep(backend, req)
        return backend.prepare_batch(req)

    def _batch_cache_get(self, snap: EngineSnapshot, key):
        """Prepared-batch lookup (None key → miss); counts a hit in the
        stats.  Lock-free — see :class:`~repro_torch.core.snapshot.LruCache`."""
        if key is None:
            return None
        hit = snap.batch_cache.get(key)
        if hit is not None:
            self._m_cache_hits.inc()
        return hit

    def _batch_cache_put(self, snap: EngineSnapshot, key, value) -> None:
        if key is not None:
            snap.batch_cache.put(key, value)

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
            hit = self._batch_cache_get(snap, cache_key)
            if hit is not None:
                return hit

        scenes = self._build_scenes(snap, queries, k, rect, scene_workers)
        dispatch = self._mesh_dispatch_for(snap, backend, rect=rect, k=k)
        # a sharded dispatch owns its own copies of the users: don't upload
        # a second, whole copy it would never read
        req = BatchRequest(
            xs=None if dispatch is not None else snap.xs,
            ys=None if dispatch is not None else snap.ys,
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
            dispatch=dispatch,
            memo=snap.kernel_memo,
        )
        prepared = self._prepare_batch(backend, req)
        self._batch_cache_put(snap, cache_key, (req, prepared, scenes))
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
    # planner (the "auto" meta-backend)
    # ------------------------------------------------------------------
    def _scene_cached(self, snap: EngineSnapshot, q, k: int, rect: Rect) -> bool:
        if snap.scene_cache is None:
            return False
        return snap.scene_cache.contains(
            snap.facilities, q, k, rect, fp=snap.fingerprint()
        )

    def _record_plan(self, planner, plan: dict, observed_s: float) -> None:
        """Close out one plan: observed cost, engine log, metrics, planner.

        ``observed_s`` comes from the query path's spans (filter + verify
        elapsed), so the planner's recalibration signal and the exported
        trace are the same measurement.  Per-dispatched-backend log-
        residuals ``log(obs/pred)`` land in signed histograms."""
        plan["observed_s"] = observed_s
        self._plan_log.append(plan)
        for name, n in plan.get("decisions", {}).items():
            self._decision_counter(name).inc(n)
        self._m_pred.observe(plan.get("predicted_s", 0.0))
        self._m_obs.observe(observed_s)
        planner.record(plan)
        for name, pred, obs, _verify_only in planner._pred_obs_pairs(plan):
            if pred > 0.0 and obs > 0.0:
                self._residual_hist(name).observe(math.log(obs / pred))
        if self.config.online_recalibration:
            self._m_nudges.inc(planner.observe(plan))

    def explain(self) -> list[dict]:
        """Recent ``auto`` plans, oldest first: each entry carries the
        chosen backend(s), predicted cost, candidate costs, and — once the
        dispatch ran — observed cost."""
        return list(self._plan_log)

    def _plan_amortized(self, snap: EngineSnapshot) -> bool:
        """Whether the planner prices geometric backends at steady-state
        (verify-only) cost.  True on engines with a scene cache: they are
        long-lived serving objects, so a scene build is an *investment*
        the cache repays on every repeat.  One-shot shims disable the cache
        and get the strict per-call comparison."""
        return snap.scene_cache is not None

    def _plan_single(
        self, snap: EngineSnapshot, planner, q_build, k: int, q_pt: np.ndarray
    ):
        """Pre-scene routing of one query.  Returns (backend, plan)."""
        rect = self._rect_for(snap, q_pt[None])
        amortized = self._plan_amortized(snap)
        shape = WorkloadShape(
            len(snap.facilities),
            len(snap.users),
            k,
            1,
            cache_hit=amortized or self._scene_cached(snap, q_build, k, rect),
            pad_waste=snap.pad_waste(rect, self.config.grid_g),
            shards=self._workload_shards(),
        )
        choice, pred, costs = planner.select(shape, planner.candidates(device=snap.device))
        plan = {
            "mode": "single",
            "backend": choice,
            "predicted_s": pred,
            "candidates": costs,
            "cache_hit": shape.cache_hit,
            "amortized": amortized,
            "decisions": {choice: 1},
        }
        return get_backend(choice), plan

    # ------------------------------------------------------------------
    # public query surface
    # ------------------------------------------------------------------
    def query(self, q, k: int, *, backend: str | None = None) -> RkNNResult:
        """Bichromatic RkNN of one query (facility index or ``[2]`` point).

        With the ``auto`` backend the planner picks the concrete backend
        *before* any scene is built (a brute decision skips the filter
        phase entirely); the result's ``backend`` field reports the
        concrete choice and :meth:`explain` the full plan.
        """
        self._read_clock += 1
        try:
            return self._query(self._snap, q, k, backend=backend)
        except Exception as e:
            self._flight_exception("query", e)
            raise

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

        plan = planner = None
        if b.is_meta:
            planner = b
            b, plan = self._plan_single(snap, planner, q_build, k, q_pt)

        if not b.uses_scene:
            # geometry-free: no scene; the device users (uploaded once per
            # snapshot) and the memo, where the rank kernel's order is kept
            with span("query", backend=b.name, version=snap.version):
                with span("verify", backend=b.name) as sv:
                    counts = b.count(
                        QueryRequest(
                            xs=snap.xs,
                            ys=snap.ys,
                            k=k,
                            device=snap.device,
                            users=snap.users,
                            facilities=snap.facilities,
                            q_pt=q_pt,
                            exclude=exclude,
                            memo=snap.kernel_memo,
                        )
                    )
            t_verify = sv.elapsed_s
            self._m_queries.inc()
            self._phase_hist("verify", b.name).observe(t_verify)
            self._note_lag(snap)
            if plan is not None:
                self._record_plan(planner, plan, t_verify)
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
        self._note_lag(snap)
        if plan is not None:
            self._record_plan(planner, plan, t_filter + t_verify)
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
        to looping :meth:`query` per query.  With the ``auto`` backend the
        planner may split the batch into per-backend groups, one dispatch
        each (:meth:`_query_batch_planner`).
        """
        self._read_clock += 1
        try:
            return self._query_batch(
                self._snap, qs, k, backend=backend, scene_workers=scene_workers
            )
        except Exception as e:
            self._flight_exception("query_batch", e)
            raise

    def _query_batch(
        self,
        snap: EngineSnapshot,
        qs,
        k: int,
        *,
        backend: str | None = None,
        scene_workers: int | None = None,
    ) -> RkNNBatchResult:
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
        if b.is_meta:
            return self._query_batch_planner(snap, b, qs, k, workers)
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
            self._note_lag(snap)
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
        self._note_lag(snap)
        return RkNNBatchResult(
            counts < k, counts, scenes, t_filter, t_verify, b.name, k, snap.version
        )

    def _dispatch_group(
        self,
        snap: EngineSnapshot,
        b: Backend,
        idxs: list[int],
        scenes: list[Scene] | None,
        q_pts: np.ndarray,
        excludes: list,
        k: int,
        rect: Rect | None,
    ) -> tuple[np.ndarray, float, float]:
        """Prepare + count one planner group.  Returns ``(counts [|idxs|, N],
        t_prepare_s, t_count_s)`` — prepare is host (filter), count device
        (verify).  Prepared geometric groups are LRU-cached alongside the
        fixed-backend batches, so a repeated ``auto`` workload skips the
        re-stacking just like a repeated fixed-backend one.
        """
        g_pts, g_excl = q_pts[idxs], [excludes[i] for i in idxs]
        with span("filter", backend=b.name, group=1) as sf:
            prepared = None
            if not b.uses_scene:
                req = self._brute_batch(snap, k, g_pts, g_excl)
            else:
                cache_key = None
                if self.config.batch_cache > 0:
                    # excludes participate in the key: a facility-index query
                    # (exclude=i) and a point query at that facility's exact
                    # coordinates (exclude=None) build different scenes
                    cache_key = (
                        "auto",
                        b.name,
                        k,
                        tuple((_q_key(q_pts[i]), excludes[i]) for i in idxs),
                        rect,
                    )
                hit = self._batch_cache_get(snap, cache_key)
                if hit is not None:
                    req, prepared, _sub = hit
                else:
                    sub = [scenes[i] for i in idxs]
                    dispatch = self._mesh_dispatch_for(snap, b, rect=rect, k=k)
                    req = BatchRequest(
                        xs=None if dispatch is not None else snap.xs,
                        ys=None if dispatch is not None else snap.ys,
                        k=k,
                        device=snap.device,
                        rect=rect,
                        grid_g=self.config.grid_g,
                        scenes=sub,
                        indexes=[self._index_for(snap, b, s) for s in sub],
                        users=snap.users,
                        facilities=snap.facilities,
                        q_pts=g_pts,
                        excludes=g_excl,
                        mp=self._mp_bucket(sub),
                        dispatch=dispatch,
                        memo=snap.kernel_memo,
                    )
                    prepared = self._prepare_batch(b, req)
                    self._batch_cache_put(snap, cache_key, (req, prepared, sub))
        with span("verify", backend=b.name, group=1) as sv:
            counts = b.count_batch(req, prepared)
        return counts, sf.elapsed_s, sv.elapsed_s

    def _query_batch_planner(
        self, snap: EngineSnapshot, planner, qs: list, k: int, workers: int
    ) -> RkNNBatchResult:
        """The ``auto`` batched path: price, (maybe) filter, split, recombine.

        Two-stage decision:

        1. *Pre-scene*: the whole batch is priced with the estimated scene
           size.  If brute wins outright, no scene is ever built.
        2. *Post-scene*: scenes are built (cache-aware), each query is
           re-priced with its **actual** triangle count (filter cost now
           sunk → ``cache_hit=True``), and the batch is partitioned into
           per-backend groups dispatched independently; counts recombine
           in query order.  Count *semantics* may differ per row (bvh
           saturates at ``k``, brute counts distance ranks) — masks are
           the invariant, as everywhere else.

        The whole decision (assignments + scenes) is memoized in the batch
        LRU, keyed on the profile epoch: a repeated workload goes straight
        to its group dispatches (which hit their own prepared-group LRU)
        without re-planning, until a new profile is activated.
        """
        queries, q_pts, excludes = _normalize_queries(snap.facilities, qs)
        n_f, n_u, q_n = len(snap.facilities), len(snap.users), len(qs)
        with span("batch", backend="auto", q=q_n, version=snap.version) as sb:
            counts, plan, scenes, t_count_total = self._plan_and_dispatch(
                snap, planner, queries, q_pts, excludes, k, workers,
                n_f=n_f, n_u=n_u, q_n=q_n,
            )
        # filter = everything in the batch wall that was not a group's
        # device count dispatch (planning, scene builds, group stacking)
        t_filter = sb.elapsed_s - t_count_total

        self._m_queries.inc(q_n)
        self._m_batches.inc()
        self._phase_hist("filter", "auto").observe(t_filter)
        self._note_lag(snap)
        if scenes:
            self._m_mmax.set_max(max(s.n_tris for s in scenes))
        self._record_plan(planner, plan, sb.elapsed_s)
        return RkNNBatchResult(
            counts < k, counts, scenes, t_filter, t_count_total, "auto", k,
            snap.version,
        )

    def _plan_and_dispatch(
        self, snap, planner, queries, q_pts, excludes, k, workers, *, n_f, n_u, q_n
    ):
        """Body of the ``auto`` batch (inside its ``batch`` span): plan
        (or reuse a memoized decision), build scenes, dispatch groups."""
        rect = self._rect_for(snap, q_pts)
        pad_w = snap.pad_waste(rect, self.config.grid_g)
        cands = planner.candidates(device=snap.device)  # on a card: no plain twin

        plan_key = cached_decision = None
        if self.config.batch_cache > 0:
            from repro_torch.planner.profiles import profile_epoch

            # the epoch invalidates memoized decisions when the operator
            # activates a new (re)calibrated profile
            plan_key = (
                "auto-plan",
                profile_epoch(),
                k,
                tuple(_q_key(q) for q in queries),
                rect,
            )
            cached_decision = self._batch_cache_get(snap, plan_key)

        if cached_decision is not None:
            per_q, groups, scenes = cached_decision
            plan: dict = {
                "mode": "batch",
                "predicted_s": sum(cost for _, cost in per_q),
                "plan_cache_hit": True,
                "k": k,
                "q": q_n,
            }
        else:
            # price geometric backends at verify-only cost when the filter
            # phase is already amortized (scenes cached) — or *will* be (see
            # _plan_amortized)
            amortized = self._plan_amortized(snap) or all(
                self._scene_cached(snap, q, k, rect) for q in queries
            )
            batch_shape = WorkloadShape(
                n_f, n_u, k, q_n, cache_hit=amortized, pad_waste=pad_w,
                shards=self._workload_shards(),
            )
            ranked = planner.rank(batch_shape, cands)
            plan = {
                "mode": "batch",
                "predicted_s": ranked[0][1],
                "candidates": dict(ranked),
                "amortized": amortized,
                "k": k,
                "q": q_n,
            }
            if not get_backend(ranked[0][0]).uses_scene:
                # brute wins on the estimate: never build a scene
                name = ranked[0][0]
                per_q = [(name, ranked[0][1] / max(q_n, 1))] * q_n
                groups = {name: list(range(q_n))}
                scenes = None
            else:
                scenes = self._build_scenes(snap, queries, k, rect, workers)
                # re-price per query with the actual scene size; the filter
                # cost is sunk now
                per_q = planner.assign_batch(
                    [
                        WorkloadShape(
                            n_f, n_u, k, 1, m_tris=s.n_tris, cache_hit=True,
                            pad_waste=pad_w, shards=self._workload_shards(),
                        )
                        for s in scenes
                    ],
                    cands,
                )
                groups = {}
                for i, (name, _cost) in enumerate(per_q):
                    groups.setdefault(name, []).append(i)
            self._batch_cache_put(snap, plan_key, (per_q, groups, scenes))

        counts = np.zeros((q_n, n_u), np.int32)
        t_count_total = 0.0
        observed_group: dict[str, float] = {}
        for name, idxs in groups.items():
            gcounts, t_prep, t_count = self._dispatch_group(
                snap, get_backend(name), idxs, scenes, q_pts, excludes, k, rect
            )
            counts[idxs] = gcounts
            t_count_total += t_count
            # the group's device count time lands under ITS backend; the
            # host-side remainder lands under "auto" in the caller
            self._phase_hist("verify", name).observe(t_count)
            observed_group[name] = t_prep + t_count

        plan.update(
            assignments=[name for name, _ in per_q],
            predicted_per_query=[cost for _, cost in per_q],
            split=len(groups) > 1,
            groups={name: len(idxs) for name, idxs in groups.items()},
            observed_group_s=observed_group,
            decisions={name: len(idxs) for name, idxs in groups.items()},
        )
        return counts, plan, scenes, t_count_total

    def query_mono(self, q_idx: int, k: int, *, backend: str | None = None) -> RkNNResult:
        """Monochromatic RkNN over the facility set (paper §2.1 / §4.5).

        Reduces to the bichromatic machinery with ``F = U = facilities`` at
        threshold ``k + 1`` (every point's ray hits its own occluder), then
        self-hit-corrects the counts (see :func:`repro_torch.core.rknn.
        rknn_mono_query` for the derivation).  The ``bvh`` backend's counts
        saturate at ``k + 1`` before the correction, so at ``k`` after it.
        """
        self._read_clock += 1
        try:
            return self._query_mono(int(q_idx), k, backend=backend)
        except Exception as e:
            self._flight_exception("query_mono", e)
            raise

    def _query_mono(self, q_idx: int, k: int, *, backend: str | None) -> RkNNResult:
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

        With the ``auto`` backend the planner re-routes each batch as a
        whole (pre-scene, estimated cost — no per-query splitting on the
        streaming path, which would defeat the double buffering).
        """
        b = get_backend(backend or self.config.backend)
        buf: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            try:
                for batch in batches:
                    # one snapshot per batch: each yielded mask set is a
                    # consistent view of exactly one version, and a stream
                    # picks up concurrent updates batch to batch
                    self._read_clock += 1
                    snap = self._snap
                    qs = list(batch)
                    with span("filter", backend=b.name, stream=1,
                              version=snap.version) as sf:
                        queries, q_pts, excludes = _normalize_queries(
                            snap.facilities, qs
                        )
                        b_eff, plan = b, None
                        if b.is_meta:
                            shape = WorkloadShape(
                                len(snap.facilities),
                                len(snap.users),
                                k,
                                len(qs),
                                cache_hit=self._plan_amortized(snap),
                                pad_waste=snap.pad_waste(snap.rect, self.config.grid_g),
                                shards=self._workload_shards(),
                            )
                            choice, pred, costs = b.select(
                                shape, b.candidates(device=snap.device)
                            )
                            plan = {
                                "mode": "stream-batch",
                                "backend": choice,
                                "predicted_s": pred,
                                "candidates": costs,
                                "cache_hit": shape.cache_hit,
                                "decisions": {choice: len(qs)},
                            }
                            b_eff = get_backend(choice)
                        if b_eff.uses_scene:
                            rect = self._rect_for(snap, q_pts)
                            built = self._filter_batch(
                                snap, b_eff, queries, q_pts, excludes, k, rect,
                                self.config.scene_workers,
                            )
                        else:
                            built = (self._brute_batch(snap, k, q_pts, excludes),
                                     None, None)
                    self._phase_hist("filter", b.name).observe(sf.elapsed_s)
                    buf.put((batch, len(qs), b_eff, plan, sf.elapsed_s, built))
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
                if isinstance(item, Exception):
                    self._flight_exception("stream", item)
                raise item
            batch, q_n, b_eff, plan, t_filter, (req, prepared, scenes) = item
            with span("verify", backend=b_eff.name, stream=1) as sv:
                counts = b_eff.count_batch(req, prepared)
            self._phase_hist("verify", b_eff.name).observe(sv.elapsed_s)
            self._m_queries.inc(q_n)
            self._m_batches.inc()
            if scenes:
                self._m_mmax.set_max(max(s.n_tris for s in scenes))
            if plan is not None:
                # observed = this batch's own filter + verify work — NOT the
                # wall-clock since the producer started, which would include
                # time spent waiting in the double buffer
                self._record_plan(b, plan, t_filter + sv.elapsed_s)
            yield batch, counts < k
