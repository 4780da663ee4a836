"""The versioned dynamic engine: incremental updates over ``RkNNEngine``
(``repro.dynamic.engine``).

Every query path in the static engine serves one immutable
:class:`~repro_torch.core.snapshot.EngineSnapshot`; :class:`DynamicEngine`
advances that snapshot the way graphics pipelines do — by *refitting*
acceleration state instead of rebuilding it, copy-on-write:

* :meth:`apply_updates` takes an :class:`~repro_torch.dynamic.updates.UpdateBatch`
  (facility insert/delete/move, user insert/delete/move), builds version
  N+1 **off to the side** with structural sharing against version N, and
  publishes it with a single atomic reference swap.  Every piece of
  amortized engine state is reconciled with the delta rather than
  dropped:

  - **device user tensors** — pure user *moves* scatter out of place
    (``Tensor.index_copy`` returns new tensors on the engine's device;
    version N's stay untouched) into the new snapshot's resident
    ``xs``/``ys``; only inserts/deletes force a re-upload.  Per-user-set
    kernel state (the users' spatial order, the grid-pallas cell
    bucketing) is keyed on the identity of ``xs``, so a version whose
    users changed rebuilds it on its first query, and a version whose
    users did not shares it by reference;
  - **scene cache** — entries are migrated through the three-level
    survive / refit / rebuild ladder of :mod:`repro_torch.dynamic.refit` into
    the new snapshot's cache: a scene whose pruning certificate the
    delta does not pierce is re-keyed (row ids remapped) and survives
    with its memoized grid/BVH indexes; a pierced scene whose kept set a
    re-prune confirms unchanged is patched (occluder fans of moved
    facilities respliced, indexes refit via ``Backend.refit_index``);
    everything else is dropped and rebuilt lazily.  Eager-refit vs
    lazy-rebuild is a priced decision
    (:class:`~repro_torch.dynamic.policy.RefitPolicy`, fed by the planner's
    cost profile and its own observed EMAs);
  - **prepared-batch LRU / plan memos** — carried across the swap for
    user-only deltas (requests re-pointed at the new snapshot's device
    tensors; backends whose prepared state holds user coordinates are
    rebuilt — ``Backend.prepared_carries_users``); any facility or
    shape-changing delta starts the new version's LRU cold;
  - **continuous queries** — one *vectorized* influence-zone dirty test
    runs across all live :class:`~repro_torch.dynamic.continuous.ContinuousQuery`
    handles per update (:func:`~repro_torch.dynamic.continuous.influence_dirty_mask`);
    only the handles it marks dirty fall into the exact per-handle patch,
    the rest take a remap-and-skip fast path.  Their counts are host numpy
    (float64 distance ranks), as in the JAX package.

The JAX engine's device-mesh branches (sharded user copies scattered
beside ``xs``/``ys``, mesh dispatches re-pointed in carried batches) are
not here: this package has no sharded serving yet.

Equivalence contract (property-tested): after any sequence of
``apply_updates``, every query path on this engine returns bit-identical
results to a cold ``RkNNEngine`` built from ``(self.facilities,
self.users)`` — for every registered backend.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.grid import (
    build_sleep,
    build_slept_s,
    build_throttle,
    build_yield_ratio,
)
from repro_torch.core.pruning import adaptive_grid
from repro_torch.core.snapshot import EngineSnapshot
from repro_torch.dynamic.continuous import ContinuousQuery, influence_dirty_mask
from repro_torch.dynamic.policy import RefitPolicy
from repro_torch.dynamic.refit import refit_scene, remap_scene, scene_update_safe
from repro_torch.dynamic.updates import UpdateBatch, apply_to_points, changed_positions
from repro_torch.obs import span
from repro_torch.planner.models import WorkloadShape

__all__ = ["DynamicEngine", "UpdateReport", "DynamicStats"]

#: Writer-side scene prewarm budget per update: standing scenes the
#: migration dropped are rebuilt into the NEXT snapshot before it
#: publishes (readers keep serving the current version meanwhile), capped
#: so one pathological delta cannot stall the writer indefinitely.
PREWARM_SCENES_CAP = 64


@dataclasses.dataclass
class UpdateReport:
    """What one :meth:`DynamicEngine.apply_updates` call did."""

    version: int
    t_update_s: float
    rect_changed: bool
    scenes_survived: int = 0
    scenes_refit: int = 0
    scenes_dropped: int = 0
    scenes_prewarmed: int = 0
    indexes_refit: int = 0
    indexes_rebuilt: int = 0
    users_scattered: bool = False
    batches_carried: int = 0
    continuous_patched: int = 0
    continuous_skipped: int = 0
    continuous_events: int = 0


@dataclasses.dataclass
class DynamicStats:
    """Cumulative counters across the engine's update lifetime."""

    n_updates: int = 0
    t_update_s: float = 0.0
    scenes_survived: int = 0
    scenes_refit: int = 0
    scenes_dropped: int = 0
    scenes_prewarmed: int = 0
    indexes_refit: int = 0
    indexes_rebuilt: int = 0
    user_scatters: int = 0
    user_reuploads: int = 0
    batches_carried: int = 0


class DynamicEngine(RkNNEngine):
    """A :class:`RkNNEngine` whose snapshot can change underneath it.

    Construction matches the static engine; all query methods are
    inherited unchanged.  Each query call resolves the engine's current
    :class:`~repro_torch.core.snapshot.EngineSnapshot` exactly once at entry
    and serves that version end-to-end, so **queries run concurrently
    with updates without any lock on the read path**: an
    :meth:`apply_updates` racing a query (or an active :meth:`stream`)
    never produces a mixed old/new view — in-flight work finishes on
    version N while the swap publishes N+1, and every result reports the
    snapshot ``version`` it is bit-identical to.  Concurrent *writers*
    are serialized against each other by an internal writer lock.

    ``device`` is the static engine's: ``None`` means ``"cuda"``, and
    ``device="cpu"`` runs the plain PyTorch versions on the host.
    """

    def __init__(self, facilities, users, config: RkNNConfig | None = None, **kw):
        super().__init__(facilities, users, config, **kw)
        self.update_stats = DynamicStats()
        self.refit_policy = RefitPolicy()
        self._writer_lock = threading.Lock()  # writer-writer only
        self._continuous: list[ContinuousQuery] = []
        self._update_log: list[UpdateReport] = []

    @property
    def version(self) -> int:
        """The currently published snapshot's version (monotonic)."""
        return self._snap.version

    # ------------------------------------------------------------------
    # continuous queries
    # ------------------------------------------------------------------
    def register_continuous(self, q, k: int) -> ContinuousQuery:
        """Register a standing RkNN query (facility index or ``[2]``
        point); it is re-evaluated on exactly the updates that can change
        it and streams ``(version, RkNNResult)`` via ``poll()``."""
        snap = self._snap
        cq = ContinuousQuery(snap.facilities, snap.users, q, k, snap.version)
        self._continuous.append(cq)
        return cq

    def explain_updates(self) -> list[UpdateReport]:
        """Per-update reports, oldest first (bounded to the last 128)."""
        return list(self._update_log)

    # ------------------------------------------------------------------
    # observed rebuild costs feed the refit-vs-rebuild frontier
    # ------------------------------------------------------------------
    def _build_scene(
        self, snap: EngineSnapshot, q, k: int, rect, *, pad_to: int | None = None
    ):
        misses = snap.scene_cache.misses if snap.scene_cache is not None else None
        with span("scene-build", version=snap.version) as sb:
            scene = super()._build_scene(snap, q, k, rect, pad_to=pad_to)
        if (
            misses is not None
            and snap.scene_cache.misses > misses
            and build_yield_ratio() == 0.0
        ):
            # throttled (deprioritized-prewarm) builds sleep ~2x their CPU
            # time — feeding that wall time into the frontier would teach
            # the policy that rebuilds cost 3x what they do
            self.refit_policy.observe("rebuild", sb.elapsed_s)
        return scene

    # ------------------------------------------------------------------
    # the update path (the writer side of the MVCC pair)
    # ------------------------------------------------------------------
    def apply_updates(self, batch: UpdateBatch | None = None, **deltas) -> UpdateReport:
        """Apply one atomic delta; returns the new-version report.

        Accepts either a prebuilt :class:`UpdateBatch` or its fields as
        keyword arguments (``apply_updates(user_move=(ids, pts))``).
        Builds the next snapshot copy-on-write and publishes it with one
        atomic reference swap — concurrent queries are never blocked and
        never observe a partial update.
        """
        if batch is None:
            batch = UpdateBatch(**deltas)
        elif deltas:
            raise TypeError("pass either an UpdateBatch or keyword deltas, not both")
        try:
            return self._apply_updates_guarded(batch)
        except Exception as e:
            # black box: a writer crash leaves the engine serving the old
            # (still consistent) snapshot — dump what it was doing first
            self._flight_exception("apply_updates", e)
            raise

    def _apply_updates_guarded(self, batch: UpdateBatch) -> UpdateReport:
        with self._writer_lock:
            # Deprioritize the whole writer pass *dynamically*: the ratio
            # flips from 0 to 2.0 the moment a concurrent reader bumps the
            # read clock, making migration/refit/prewarm hot loops yield —
            # an idle engine (batch ingest, the refit-vs-rebuild bench)
            # never sleeps because the clock never moves mid-update.
            read_mark = self._read_clock
            slept_before = build_slept_s()
            with build_throttle(
                lambda: 2.0 if self._read_clock != read_mark else 0.0
            ):
                report = self._apply_updates_locked(batch)
            # writer-throttle duty cycle: fraction of the update's wall
            # time spent in deprioritization sleeps (0 on an idle engine)
            slept = build_slept_s() - slept_before
            if report.t_update_s > 0.0:
                self.metrics.gauge("mvcc.writer_throttle_duty").set(
                    slept / report.t_update_s
                )
            return report

    def _apply_updates_locked(self, batch: UpdateBatch) -> UpdateReport:
        old = self._snap
        batch.validate(len(old.facilities), len(old.users))
        with span("update", version=old.version + 1) as su:
            return self._apply_updates_span(batch, old, su)

    def _apply_updates_span(
        self, batch: UpdateBatch, old: EngineSnapshot, su
    ) -> UpdateReport:
        read_mark = self._read_clock  # readers seen since here => contended

        old_f, old_u = old.facilities, old.users
        old_rect = None if old.explicit_rect else old.rect
        old_fp = old.fingerprint()
        old_grid = adaptive_grid(len(old_f))  # pruning resolution regime

        new_f, map_f = apply_to_points(
            old_f, batch.facility_insert, batch.facility_delete, batch.facility_move
        )
        new_u, map_u = apply_to_points(
            old_u, batch.user_insert, batch.user_delete, batch.user_move
        )
        changed_pos = changed_positions(batch, old_f)

        # ---- build version N+1 off to the side ------------------------
        new = self._make_snapshot(
            old.version + 1,
            new_f,
            new_u,
            rect=old._rect if old.explicit_rect else None,
            explicit_rect=old.explicit_rect,
            scene_cache=None,  # installed below (migrated COW)
        )
        rect_changed = (not old.explicit_rect) and new.rect != old_rect
        if not batch.touches_facilities:
            new._fp = old._fp  # same facility content → same fingerprint

        report = UpdateReport(
            version=new.version, t_update_s=0.0, rect_changed=rect_changed
        )

        # ---- device-resident user coordinates -------------------------
        if batch.touches_users:
            self._cow_user_arrays(old, new, batch, report)
        else:
            # untouched users: carry device tensors by reference
            new._ys = old._ys
            new._xs = old._xs
            # the order and bucketing memo is keyed on the identity of the
            # carried xs tensor — safe to share across versions
            new.kernel_memo = old.kernel_memo

        # ---- scene cache + index memo: survive / refit / rebuild ------
        prewarm: list[tuple] = []
        if old.scene_cache is not None:
            with span("migrate", version=new.version):
                new.scene_cache, prewarm = self._migrate_scene_cache(
                    old, new, batch, old_fp, rect_changed,
                    old_grid, map_f, changed_pos, report,
                )

        # ---- prepared-batch LRU + plan memos --------------------------
        self._cow_batch_cache(old, new, batch, rect_changed, report)

        # ---- writer-side prewarm: rebuild dropped standing scenes into
        # the unpublished snapshot so readers never pay the host rebuild
        if prewarm:
            with span("prewarm", version=new.version):
                self._prewarm_scenes(new, prewarm, report, read_mark)

        # ---- publish: one atomic reference swap -----------------------
        self._snap = new

        # ---- continuous queries (reconciled against the new version) --
        ctx = _UpdateContext(
            batch=batch,
            old_facilities=old_f,
            new_facilities=new_f,
            old_users=old_u,
            new_users=new_u,
            map_f=map_f,
            map_u=map_u,
            version=new.version,
        )
        # closed/dead handles are dropped here, not at close() time — the
        # handle list is only ever touched on the (serialized) update path
        n_before = len(self._continuous)
        self._continuous = [cq for cq in self._continuous if cq.alive]
        if n_before > len(self._continuous):
            self.metrics.counter("continuous.pruned").inc(
                n_before - len(self._continuous)
            )
        if self._continuous:
            with span("continuous", version=new.version):
                dirty = self._dirty_continuous(batch, changed_pos)
                for cq, is_dirty in zip(self._continuous, dirty):
                    before = (
                        cq.n_patched, cq.n_skipped, cq.n_events, cq.events_dropped,
                    )
                    if is_dirty:
                        cq._on_update(ctx)
                    else:
                        cq._on_update_clean(ctx, len(changed_pos) > 0)
                    report.continuous_patched += cq.n_patched - before[0]
                    report.continuous_skipped += cq.n_skipped - before[1]
                    report.continuous_events += cq.n_events - before[2]
                    if cq.events_dropped > before[3]:
                        self.metrics.counter("continuous.events_dropped").inc(
                            cq.events_dropped - before[3]
                        )

        report.t_update_s = su.elapsed_s
        self.update_stats.n_updates += 1
        self.update_stats.t_update_s += report.t_update_s
        self.update_stats.scenes_survived += report.scenes_survived
        self.update_stats.scenes_refit += report.scenes_refit
        self.update_stats.scenes_dropped += report.scenes_dropped
        self.update_stats.scenes_prewarmed += report.scenes_prewarmed
        self.update_stats.indexes_refit += report.indexes_refit
        self.update_stats.indexes_rebuilt += report.indexes_rebuilt
        self.update_stats.batches_carried += report.batches_carried
        self._update_log.append(report)
        if len(self._update_log) > 128:
            del self._update_log[0]
        return report

    # ------------------------------------------------------------------
    def _dirty_continuous(self, batch: UpdateBatch, changed_pos: np.ndarray):
        """``[H]`` bool: which live handles this delta could actually touch.

        One vectorized influence-zone test across all standing queries
        (:func:`repro_torch.dynamic.continuous.influence_dirty_mask`) replaces
        the per-handle Python loop; only handles marked dirty fall into
        the exact per-handle patch.  User-side deltas dirty every handle
        (rows/thresholds must be reconciled), and a handle whose own
        facility moved or died is always exact-patched (its influence
        geometry itself changes, which the distance test cannot certify).
        """
        n = len(self._continuous)
        if batch.touches_users:
            return np.ones(n, bool)
        dirty = influence_dirty_mask(self._continuous, changed_pos)
        own = np.concatenate([batch.facility_delete, batch.facility_move[0]])
        if len(own):
            q_idx = np.array(
                [-1 if cq.q_idx is None else cq.q_idx for cq in self._continuous]
            )
            dirty |= np.isin(q_idx, own)
        return dirty

    # ------------------------------------------------------------------
    def _cow_user_arrays(
        self,
        old: EngineSnapshot,
        new: EngineSnapshot,
        batch: UpdateBatch,
        report: UpdateReport,
    ) -> None:
        """Out-of-place scatter into the new snapshot's device tensors for
        pure moves (version N's tensors stay untouched — readers of the
        old snapshot keep serving them); re-upload (lazily) on any shape
        change.

        The moved points are cast to float32 on the host, as the
        snapshot's upload casts them, so the scattered tensors equal a
        cold upload of the new users bit for bit; the scatter itself runs
        on the engine's device with no copy of the users back to the host.
        """
        mv_ids, mv_pts = batch.user_move
        moves_only = (
            len(mv_ids) > 0
            and not len(batch.user_insert)
            and not len(batch.user_delete)
        )
        if moves_only:
            if old._xs is not None:
                dev = old._xs.device
                idx = torch.from_numpy(np.ascontiguousarray(mv_ids)).to(dev)
                pts = np.asarray(mv_pts, np.float32)
                # ys before xs: a racing reader keyed on _xs sees both
                new._ys = old._ys.index_copy(
                    0, idx, torch.from_numpy(np.ascontiguousarray(pts[:, 1])).to(dev)
                )
                new._xs = old._xs.index_copy(
                    0, idx, torch.from_numpy(np.ascontiguousarray(pts[:, 0])).to(dev)
                )
                report.users_scattered = True
                self.update_stats.user_scatters += 1
        else:
            self.update_stats.user_reuploads += 1  # lazy re-upload on next use

    # ------------------------------------------------------------------
    def _cow_batch_cache(
        self,
        old: EngineSnapshot,
        new: EngineSnapshot,
        batch: UpdateBatch,
        rect_changed: bool,
        report: UpdateReport,
    ) -> None:
        """Carry prepared batches into the new snapshot for user-only
        deltas (moves, inserts, and hull-stable deletes alike).

        The prepared state of the dense, grid and bvh backends is a pure
        function of the scenes (which a user-only delta cannot touch), so
        the expensive stacking survives verbatim — only the request's
        user-side references are re-pointed at the new snapshot's device
        tensors: the scattered ones for a pure move, the re-uploaded
        (grown or shrunk) ones for an insert/delete, and the new
        snapshot's kernel memo, where the users' order is rebuilt for the
        new tensors.  The count dispatch sizes its ``[Q, N]`` output from
        those tensors at call time, so a changed |U| flows through without
        touching the prepared stack.  Backends whose prepared state holds
        user coordinates (``prepared_carries_users`` — the grid-pallas
        cell buckets) are rebuilt lazily.  Facility deltas and rect
        changes (which an out-of-hull insert triggers) still start the new
        version cold: their scenes or keys are stale wholesale.
        """
        if batch.touches_facilities or rect_changed:
            return
        if not batch.touches_users:
            # nothing moved the users either: the whole LRU is still valid
            for key, value in old.batch_cache.items():
                new.batch_cache.put(key, value)
                report.batches_carried += 1
            return
        for key, value in old.batch_cache.items():
            if key[0] == "auto-plan":
                # assignment + scenes are user-count-independent; prices
                # shift negligibly under an incremental user delta
                new.batch_cache.put(key, value)
                report.batches_carried += 1
                continue
            b = get_backend(key[1] if key[0] == "auto" else key[0])
            if b.prepared_carries_users:
                continue
            req, prepared, scenes = value
            req = dataclasses.replace(
                req,
                xs=new.xs,
                ys=new.ys,
                users=new.users,
                memo=new.kernel_memo,
            )
            new.batch_cache.put(key, (req, prepared, scenes))
            report.batches_carried += 1

    # ------------------------------------------------------------------
    def _migrate_scene_cache(
        self,
        old: EngineSnapshot,
        new: EngineSnapshot,
        batch: UpdateBatch,
        old_fp: int,
        rect_changed: bool,
        old_grid: int,
        map_f: np.ndarray,
        changed_pos: np.ndarray,
        report: UpdateReport,
    ):
        """The new snapshot's scene cache (COW), with surviving / refit
        scenes' index stores adopted into ``new.index_memo``.

        Returns ``(cache, prewarm)`` where ``prewarm`` lists the
        ``(q, k)`` of dropped standing entries whose query still exists
        post-update — :meth:`_prewarm_scenes` rebuilds those into the
        unpublished snapshot so readers never pay the rebuild."""
        cache = old.scene_cache
        prewarm: list[tuple] = []
        # Prewarm only when facility identity is stable (no insert/delete,
        # i.e. map_f is the identity): churn remaps row indices, so a
        # rebuilt scene would sit under the remapped id while standing
        # index-addressed workloads keep asking for the raw one — all of
        # the eager work would miss (measured: flips fchurn from ~1x to
        # a 0.4x loss).  Same stability condition as the refit attempt.
        stable_ids = not len(batch.facility_insert) and not len(batch.facility_delete)

        def note_drop(q_key, k):
            if not stable_ids:
                return
            if isinstance(q_key, (int, np.integer)):
                new_q = int(map_f[int(q_key)])
                if new_q >= 0:  # the query facility still exists
                    prewarm.append((new_q, k))
            else:
                prewarm.append((np.asarray(q_key, np.float64), k))

        def drop_all(key, scene):
            if key[0] == old_fp and key[3] == old.rect:
                note_drop(key[1], key[2])
            return None

        if rect_changed:
            # every cached scene was clipped against the old domain; a cold
            # engine would build different geometry — start cold
            new_cache, _, dropped = cache.cow_migrate(lambda key: True, drop_all)
            report.scenes_dropped += dropped
            return new_cache, prewarm
        if not batch.touches_facilities:
            # user-only delta with a stable hull: scenes depend on
            # (facilities, q, k, rect) alone — the cache is shared by
            # reference (it is append-only and internally locked) and
            # every index survives with its scene
            report.scenes_survived += len(cache)
            new.index_memo = old.index_memo.clone()
            return cache, prewarm
        # adaptive pruning-grid regime flip: a cold re-prune would run at a
        # different resolution — nothing survives
        if self.config.prune_grid is None and adaptive_grid(len(new.facilities)) != old_grid:
            new_cache, _, dropped = cache.cow_migrate(lambda key: True, drop_all)
            report.scenes_dropped += dropped
            return new_cache, prewarm

        new_fp = new.fingerprint()
        moved_ids_old = batch.facility_move[0]
        moved_new = map_f[moved_ids_old] if len(moved_ids_old) else np.zeros(0, np.int64)
        grid_param = self.config.prune_grid
        # Refit is only attempted for pure-move deltas: an insert/delete
        # that pierced a scene's certificate almost always changes its kept
        # set, so the attempt's re-prune (the expensive part) is a near-
        # certain write-off — measured to flip the churn regime from a win
        # to a 0.6x loss when attempted indiscriminately.
        moves_only = stable_ids

        def migrate(key, scene):
            _fp, q_key, k, rect = key
            if rect != new.rect:
                return None  # transient-rect entry (out-of-hull point query)
            if isinstance(q_key, (int, np.integer)):
                new_q = int(map_f[int(q_key)])
                if new_q < 0:
                    return None  # the query facility itself is gone
                if len(moved_ids_old) and np.any(moved_ids_old == q_key):
                    note_drop(q_key, k)  # still standing, at a new position
                    return None
                q_build: int | np.ndarray = new_q
                new_q_key: int | tuple = new_q
            else:
                q_build = np.asarray(q_key, np.float64)
                new_q_key = q_key
            if scene_update_safe(scene, changed_pos):
                report.scenes_survived += 1
                new_scene = remap_scene(scene, map_f, len(new.facilities))
                store = old.index_memo.peek(scene)
                if store is not None:  # indexes ride the surviving geometry
                    new.index_memo.adopt(new_scene, dict(store))
                return (new_fp, new_q_key, k, rect), new_scene
            # pierced certificate: priced eager-refit vs lazy-rebuild
            if not moves_only:
                note_drop(q_key, k)
                return None
            n = scene.n_tris
            owner_new = map_f[scene.owner[:n][scene.owner[:n] >= 0]]
            n_changed = (
                int(np.isin(owner_new, moved_new).sum()) if len(moved_new) else 0
            )
            shape = WorkloadShape(
                len(new.facilities), len(new.users), k, 1, m_tris=max(n, 1)
            )
            decision = self.refit_policy.price(shape, n_changed, n)
            if decision.action != "refit":
                note_drop(q_key, k)
                return None
            sr = span("refit", version=new.version)
            sr.__enter__()
            try:
                out = refit_scene(
                    scene,
                    map_f,
                    new.facilities,
                    q_build,
                    k,
                    rect,
                    moved_new,
                    strategy=self.config.strategy,
                    grid=grid_param,
                )
                if out is None:
                    # a bailed refit attempt is neither a refit nor a rebuild
                    # observation — feeding its (small) cost into either EMA
                    # would skew the frontier
                    note_drop(q_key, k)
                    return None
                new_scene, changed_tris = out
                store = old.index_memo.peek(scene)
                if store:
                    new_store = {}
                    refitted: dict[int, tuple] = {}  # grid/grid-pallas share one build
                    for (bname, g), index in store.items():
                        if index is None:  # index-less backend (dense paths)
                            new_store[(bname, g)] = None
                            continue
                        hit = refitted.get(id(index))
                        if hit is None:
                            hit = get_backend(bname).refit_index(
                                index, scene, new_scene, changed_tris, grid_g=g
                            )
                            refitted[id(index)] = hit
                            if hit[1]:
                                report.indexes_refit += 1
                            else:
                                report.indexes_rebuilt += 1
                        new_store[(bname, g)] = hit[0]
                    new.index_memo.adopt(new_scene, new_store)
            finally:
                sr.__exit__(None, None, None)
            self.refit_policy.observe("refit", sr.elapsed_s)
            report.scenes_refit += 1
            return (new_fp, new_q_key, k, rect), new_scene

        new_cache, _, dropped = cache.cow_migrate(
            lambda key: key[0] == old_fp, migrate
        )
        report.scenes_dropped += dropped
        return new_cache, prewarm

    def _prewarm_scenes(
        self,
        new: EngineSnapshot,
        pending: list[tuple],
        report: UpdateReport,
        read_mark: int,
    ) -> None:
        """Writer-side prewarm (the writer pays, readers never do).

        Standing scenes the migration dropped are rebuilt into the NEXT
        snapshot before it publishes — concurrent readers keep serving
        the current version meanwhile, and the first queries on the new
        version find warm scenes (and, for the engine's configured
        concrete backend, warm indexes) instead of stalling on the host
        rebuild.  Bounded by :data:`PREWARM_SCENES_CAP`.

        Prewarm is background maintenance, so under *contention* it runs
        deprioritized: the writer-wide dynamic :func:`~repro_torch.core.grid.
        build_throttle` makes the classify/prune hot loops yield the GIL
        ~2x their own CPU time, and each rebuilt scene is additionally
        followed by a half-length sleep.  On a contended core that keeps
        concurrent readers at well over half the CPU — the publish just
        lands a little later, which MVCC makes harmless.  Contention is
        detected from the lock-free read clock (queries bump
        ``_read_clock``; the writer samples it per scene): an idle engine
        — the refit-vs-rebuild benchmark, batch ingest jobs — prewarms
        at full speed instead of sleeping for absent readers.
        """
        backend = get_backend(self.config.backend)
        warm_index = backend.uses_scene and not backend.is_meta
        for q_build, k in pending[:PREWARM_SCENES_CAP]:
            contended = self._read_clock != read_mark
            read_mark = self._read_clock
            with span("prewarm-scene", k=k) as sp:
                scene = self._build_scene(new, q_build, k, new.rect)
                if warm_index:
                    self._index_for(new, backend, scene)
            report.scenes_prewarmed += 1
            if contended:
                # coarse backstop for the build work outside the yielding
                # hot loops (COW copies, occluder geometry, list packing)
                build_sleep(0.5 * sp.elapsed_s)


@dataclasses.dataclass
class _UpdateContext:
    """Everything a continuous query needs to reconcile one update."""

    batch: UpdateBatch
    old_facilities: np.ndarray
    new_facilities: np.ndarray
    old_users: np.ndarray
    new_users: np.ndarray
    map_f: np.ndarray
    map_u: np.ndarray
    version: int
