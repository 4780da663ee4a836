"""User-axis sharded serving: :class:`ShardedEngine` (``repro.shard.engine``).

The paper's scaling axis is the *user* population — RT-RkNN casts one
ray per user, so users are where the parallel work lives, while
facilities (and the per-query occluder scenes built from them) are tiny.
The sharded engine encodes that asymmetry directly:

* **replicated** per shard: facilities, scenes, grid/BVH indexes, packed
  per-cell coefficient planes — all host-built once and shared;
* **sharded** over the ``'users'`` mesh axis: the user coordinate
  tensors, the per-shard cell buckets feeding the grid kernel, and the
  per-shard hit-count slabs.

The partition is *spatial*: users are sorted by grid cell (the same
cell id the bucketed kernels use) and cut into ``shards`` contiguous
runs (:func:`repro_torch.distributed.sharding.user_shard_bounds`), so each
shard covers a compact region of the domain.  A ``grid-pallas`` shard
ships only the coefficient planes of the cells **its** users occupy.

Counts are per-user independent, so the per-shard slabs scatter back
through the partition permutation bit-identically to the single-process
engine (:mod:`repro_torch.shard.reduce`).  The scatter runs on the card,
into one int32 tensor on the first shard's device, which is copied back
once; per-query result sizes cross shards as ``[Q]`` partials through
the ``psum``-style tree reduction on the host.

MVCC integration: the per-shard replicas live on the
:class:`~repro_torch.core.snapshot.EngineSnapshot` (``snap.shard_state``)
as ONE immutable :class:`ShardState` swapped atomically — every view in a
state carries the snapshot's version, so a batch resolved against one
snapshot can never mix shard views from two versions (the version-
lockstep rule).  ``DynamicEngine`` user moves scatter out of place into
the owning shard's tensors; facility-only deltas re-stamp the state;
inserts and deletes rebuild the partition lazily.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core.backends import Backend, BatchRequest, on_device
from repro_torch.core.engine import RkNNConfig
from repro_torch.core.geometry import Rect
from repro_torch.core.snapshot import EngineSnapshot, LruCache
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import user_shard_bounds
from repro_torch.dynamic.engine import DynamicEngine, scatter_rows
from repro_torch.obs import span
from repro_torch.shard.mesh import mesh_shards, shard_devices
from repro_torch.shard.reduce import tree_psum

__all__ = ["ShardedEngine", "ShardState", "ShardView", "ShardDispatch"]

#: Backend-name groups routed to each per-shard dispatch flavor.  The
#: grid-pallas family gets per-shard bucketing + compaction; the others
#: share one replicated prepared state and count each shard's users.
#: ``brute`` is not shardable: it goes through the single-device dispatch.
_GP_BACKENDS = frozenset({"grid-pallas", "grid-pallas-ref"})
_SHARDABLE = _GP_BACKENDS | frozenset({"dense", "dense-ref", "grid", "bvh"})


def _sync(device: torch.device) -> None:
    """Wait for ``device`` (a card) so a span around launches times the
    work and not its enqueue; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ShardView:
    """One shard's replica view of one snapshot version.

    Owns the shard's users: ``xs``/``ys`` float32 tensors on ``device``,
    ``users`` their host float64 rows (what the grid backends bucket) and
    ``rows`` their rows in the original user order (an int64 tensor on the
    reassembly device), plus a private kernel memo for the shard's user
    order and cell bucketing — private so S shards cannot thrash the
    snapshot's small shared :class:`~repro_torch.core.snapshot.LruCache`.
    """

    __slots__ = ("index", "device", "version", "lo", "hi", "xs", "ys", "memo",
                 "users", "rows")

    def __init__(self, index, device, version, lo, hi, xs, ys, memo=None, *,
                 users=None, rows=None):
        self.index = int(index)
        self.device = device
        self.version = int(version)
        self.lo = int(lo)
        self.hi = int(hi)
        self.xs = xs
        self.ys = ys
        self.memo = memo if memo is not None else LruCache(4)
        self.users = users
        self.rows = rows

    @property
    def n_users(self) -> int:
        return self.hi - self.lo


class ShardState:
    """The full shard partition of one snapshot version — swapped as ONE
    object (``snap.shard_state = state``), never mutated in place, so a
    reader resolves either all of version N's views or all of N+1's."""

    __slots__ = ("version", "n_shards", "perm", "pos", "bounds", "views", "n_users")

    def __init__(self, version, n_shards, perm, pos, bounds, views):
        self.version = int(version)
        self.n_shards = int(n_shards)
        self.perm = perm  # [N] spatial sort of user rows
        self.pos = pos  # [N] inverse: original row -> position in perm
        self.bounds = bounds  # [S+1] cut points into perm
        self.views = views  # tuple[ShardView], len S
        self.n_users = int(len(perm))

    def restamp(self, version: int) -> "ShardState":
        """The same partition re-stamped for a new snapshot version
        (facility-only deltas: user tensors carried by reference)."""
        views = tuple(
            ShardView(v.index, v.device, version, v.lo, v.hi, v.xs, v.ys, v.memo,
                      users=v.users, rows=v.rows)
            for v in self.views
        )
        return ShardState(
            version, self.n_shards, self.perm, self.pos, self.bounds, views
        )

    def summary(self) -> dict:
        """JSON-able description of the partition for introspection:
        per-shard row ranges, devices, and user counts (plus the imbalance
        ratio).  Pure reads of immutable fields — safe against concurrent
        publication."""
        counts = [v.n_users for v in self.views]
        mean = (sum(counts) / len(counts)) if counts else 0.0
        return dict(
            version=self.version,
            n_shards=self.n_shards,
            n_users=self.n_users,
            imbalance=(max(counts) / mean) if mean else 1.0,
            shards=[
                dict(
                    index=v.index,
                    device=str(v.device),
                    lo=v.lo,
                    hi=v.hi,
                    n_users=v.n_users,
                )
                for v in self.views
            ],
        )


def _spatial_perm(users: np.ndarray, rect: Rect, grid_g: int) -> np.ndarray:
    """Stable sort of user rows by grid cell id — the same ``cx*G + cy``
    the bucketed kernels use, so each contiguous cut covers a compact
    cell range."""
    xs = users[:, 0].astype(np.float32)
    ys = users[:, 1].astype(np.float32)
    g = max(int(grid_g), 1)
    w = rect.width / g
    h = rect.height / g
    cx = np.clip(np.floor((xs - rect.xmin) / w), 0, g - 1).astype(np.int64)
    cy = np.clip(np.floor((ys - rect.ymin) / h), 0, g - 1).astype(np.int64)
    return np.argsort(cx * g + cy, kind="stable")


def _view(s, dev, version, lo, hi, users_s, rows) -> ShardView:
    """A fresh view of the rows ``users_s`` (host float64) on ``dev``."""
    return ShardView(
        s, dev, version, lo, hi,
        torch.from_numpy(np.ascontiguousarray(users_s[:, 0], np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(users_s[:, 1], np.float32)).to(dev),
        users=users_s, rows=rows,
    )


class ShardDispatch:
    """The per-batch sharded verify dispatch, injected as
    ``BatchRequest.dispatch``.

    The engine's filter phase calls :meth:`prepare` (via
    ``RkNNEngine._prepare_batch``) instead of the backend's own
    ``prepare_batch`` and the backend's ``count_batch`` calls the
    instance itself — so every batched path (fixed-backend batches,
    planner groups, ``stream()``) shards without knowing it.
    """

    def __init__(self, engine: "ShardedEngine", state: ShardState,
                 backend: Backend, rect: Rect, k: int):
        self.engine = engine
        self.state = state
        self.backend = backend
        self.rect = rect
        self.k = int(k)

    def _request(self, view: ShardView, req: BatchRequest | None = None) -> BatchRequest:
        """The batch request of one shard: its users, device and memo."""
        if req is None:
            return BatchRequest(
                xs=view.xs, ys=view.ys, k=self.k, device=view.device, rect=self.rect,
                grid_g=self.engine.config.grid_g, memo=view.memo,
            )
        return BatchRequest(
            xs=view.xs, ys=view.ys, k=req.k, device=view.device, rect=req.rect,
            grid_g=req.grid_g, scenes=req.scenes, indexes=req.indexes,
            users=view.users, mp=req.mp, memo=view.memo,
        )

    # ---- filter phase: per-shard (or replicated) prepared state --------
    def prepare(self, backend: Backend, req: BatchRequest):
        name = backend.name
        state = self.state
        n = state.n_users
        if name in _GP_BACKENDS:
            per_shard = []
            t_filter = [0.0] * state.n_shards
            for view in state.views:
                if view.n_users == 0:
                    per_shard.append(None)
                    continue
                with span("shard-filter", shard=view.index, backend=name) as sf:
                    # the shard's own buckets (its memo, its host rows), the
                    # planes compacted to the cells ITS users occupy
                    prepared = backend.prepare_batch(self._request(view, req))
                    per_shard.append((prepared, *self._dest(view, prepared[0], n)))
                t_filter[view.index] = sf.elapsed_s
            self.engine._note_shard_filter(t_filter)
            return ("shard", per_shard)
        # dense / grid / bvh: prepared state is a pure function of the
        # replicated scenes — build it once, count each shard's users at
        # dispatch time
        with span("shard-filter", shard=-1, backend=name, shared=1) as sf:
            shared = backend.prepare_batch(req)
        self.engine._note_shard_filter([sf.elapsed_s / state.n_shards] * state.n_shards)
        return ("shared", shared)

    @staticmethod
    def _dest(view: ShardView, buckets, n: int):
        """``(dest, ok)`` for the kernel's sorted lanes of one shard: each
        lane's column in the ``[Q, N + 1]`` reassembly (the shard's unsort
        composed with its rows; padding lanes land in the trash column
        ``N``) and whether it is a real user.  Memoized with the buckets."""
        key = ("shard-dest", id(buckets.unsort))
        hit = view.memo.get(key)
        if hit is not None and hit[0] is buckets.unsort:
            return hit[1]
        dev = view.rows.device
        dest = torch.full((buckets.xs_s.shape[0],), n, dtype=torch.int64, device=dev)
        dest.index_copy_(0, buckets.unsort.to(dev), view.rows)
        value = (dest, dest < n)
        view.memo.put(key, (buckets.unsort, value))
        return value

    # ---- verify phase: one dispatch per shard + reassembly on the card ---
    def __call__(self, prepared) -> np.ndarray:
        kind, payload = prepared
        state = self.state
        backend = self.backend
        name = backend.name
        n = state.n_users
        out_dev = state.views[0].rows.device
        out = None
        t_verify = [0.0] * state.n_shards
        partials = []
        for i, view in enumerate(state.views):
            if view.n_users == 0:
                continue
            with span("shard-verify", shard=view.index, backend=name) as sv:
                if kind == "shard":
                    shard_prep, dest, ok = payload[i]
                    counts = backend.count_sorted(shard_prep)
                else:
                    counts = backend.count_batch_device(
                        self._request(view), on_device(payload, view.device)
                    )
                    dest, ok = view.rows, None
                _sync(view.device)
            t_verify[view.index] = sv.elapsed_s
            with span("shard-reassemble", shard=view.index, backend=name):
                if out is None:
                    # the trash column N takes the grid buckets' padding lanes
                    width = n + 1 if kind == "shard" else n
                    out = torch.empty((counts.shape[0], width), dtype=torch.int32,
                                      device=out_dev)
                counts = counts.to(out_dev)
                out.index_copy_(1, dest, counts)
                hit = counts < self.k
                partials.append((hit & ok if ok is not None else hit).sum(dim=1))
                _sync(out_dev)
        with span("shard-copy", backend=name, shards=state.n_shards):
            host = out[:, :n].cpu().numpy()
            parts = torch.stack(partials).cpu().numpy().astype(np.int64)
        sizes = tree_psum(list(parts))
        self.engine._note_shard_verify(
            t_verify,
            backend=name,
            version=state.version,
            per_shard_users=[v.n_users for v in state.views],
            sizes=sizes,
        )
        return host


class ShardedEngine(DynamicEngine):
    """A :class:`~repro_torch.dynamic.engine.DynamicEngine` whose verify
    phase is partitioned over a user-axis device mesh.

    Construction adds the mesh knobs; every query/update surface is
    inherited.  ``shards`` cycles the visible cards when the host has
    fewer (the partition and compaction are preserved; only physical
    parallelism collapses), or pass ``mesh=user_mesh(n)`` for a strict
    one-device-per-shard layout.  ``device`` is the engine's
    (``None``: ``"cuda"``, raising without a card; ``"cpu"`` places every
    shard on the host).  Masks and counts are bit-identical to the
    single-process engine for every concrete backend.
    """

    def __init__(
        self,
        facilities,
        users,
        config: RkNNConfig | None = None,
        *,
        shards: int | None = None,
        mesh=None,
        devices=None,
        rect: Rect | None = None,
        device=None,
        **overrides,
    ):
        if mesh is not None:
            n = mesh_shards(mesh)
            if shards is not None and int(shards) != n:
                raise ValueError(
                    f"shards={shards} disagrees with the mesh's users axis ({n})"
                )
            shards = n
            devices = shard_devices(n, mesh)
        if shards is None:
            if devices is not None:
                shards = len(devices)
            elif resolve_device(device).type == "cpu":
                shards = 1
            else:
                shards = torch.cuda.device_count()
        self.n_shards = max(int(shards), 1)
        self.shard_mesh = mesh
        self._shard_devices = (
            list(devices) if devices is not None
            else shard_devices(self.n_shards, device=device)
        )
        if len(self._shard_devices) != self.n_shards:
            raise ValueError(
                f"{self.n_shards} shards need {self.n_shards} devices, "
                f"got {len(self._shard_devices)}"
            )
        self._shard_log: "collections.deque[dict]" = collections.deque(maxlen=128)
        # the base engine's `mesh=` (row slabs) is deliberately NOT
        # forwarded; the users mesh is this class's own
        super().__init__(facilities, users, config, rect=rect, device=device, **overrides)
        self.metrics.gauge("shard.imbalance").set(1.0)

    # ------------------------------------------------------------------
    # the shard partition (lazy per snapshot; one atomic install)
    # ------------------------------------------------------------------
    def _workload_shards(self) -> int:
        return self.n_shards

    def _shard_state_for(self, snap: EngineSnapshot) -> ShardState:
        st = snap.shard_state
        if (
            st is not None
            and st.version == snap.version
            and st.n_shards == self.n_shards
        ):
            return st
        n = len(snap.users)
        perm = _spatial_perm(snap.users, snap.rect, self.config.grid_g)
        pos = np.empty(n, np.int64)
        pos[perm] = np.arange(n)
        return self._install_shard_state(snap, perm, pos, user_shard_bounds(n, self.n_shards))

    def _install_shard_state(self, snap: EngineSnapshot, perm, pos, bounds) -> ShardState:
        """Build the views of the partition ``(perm, pos, bounds)`` of
        ``snap``'s users, each on its shard's device, and install them as
        ``snap.shard_state`` in one assignment."""
        users = snap.users
        rows = torch.from_numpy(perm).to(self._shard_devices[0])
        views = []
        for s in range(self.n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            views.append(_view(s, self._shard_devices[s], snap.version, lo, hi,
                               users[perm[lo:hi]], rows[lo:hi]))
        st = ShardState(snap.version, self.n_shards, perm, pos, bounds, tuple(views))
        # benign first-touch race: two racing builders produce equal
        # states; one atomic assignment wins (never a mixed-version set)
        snap.shard_state = st
        return st

    # ------------------------------------------------------------------
    # persistence hooks (repro_torch.persist: the ``shards`` category)
    # ------------------------------------------------------------------
    def _persist_extra_fingerprints(self, snap: EngineSnapshot) -> dict:
        from repro_torch.persist.store import _rect_parts, content_digest

        return {
            "shards": content_digest(
                "shards",
                snap.users,
                _rect_parts(snap.rect),
                int(self.config.grid_g),
                int(self.n_shards),
            )
        }

    def _persist_extra_categories(self, snap: EngineSnapshot) -> dict:
        st = self._shard_state_for(snap)
        return {
            "shards": {
                "meta": {"n_shards": int(st.n_shards)},
                "arrays": {"perm": st.perm, "pos": st.pos, "bounds": st.bounds},
            }
        }

    def _persist_adopt_extra(self, snap: EngineSnapshot, name: str, entry, arrays):
        """The ``shards`` category: the partition comes from the store; each
        view's tensors are re-placed on its shard's device from the host
        float32 cast the snapshot uses (device placement is host state,
        not store state).  The per-view memos (the users' order, the cell
        buckets, the composed scatter index) rebuild at first use."""
        if name != "shards":
            return None
        self._install_shard_state(
            snap,
            np.ascontiguousarray(arrays["perm"], np.int64),
            np.ascontiguousarray(arrays["pos"], np.int64),
            np.ascontiguousarray(arrays["bounds"], np.int64),
        )
        return self.n_shards

    # ------------------------------------------------------------------
    # the dispatch injection point (covers batches, groups, stream)
    # ------------------------------------------------------------------
    def _mesh_dispatch_for(
        self, snap: EngineSnapshot, backend: Backend, *, rect: Rect, k: int
    ):
        if backend.name not in _SHARDABLE:
            return super()._mesh_dispatch_for(snap, backend, rect=rect, k=k)
        state = self._shard_state_for(snap)
        if state.n_users == 0:
            return None  # nothing to partition; single dispatch is exact
        return ShardDispatch(self, state, backend, rect, k)

    # ------------------------------------------------------------------
    # per-shard stats (metrics registry views; EngineStats + explain())
    # ------------------------------------------------------------------
    def _shard_hist(self, phase: str, i: int):
        key = ("shard", phase, i)
        h = self._metric_cache.get(key)
        if h is None:
            h = self._metric_cache[key] = self.metrics.histogram(
                "shard.phase_s", phase=phase, shard=i
            )
        return h

    def _note_shard_filter(self, times: list[float]) -> None:
        # every shard observes (zeros included) so the per-shard view
        # lists always span all n_shards entries
        for i, t in enumerate(times):
            self._shard_hist("filter", i).observe(t)

    def _note_shard_verify(
        self, times, *, backend, version, per_shard_users, sizes
    ) -> None:
        tot = [0.0] * self.n_shards
        for i, t in enumerate(times):
            self._shard_hist("verify", i).observe(t)
        for labels, h in self.metrics.find("shard.phase_s"):
            if labels.get("phase") == "verify":
                i = int(labels["shard"])
                if 0 <= i < self.n_shards:
                    tot[i] += h.sum
        mean = sum(tot) / max(len(tot), 1)
        imbalance = (max(tot) / mean) if mean > 0 else 1.0
        self.metrics.gauge("shard.imbalance").set(imbalance)
        self._shard_log.append(
            {
                "mode": "shard-batch",
                "backend": backend,
                "version": version,
                "shards": self.n_shards,
                "per_shard_users": list(per_shard_users),
                "per_shard_verify_s": [float(t) for t in times],
                "imbalance": imbalance,
                "result_sizes": [int(x) for x in np.asarray(sizes)],
            }
        )

    def explain(self) -> list[dict]:
        """Planner plans (inherited) followed by the per-batch shard
        records: per-shard user counts and verify timings, the running
        imbalance ratio, and the ``psum``-reduced result sizes."""
        return super().explain() + list(self._shard_log)

    # ------------------------------------------------------------------
    # copy-on-write update integration (scatter along the same axis)
    # ------------------------------------------------------------------
    def _cow_user_arrays(self, old, new, batch, report) -> None:
        super()._cow_user_arrays(old, new, batch, report)
        st = old.shard_state
        if st is None or st.n_shards != self.n_shards:
            return
        mv_ids, mv_pts = batch.user_move
        moves_only = (
            len(mv_ids) > 0
            and not len(batch.user_insert)
            and not len(batch.user_delete)
        )
        if not moves_only:
            return  # |U| changed: the partition itself is stale — rebuild lazily
        # out-of-place scatter into the owning shards (old views untouched);
        # moved users keep their shard until the next rebuild — spatial
        # purity degrades, correctness never does (any partition is a
        # valid partition)
        pos = st.pos[np.asarray(mv_ids, np.int64)]
        shard_of = np.searchsorted(st.bounds, pos, side="right") - 1
        views = []
        for s, view in enumerate(st.views):
            sel = shard_of == s
            if sel.any():
                xs, ys = scatter_rows(view.xs, view.ys, pos[sel] - int(st.bounds[s]),
                                      mv_pts[sel])
                views.append(ShardView(
                    s, view.device, new.version, view.lo, view.hi, xs, ys,
                    users=new.users[st.perm[view.lo:view.hi]], rows=view.rows,
                ))
            else:
                views.append(ShardView(
                    s, view.device, new.version, view.lo, view.hi, view.xs, view.ys,
                    view.memo, users=view.users, rows=view.rows,
                ))
        new.shard_state = ShardState(
            new.version, st.n_shards, st.perm, st.pos, st.bounds, tuple(views)
        )

    def _apply_updates_locked(self, batch):
        old = self._snap
        report = super()._apply_updates_locked(batch)
        new = self._snap
        st = old.shard_state
        if (
            new.shard_state is None
            and st is not None
            and st.n_shards == self.n_shards
            and not batch.touches_users
        ):
            # facility-only delta: the user partition is untouched — carry
            # every shard's tensors by reference, re-stamped to the new
            # version in one atomic install (lockstep preserved)
            new.shard_state = st.restamp(new.version)
        return report
