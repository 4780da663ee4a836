"""Pluggable verification backends behind one registry (``repro.core.backends``).

A backend is ONE class implementing

* :meth:`Backend.build_index`    — host-side index build (filter phase),
* :meth:`Backend.count`          — single-query device count (verify phase),
* :meth:`Backend.prepare_batch`  — host-side batch stacking (filter phase),
* :meth:`Backend.count_batch`    — one batched device dispatch (verify phase),

registered with :func:`register_backend` and resolved with
:func:`get_backend`.  The split between ``prepare_batch`` and
``count_batch`` keeps the paper's two-stage timing honest: host work
lands in ``t_filter_s``, the device dispatch (and the copy of its counts
back to the host, which waits for it) in ``t_verify_s``.

Built-in backends (all produce identical verdict sets):

* ``"dense"``     — the hand-written CUDA ray-cast kernel
                    (``repro_torch/csrc/raycast.cu``) over the padded scene,
                    on users in a spatial order kept per snapshot.
* ``"dense-ref"`` — the plain PyTorch version of the same count.
* ``"grid"``      — uniform-grid culled counting over the grid index
                    (:mod:`repro_torch.core.grid`), plain PyTorch as the
                    JAX package's jnp version.
* ``"grid-pallas"`` — cell-bucketed grid counting through the hand-written
                    CUDA kernel (``repro_torch/csrc/grid_raycast.cu``); the
                    name is the JAX package's, so configurations carry over.
* ``"grid-pallas-ref"`` — the plain PyTorch version of the same bucketed
                    count.
* ``"bvh"``       — the paper-faithful LBVH traversal with early exit at
                    ``k`` (:mod:`repro_torch.core.bvh`), through the
                    hand-written CUDA stack-walk kernel
                    (``repro_torch/csrc/bvh_traverse.cu``).
* ``"brute"``     — exact distance-rank counting (no geometry; baseline):
                    the rank-count kernel's query axis for a batch.
* ``"auto"``      — the query planner (:mod:`repro_torch.planner.backend`):
                    a *meta* backend (``is_meta = True``) that cost-dispatches
                    every request to the predicted-cheapest concrete backend
                    under the active calibration profile; on a CUDA device it
                    never routes to a plain twin (``plain_twin_of`` set:
                    ``dense-ref``, ``grid-pallas-ref``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.core.bvh import BVH, build_bvh, refit_bvh, stack_bvhs
from repro_torch.core.geometry import Rect
from repro_torch.core.grid import (
    OccluderGrid,
    build_grid,
    grid_hit_counts_batch_torch,
    grid_hit_counts_torch,
    refit_grid,
    stack_grids,
)
from repro_torch.core.scene import Scene, _next_pad, pad_scene_arrays
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.grid_raycast import (
    block_boxes,
    cell_list_lengths,
    order_cell_runs,
    pack_cell_coeff_planes,
    prepare_cell_buckets,
    repack_cell_coeff_planes,
    unsort_cell_counts,
    unsort_index,
)
from repro_torch.kernels.bvh import BvhBatch, bvh_batch
from repro_torch.kernels.user_order import UserOrder, build_user_order

__all__ = [
    "Backend",
    "QueryRequest",
    "BatchRequest",
    "register_backend",
    "get_backend",
    "available_backends",
    "concrete_backends",
    "timeable_backends",
    "stack_cell_planes",
    "CellBuckets",
    "DenseBackend",
    "DenseRefBackend",
    "GridBackend",
    "GridPallasBackend",
    "GridPallasRefBackend",
    "BvhBatch",
    "BvhBackend",
    "BruteBackend",
    "PlannerBackend",
]


@dataclasses.dataclass
class QueryRequest:
    """Everything a backend may need for one single-query count.

    Geometric backends read ``xs/ys`` + ``scene`` (+ ``index``); the
    geometry-free brute backend reads ``facilities/q_pt/exclude`` and the
    device users ``xs/ys`` (or, without them, ``users``, put on
    ``device``).  The grid-pallas backends bucket the host
    copy of the users (``users``), never the device tensors.
    """

    xs: torch.Tensor | None  # [N] f32 user x on the engine's device
    ys: torch.Tensor | None  # [N] f32 user y
    k: int
    device: torch.device
    grid_g: int = 64
    scene: Scene | None = None
    index: Any = None
    users: np.ndarray | None = None  # [N, 2] f64
    facilities: np.ndarray | None = None  # [M, 2] f64
    q_pt: np.ndarray | None = None  # [2]
    exclude: int | None = None
    #: Optional per-snapshot kernel memo (an ``LruCache``): the engine
    #: injects its snapshot's store so per-user-set state (the grid-pallas
    #: cell bucketing, the user order the dense and rank-count kernels
    #: read) is cached per snapshot, not on the backend singleton.
    #: ``None`` (raw protocol use) builds that state afresh.
    memo: Any = None


@dataclasses.dataclass
class BatchRequest:
    """One batched multi-query count over a shared user set.

    ``mp`` is the static triangle pad target for stacked dense scenes
    (power-of-two bucketed by the engine so repeat workloads reuse one
    stacked shape).
    """

    xs: torch.Tensor | None  # [N] f32
    ys: torch.Tensor | None  # [N] f32
    k: int
    device: torch.device
    rect: Rect | None = None
    grid_g: int = 64
    scenes: list[Scene] | None = None
    indexes: list | None = None
    users: np.ndarray | None = None
    facilities: np.ndarray | None = None
    q_pts: np.ndarray | None = None  # [Q, 2]
    excludes: list[int | None] | None = None
    mp: int | None = None
    #: Per-snapshot kernel memo — see :attr:`QueryRequest.memo`.
    memo: Any = None


class Backend:
    """Protocol + default implementations for a verification backend."""

    name: ClassVar[str]
    #: False for geometry-free backends (no scene construction at all);
    #: the engine skips the whole filter phase for them.
    uses_scene: ClassVar[bool] = True
    #: True for planning backends that only *route* to concrete backends
    #: (the engine resolves them before filtering; they are excluded from
    #: the concrete-backend lists like ``repro_torch.core.rknn.BACKENDS``).
    is_meta: ClassVar[bool] = False
    #: On the plain PyTorch twin of a kernel backend (``dense-ref``,
    #: ``grid-pallas-ref``), the kernel backend's name: the twin is the
    #: correctness tool for that kernel.  On a CUDA device it is neither
    #: timed by calibration nor routed to by ``auto``; on the CPU the kernel
    #: backend runs this same plain version, so there the twin is the one
    #: timed (see :func:`timeable_backends`).
    plain_twin_of: ClassVar[str | None] = None
    #: True when :meth:`prepare_batch`'s returned object holds user
    #: *coordinates* (not just scene geometry).  The dynamic engine's
    #: copy-on-write batch-cache carry consults this: for a user-only
    #: delta, prepared state of backends where this is False stays valid
    #: (the users enter only at :meth:`count_batch`, through the request's
    #: ``xs``/``ys`` and the snapshot memo keyed on them) and is carried
    #: into the next snapshot; True drops it.
    prepared_carries_users: ClassVar[bool] = False

    # ---- filter phase (host) --------------------------------------------
    def build_index(self, scene: Scene, *, grid_g: int = 64, memo: dict | None = None):
        """Host-side per-scene index build (the grid); ``None`` if unused.

        ``memo`` is the engine snapshot's per-scene index store (a plain
        dict scoped to ``scene``): backends that share one built structure
        across registry entries (the grid family) memoize it there under
        their own key.  ``None`` builds fresh.
        """
        return None

    def refit_index(
        self,
        index,
        old_scene: Scene,
        new_scene: Scene,
        changed: np.ndarray,
        *,
        grid_g: int = 64,
    ) -> tuple[Any, bool]:
        """Adapt ``index`` (built for ``old_scene``) to ``new_scene``.

        ``changed`` lists the real-triangle ids whose geometry differs; all
        other triangles are bit-identical between the scenes.  Returns
        ``(new_index, refit)`` where ``refit`` is True when the index was
        adapted in place rather than rebuilt.  The default — and the
        fallback of every override whose cheap path does not apply — is a
        fresh :meth:`build_index`.  Either way the returned index counts
        exactly like a fresh build.
        """
        return self.build_index(new_scene, grid_g=grid_g), False

    def prepare_batch(self, req: BatchRequest):
        """Host-side batch stacking; the returned object is what
        :meth:`count_batch` dispatches.  Runs inside ``t_filter_s``."""
        return None

    # ---- verify phase (device) ------------------------------------------
    def count(self, req: QueryRequest) -> np.ndarray:
        """``[N]`` int32 hit counts for one query."""
        raise NotImplementedError

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        """``[Q, N]`` int32 hit counts in one batched device dispatch."""
        raise NotImplementedError


_REGISTRY: dict[str, Backend] = {}


def register_backend(cls: type[Backend]) -> type[Backend]:
    """Class decorator: instantiate and register under ``cls.name``.

    Later registrations override earlier ones (so tests / downstream code
    can shadow a built-in with an instrumented variant).
    """
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"backend must be one of {available_backends()}, got {name!r}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def concrete_backends() -> tuple[str, ...]:
    """Registered names that do the counting themselves — meta backends
    (the ``auto`` planner) route to these and are excluded.  Single source
    of truth for every "all real backends" list."""
    return tuple(n for n, b in _REGISTRY.items() if not b.is_meta)


def timeable_backends(device: str | torch.device | None = None) -> tuple[str, ...]:
    """Concrete backends whose wall time on ``device`` (``None``: CUDA, as
    every entry point) means something.

    Replaces the JAX package's ``interpret_mode_on_cpu`` rule.  On a CUDA
    device the plain twins (``plain_twin_of``) are left out: they are the
    correctness tool, and ``auto`` never serves through them there.  On
    the CPU the kernel backends that have a plain twin are left out
    instead: their CPU path *is* the twin, so timing both measures one
    thing twice (the CPU set equals the JAX package's
    ``timeable_backends()`` on a host without a TPU)."""
    names = concrete_backends()
    if torch.device("cuda" if device is None else device).type == "cuda":
        return tuple(n for n in names if _REGISTRY[n].plain_twin_of is None)
    twinned = {_REGISTRY[n].plain_twin_of for n in names}
    return tuple(n for n in names if n not in twinned)


def _per_user_set(req, key, build):
    """``build()``, cached in the request's snapshot memo under ``key`` when
    it has one.  The entry holds a strong reference to ``req.xs``, so an
    ``id(xs)`` in the key stays valid for the entry's lifetime; without a
    memo the state is built afresh."""
    memo, xs = req.memo, req.xs
    if memo is not None:
        hit = memo.get(key)
        if hit is not None and hit[0] is xs:
            return hit[1]
    value = build()
    if memo is not None:
        memo.put(key, (xs, value))
    return value


def _user_order_for(req, kernel_backend: str) -> UserOrder | None:
    """The kernels' spatial order of the request's users (the dense and the
    rank-count kernel read the same one), built on their device once per
    snapshot; ``None`` where the plain version runs, which needs no order."""
    xs = req.xs
    if not _ops.use_kernel(kernel_backend, xs.device):
        return None
    return _per_user_set(
        req, ("user-order", id(xs), int(xs.shape[0])), lambda: build_user_order(xs, req.ys)
    )


# --------------------------------------------------------------------------
# Dense (stacked edge functions, no index)
# --------------------------------------------------------------------------


@register_backend
class DenseBackend(Backend):
    """The CUDA ray-cast kernel over the full padded scene."""

    name = "dense"
    kernel_backend = "cuda"

    def count(self, req: QueryRequest) -> np.ndarray:
        coeffs = torch.from_numpy(req.scene.coeffs).to(req.device)
        order = _user_order_for(req, self.kernel_backend)
        return _ops.raycast_count(
            req.xs, req.ys, coeffs, backend=self.kernel_backend, order=order
        ).cpu().numpy()

    def prepare_batch(self, req: BatchRequest) -> torch.Tensor:
        scenes = req.scenes
        # size the stacked pad from the REAL triangle counts: scenes arrive
        # pre-padded (possibly to a much larger sticky bucket), and sizing
        # from tris.shape[0] over-pads the whole [Q, Mp, 3, 3] stack on the
        # one-shot shim path (req.mp None)
        mp = (
            req.mp
            if req.mp is not None
            else _next_pad(max(s.n_tris for s in scenes))
        )
        stacked = np.stack(
            [
                pad_scene_arrays(
                    s.tris[: s.n_tris], s.coeffs[: s.n_tris], s.owner[: s.n_tris], mp
                )[1]
                for s in scenes
            ]
        ).astype(np.float32)  # [Q, Mp, 3, 3]
        # the upload belongs to the filter phase, and the batch LRU then
        # keeps the stack resident on the device
        return torch.from_numpy(stacked).to(req.device)

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        order = _user_order_for(req, self.kernel_backend)
        return _ops.raycast_count_batch(
            req.xs, req.ys, prepared, backend=self.kernel_backend, order=order
        ).cpu().numpy()


@register_backend
class DenseRefBackend(DenseBackend):
    """The plain PyTorch version of the dense count, on the same device."""

    name = "dense-ref"
    kernel_backend = "ref"
    plain_twin_of = "dense"


# --------------------------------------------------------------------------
# Grid (uniform-grid culling, the BVH analogue)
# --------------------------------------------------------------------------


@register_backend
class GridBackend(Backend):
    """Grid-culled counting in plain PyTorch on the engine's device (the
    JAX package runs the same count as jnp, with no Pallas kernel)."""

    name = "grid"

    def build_index(self, scene: Scene, *, grid_g: int = 64, memo: dict | None = None):
        # the grid, grid-pallas, and grid-pallas-ref backends all build the
        # identical index, so within one snapshot's per-scene store they
        # share it under ("grid", G) — a scene queried through more than
        # one of them pays one build (the bucketed variants hang their
        # packed planes off the shared object)
        key = ("grid", int(grid_g))
        if memo is not None:
            g = memo.get(key)
            if g is not None:
                return g
        g = build_grid(
            scene.tris[: scene.n_tris],
            scene.coeffs[: scene.n_tris],
            scene.rect,
            G=grid_g,
        )
        if memo is not None:
            memo[key] = g
        return g

    def refit_index(
        self,
        index,
        old_scene: Scene,
        new_scene: Scene,
        changed: np.ndarray,
        *,
        grid_g: int = 64,
    ):
        if index is not None and index.G == grid_g:
            n = old_scene.n_tris
            g = refit_grid(
                index,
                old_scene.tris[:n],
                old_scene.coeffs[:n],
                new_scene.tris[: new_scene.n_tris],
                new_scene.coeffs[: new_scene.n_tris],
                changed,
            )
            if g is not None:
                return g, True
        return self.build_index(new_scene, grid_g=grid_g), False

    def count(self, req: QueryRequest) -> np.ndarray:
        g = req.index
        if g is None:
            g = self.build_index(req.scene, grid_g=req.grid_g)
        return grid_hit_counts_torch(
            req.xs, req.ys, g.base, g.lists, g.coeffs, req.scene.rect, req.grid_g
        ).cpu().numpy()

    def prepare_batch(self, req: BatchRequest):
        indexes = req.indexes
        if indexes is None:
            indexes = [self.build_index(s, grid_g=req.grid_g) for s in req.scenes]
        # the upload belongs to the filter phase, as the dense stack's does
        return tuple(torch.from_numpy(a).to(req.device) for a in stack_grids(indexes))

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        base, lists, coeffs = prepared
        return grid_hit_counts_batch_torch(
            req.xs, req.ys, base, lists, coeffs, req.rect, req.grid_g
        ).cpu().numpy()


# --------------------------------------------------------------------------
# Grid-Pallas (cell-bucketed CUDA kernel over the grid index)
# --------------------------------------------------------------------------


def stack_cell_planes(planes: list[np.ndarray]) -> np.ndarray:
    """Stack per-scene packed coefficient planes ``[n_cells, 3, 3, L_i]``
    into one ``[Q, n_cells, 3, 3, L]`` batch table.

    Per-scene lane widths ``L_i`` are heterogeneous (each scene pads to
    its own longest cell list); short planes degenerate-pad with the
    third coefficient row at ``-1`` — a plane no point is ever inside —
    so padding lanes can never contribute a hit.
    """
    L = max(p.shape[-1] for p in planes)
    if all(p.shape[-1] == L for p in planes):
        return np.stack(planes)
    out = np.zeros((len(planes),) + planes[0].shape[:-1] + (L,), np.float32)
    out[:, :, :, 2, :] = -1.0  # degenerate pad (never inside)
    for i, p in enumerate(planes):
        out[i, ..., : p.shape[-1]] = p
    return out


class CellBuckets(NamedTuple):
    """One user set sorted by grid cell (see
    :func:`repro_torch.kernels.grid_raycast.prepare_cell_buckets`), each
    cell's run in Morton order with its padding rows on its last user
    (:func:`~repro_torch.kernels.grid_raycast.order_cell_runs`).

    ``xs_s``, ``ys_s``, ``ranks``, ``unsort`` and ``boxes`` live on the
    engine's device; ``occ`` is a host array.  ``occ`` lists the
    user-occupied cell ids and ``ranks`` maps each user block into that
    compact axis, so the plane and base tables shipped to the device carry
    only occupied cells.  ``unsort`` is the rows'
    :func:`~repro_torch.kernels.grid_raycast.unsort_index`, ``boxes`` their
    :func:`~repro_torch.kernels.grid_raycast.block_boxes`.
    """

    xs_s: torch.Tensor  # [n_sorted] f32
    ys_s: torch.Tensor  # [n_sorted] f32
    ranks: torch.Tensor  # [n_blocks] int32
    occ: np.ndarray  # [n_occupied] cell ids
    block: int
    unsort: torch.Tensor  # [N] int64
    boxes: torch.Tensor  # [n_blocks, 4] f32


@register_backend
class GridPallasBackend(GridBackend):
    """Cell-bucketed grid counting through the CUDA kernel
    (``repro_torch/csrc/grid_raycast.cu``; the registry name is the JAX
    package's, whose backend runs the scalar-prefetch Pallas kernel).

    The plain grid count pays a per-user ``[N, L, 3, 3]`` coefficient
    gather.  This backend instead

    * sorts users by grid cell once per ``(users, rect, G)``, in Morton
      order inside each cell, and takes the bounding box of each user
      block (all stacked scenes share one domain rect; the bucketing is
      cached in the snapshot's kernel memo, on the device, so successive
      batches over the same user set reuse it),
    * packs each grid index's per-cell coefficient planes
      ``[G*G, 3, 3, L]`` once (memoized on the index; incrementally
      re-packed for the cells a :meth:`refit_index` touches),
    * compacts the stacked plane/base tables to the user-OCCUPIED cells
      (``cell_map`` becomes a rank into that compact axis) and takes each
      (query, cell) list's length on the device, and
    * dispatches one kernel launch in which each thread block takes one
      user block and up to 16 queries, classifies each cell's listed
      triangles on the block's box, tests single users only where an
      edge crosses it, and adds ``base[q, cell]``.

    Everything host-side (bucketing, packing, stacking, upload) runs in
    :meth:`prepare_batch` (``t_filter_s``); :meth:`count_batch` is the one
    device dispatch, the unsort on the device and the copy back.  Counts
    are bit-identical to the ``grid`` backend's.
    """

    name = "grid-pallas"
    kernel_backend = "cuda"
    #: the prepared tuple holds the :class:`CellBuckets` (the users sorted
    #: by cell, on the device), so a user delta must rebuild it
    prepared_carries_users = True

    # ---- packed per-cell planes (memoized on the grid index) ------------
    @staticmethod
    def _planes_for(grid: OccluderGrid) -> np.ndarray:
        planes = getattr(grid, "_cell_planes", None)
        if planes is None:
            planes = pack_cell_coeff_planes(grid)
            grid._cell_planes = planes
        return planes

    # ---- user bucketing (shared across batches over one user set) -------
    def _buckets_for(self, req, rect: Rect, G: int) -> CellBuckets:
        """The :class:`CellBuckets` of the request's users.

        Bucketed from the host float32 copy of the users (the same cast
        :class:`~repro_torch.core.snapshot.EngineSnapshot` uploads), never
        from the device tensors.  With a snapshot memo (engine-routed
        requests) the result is cached per snapshot (:func:`_per_user_set`);
        without one the users are bucketed afresh.
        """
        key = ("gp-buckets", id(req.xs), int(req.xs.shape[0]), rect, int(G))
        return _per_user_set(req, key, lambda: self._bucket(req, rect, G))

    def _bucket(self, req, rect: Rect, G: int) -> CellBuckets:
        xs = req.xs
        n = int(xs.shape[0])
        if req.users is not None:
            xs_np = np.ascontiguousarray(req.users[:, 0], dtype=np.float32)
            ys_np = np.ascontiguousarray(req.users[:, 1], dtype=np.float32)
        elif xs.device.type == "cpu":
            xs_np, ys_np = xs.numpy(), req.ys.numpy()
        else:
            raise ValueError(
                f"{self.name} buckets the host copy of the users: pass "
                f"`users` with user tensors on {xs.device}"
            )
        xs_s, ys_s, order, cell_map, nb = prepare_cell_buckets(
            xs_np, ys_np, rect, G, block=None
        )
        occ = np.unique(cell_map)
        dev = xs.device
        block = xs_s.shape[0] // nb if nb else 0
        ranks = torch.from_numpy(np.searchsorted(occ, cell_map).astype(np.int32)).to(dev)
        xs_s, ys_s, order = order_cell_runs(
            torch.from_numpy(xs_s).to(dev), torch.from_numpy(ys_s).to(dev),
            torch.from_numpy(order).to(dev), ranks, block, rect,
        )
        return CellBuckets(
            xs_s=xs_s, ys_s=ys_s, ranks=ranks, occ=occ, block=block,
            unsort=unsort_index(order, n), boxes=block_boxes(xs_s, ys_s, block),
        )

    # ---- filter phase ----------------------------------------------------
    def build_index(self, scene: Scene, *, grid_g: int = 64, memo: dict | None = None):
        grid = super().build_index(scene, grid_g=grid_g, memo=memo)
        self._planes_for(grid)  # pack eagerly: host work belongs to filter
        return grid

    def refit_index(
        self,
        index,
        old_scene: Scene,
        new_scene: Scene,
        changed: np.ndarray,
        *,
        grid_g: int = 64,
    ):
        new_grid, was_refit = super().refit_index(
            index, old_scene, new_scene, changed, grid_g=grid_g
        )
        if was_refit:
            # incremental plane re-pack: refit_grid preserves the padded
            # list width, so only cells whose candidate list changed — or
            # that list a changed triangle (its coefficients moved) — need
            # their [3, 3, L] planes rewritten
            old_planes = getattr(index, "_cell_planes", None)
            if old_planes is not None:
                touched = np.flatnonzero(
                    np.any(index.lists != new_grid.lists, axis=1)
                    | np.isin(new_grid.lists, np.asarray(changed)).any(axis=1)
                )
                new_grid._cell_planes = repack_cell_coeff_planes(
                    old_planes, new_grid, touched
                )
        return new_grid, was_refit

    def prepare_batch(self, req: BatchRequest):
        indexes = req.indexes
        if indexes is None:
            indexes = [self.build_index(s, grid_g=req.grid_g) for s in req.scenes]
        G = indexes[0].G
        rect = indexes[0].rect
        if any(g.G != G for g in indexes):
            raise ValueError("all grids in a batch must share G")
        if any(g.rect != rect for g in indexes):
            raise ValueError("all grids in a batch must share the domain rect")
        buckets = self._buckets_for(req, rect, G)
        occ = buckets.occ
        planes_q = stack_cell_planes([self._planes_for(g)[occ] for g in indexes])
        base_q = np.stack([g.base[occ] for g in indexes]).astype(np.int32)
        planes = torch.from_numpy(planes_q).to(req.device)
        return (
            buckets,
            torch.from_numpy(base_q).to(req.device),
            planes,
            cell_list_lengths(planes),
        )

    # ---- verify phase ----------------------------------------------------
    def count(self, req: QueryRequest) -> np.ndarray:
        grid = req.index
        if grid is None:
            grid = self.build_index(req.scene, grid_g=req.grid_g)
        b = self._buckets_for(req, grid.rect, grid.G)
        planes = torch.from_numpy(self._planes_for(grid)[b.occ]).to(req.device)
        counts = _ops.grid_count_cells(
            b.xs_s, b.ys_s, b.ranks,
            torch.from_numpy(grid.base[b.occ]).to(req.device), planes,
            block=b.block, backend=self.kernel_backend,
            lens=cell_list_lengths(planes), boxes=b.boxes,
        )
        return unsort_cell_counts(counts, b.unsort).cpu().numpy()

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        b, base_q, planes_q, lens_q = prepared
        counts = _ops.grid_count_cells_batch(
            b.xs_s, b.ys_s, b.ranks, base_q, planes_q,
            block=b.block, backend=self.kernel_backend, lens=lens_q, boxes=b.boxes,
        )
        return unsort_cell_counts(counts, b.unsort).cpu().numpy()


@register_backend
class GridPallasRefBackend(GridPallasBackend):
    """The plain PyTorch version of the bucketed grid count, on the same
    device (mirrors the dense/dense-ref pairing)."""

    name = "grid-pallas-ref"
    kernel_backend = "ref"
    plain_twin_of = "grid-pallas"


# --------------------------------------------------------------------------
# BVH (paper-faithful traversal with early termination at k)
# --------------------------------------------------------------------------


@register_backend
class BvhBackend(Backend):
    """LBVH per scene, counted by the CUDA stack-walk kernel with an early
    exit at ``k`` (counts saturate at ``k``; masks equal every other
    backend's).  The users are read in the snapshot's spatial order, the
    one the dense and brute backends share."""

    name = "bvh"
    kernel_backend = "cuda"

    def build_index(self, scene: Scene, *, grid_g: int = 64, memo: dict | None = None):
        return build_bvh(scene.tris[: scene.n_tris])

    def refit_index(
        self,
        index,
        old_scene: Scene,
        new_scene: Scene,
        changed: np.ndarray,
        *,
        grid_g: int = 64,
    ):
        if index is not None:
            bvh = refit_bvh(index, new_scene.tris[: new_scene.n_tris])
            if bvh is not None:
                return bvh, True
        return self.build_index(new_scene, grid_g=grid_g), False

    def count(self, req: QueryRequest) -> np.ndarray:
        bvh: BVH = req.index
        if bvh is None:
            bvh = self.build_index(req.scene, grid_g=req.grid_g)
        return _ops.bvh_count(
            req.xs, req.ys, bvh.left, bvh.right, bvh.bbox,
            req.scene.coeffs[: req.scene.n_tris], k=req.k, backend=self.kernel_backend,
            order=_user_order_for(req, self.kernel_backend),
        ).cpu().numpy()

    def prepare_batch(self, req: BatchRequest) -> BvhBatch:
        indexes = req.indexes
        if indexes is None:
            indexes = [self.build_index(s, grid_g=req.grid_g) for s in req.scenes]
        # the depth is taken and the records packed once here, on the host;
        # their upload belongs to the filter phase, and the batch LRU then
        # keeps them on the device
        return bvh_batch(
            *stack_bvhs(indexes, [s.coeffs[: s.n_tris] for s in req.scenes]), req.device
        )

    def count_batch(self, req: BatchRequest, prepared: BvhBatch) -> np.ndarray:
        return _ops.bvh_count_stacked(
            req.xs, req.ys, prepared, k=req.k, backend=self.kernel_backend,
            order=_user_order_for(req, self.kernel_backend),
        ).cpu().numpy()


# --------------------------------------------------------------------------
# Brute (exact distance-rank counting; no geometry at all)
# --------------------------------------------------------------------------


@register_backend
class BruteBackend(Backend):
    name = "brute"
    uses_scene = False
    kernel_backend = "cuda"

    def count(self, req: QueryRequest) -> np.ndarray:
        """Row 5's kernel at ``Q = 1`` on the card (the JAX package runs its
        plain version here; on a CUDA engine the ``auto`` planner may route
        single queries to this backend, and no plain version may serve
        there).  Engine requests carry the snapshot's device users and memo,
        so the users' order is the one the batch path keeps; raw protocol
        use uploads the host users."""
        if req.xs is None:
            users, order = _on(req.users, req.device), None
        else:
            users = torch.stack((req.xs, req.ys), dim=1)
            order = _user_order_for(req, self.kernel_backend)
        return _ops.rank_count(
            users,
            _on(req.facilities, req.device),
            _on(req.q_pt, req.device),
            exclude=req.exclude,
            backend=self.kernel_backend,
            order=order,
        ).cpu().numpy()

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        """The rank-count kernel's query axis over the engine's device users
        (``req.xs, req.ys``, the same f32 cast as ``_on(req.users)``), in
        the user order the dense backend keeps in the snapshot memo."""
        return _ops.rank_count_batch_xy(
            req.xs,
            req.ys,
            _on(req.facilities, req.device),
            _on(req.q_pts, req.device),
            exclude=req.excludes,
            backend=self.kernel_backend,
            order=_user_order_for(req, self.kernel_backend),
        ).cpu().numpy()


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as float32 on ``device`` (cast on the host, so the
    rounding is numpy's round-to-nearest on every device)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


# --------------------------------------------------------------------------
# Auto (the query planner — registered last so concrete backends come first)
# --------------------------------------------------------------------------

from repro_torch.planner.backend import PlannerBackend  # noqa: E402 — deliberate
                                                        # tail import; the planner
                                                        # module has no core imports
                                                        # at module level (acyclic)

register_backend(PlannerBackend)
