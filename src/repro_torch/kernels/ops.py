"""Public wrappers around the CUDA kernels (``repro.kernels.ops``).

Same signatures and results as the JAX package's ops, with the Pallas
tiling arguments gone: ``backend="cuda"`` (the default) launches the
hand-written kernel for CUDA tensors and takes the plain PyTorch version
only for CPU tensors; ``backend="ref"`` always takes the plain version.
For a CUDA tensor there is no fallback: a kernel that fails to build or
launch raises.  Unlike the Pallas wrappers these need no user or
triangle padding: the kernels mask their ragged edges themselves.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bvh import MAX_STACK as BVH_MAX_STACK
from repro_torch.kernels.bvh import (
    BvhBatch,
    bvh_batch,
    bvh_count_batch_kernel_call,
    bvh_count_kernel_call,
)
from repro_torch.kernels.grid_raycast import (
    block_boxes,
    cell_list_lengths,
    grid_raycast_cells_batch,
)
from repro_torch.kernels.rank_count import rank_count_batch_kernel_call, rank_count_kernel_call
from repro_torch.kernels.raycast import (
    raycast_count_batch_kernel_call,
    raycast_count_kernel_call,
)
from repro_torch.kernels.user_order import UserOrder

__all__ = [
    "raycast_count",
    "raycast_count_batch",
    "grid_count_cells",
    "grid_count_cells_batch",
    "rank_count",
    "rank_count_batch",
    "rank_count_batch_xy",
    "bvh_count",
    "bvh_count_batch",
    "bvh_count_stacked",
    "BVH_MAX_STACK",
    "use_kernel",
]

_USER_CHUNK = 32_768  # bounds the [chunk, M] edge temporaries of the plain path
_RANK_CHUNK_ELEMS = 1 << 22  # bounds the [Q, chunk, M] distance temporaries
#: Element budget of one [Q, chunk, block, L] edge temporary of the plain
#: bucketed grid count (the JAX package's ``_CELL_CHUNK_ELEMS``).
_CELL_CHUNK_ELEMS = 4_194_304
#: (query, user) lanes of one chunk of the plain BVH walk: bounds its
#: ``[lanes, depth]`` stacks and temporaries (a few GB on the card).
_BVH_CHUNK_LANES = 1 << 24


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def use_kernel(backend: str, device: torch.device) -> bool:
    """Whether a wrapper with ``backend`` launches the kernel for tensors on
    ``device`` (it does for CUDA tensors unless ``backend="ref"``)."""
    if backend == "ref":
        return False
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel path for device {device}")
    return device.type == "cuda"


def _raycast_batch_ref_chunked(xs, ys, coeffs, chunk: int):
    """Plain batched count, user-chunked so the ``[Q, chunk, Mp]`` edge
    temporaries stay the size of the single-query path's."""
    if xs.shape[0] <= chunk:
        return _ref.raycast_count_batch_ref(xs, ys, coeffs)
    return torch.cat(
        [
            _ref.raycast_count_batch_ref(xs[s : s + chunk], ys[s : s + chunk], coeffs)
            for s in range(0, xs.shape[0], chunk)
        ],
        dim=1,
    )


def raycast_count(
    xs, ys, coeffs, *, backend: str = "cuda", order: UserOrder | None = None
) -> torch.Tensor:
    """Hit counts of users against occluder edge functions.

    ``xs, ys``: ``[N]``; ``coeffs``: ``[M, 3, 3]``.  Returns ``[N]`` int32
    on the device of ``xs``.  Padding slots are degenerate
    (``a = b = 0, c = -1``) and contribute nothing.  ``order``: the
    kernel's spatial order of these users
    (:func:`repro_torch.kernels.user_order.build_user_order` of these very
    ``xs, ys``: an order of other users gives wrong counts), built by the
    kernel wrapper when ``None``; the plain version does not read it.
    """
    dev = _device_of(xs)
    xs, ys, coeffs = _f32(xs, dev), _f32(ys, dev), _f32(coeffs, dev)
    if coeffs.ndim != 3:
        raise ValueError(f"coeffs must be [M, 3, 3], got {tuple(coeffs.shape)}")
    if use_kernel(backend, dev):
        return raycast_count_kernel_call(xs, ys, coeffs, order)
    return _raycast_batch_ref_chunked(xs, ys, coeffs[None], _USER_CHUNK)[0]


def raycast_count_batch(
    xs, ys, coeffs, *, backend: str = "cuda", order: UserOrder | None = None
) -> torch.Tensor:
    """Batched multi-query hit counts: one launch for a whole query batch.

    ``xs, ys``: ``[N]`` shared users; ``coeffs``: ``[Q, Mp, 3, 3]`` stacked
    per-query edge functions (padded degenerate — see
    :func:`repro_torch.core.scene.pad_scene_arrays`).  Returns ``[Q, N]``
    int32 on the device of ``xs``.  ``order`` as in :func:`raycast_count`.
    """
    dev = _device_of(xs)
    xs, ys, coeffs = _f32(xs, dev), _f32(ys, dev), _f32(coeffs, dev)
    if coeffs.ndim != 4:
        raise ValueError(f"coeffs must be [Q, Mp, 3, 3], got {tuple(coeffs.shape)}")
    if use_kernel(backend, dev):
        return raycast_count_batch_kernel_call(xs, ys, coeffs, order)
    chunk = max(1024, _USER_CHUNK // max(int(coeffs.shape[0]), 1))
    return _raycast_batch_ref_chunked(xs, ys, coeffs, chunk)


def grid_count_cells_batch(
    xs_sorted, ys_sorted, cell_map, base, planes, *, block: int, backend: str = "cuda",
    lens=None, boxes=None,
) -> torch.Tensor:
    """Batched cell-bucketed grid hit counts: ``[Q, n_sorted]`` int32.

    ``xs_sorted/ys_sorted``: ``[n_blocks*block]`` cell-sorted padded users
    (from :func:`repro_torch.kernels.grid_raycast.prepare_cell_buckets`,
    shared across the batch's queries); ``cell_map``: ``[n_blocks]``;
    ``base``: ``[Q, n_cells]``; ``planes``: ``[Q, n_cells, 3, 3, L]``.
    Counts stay in sorted order on the device of ``xs_sorted`` — unsort
    with :func:`repro_torch.kernels.grid_raycast.unsort_cell_counts`.
    The kernel adds ``base[q, cell]`` itself; the plain path adds it with
    a gather after the block-chunked count.  ``lens`` (``[Q, n_cells]``,
    :func:`~repro_torch.kernels.grid_raycast.cell_list_lengths` of these
    planes) and ``boxes`` (``[n_blocks, 4]``,
    :func:`~repro_torch.kernels.grid_raycast.block_boxes` of these users)
    are what the kernel reads beside them; each is computed here on the
    users' device when ``None``.  The plain version reads neither.
    """
    dev = _device_of(xs_sorted)
    xs = _f32(xs_sorted, dev)
    ys = _f32(ys_sorted, dev)
    cell_map = torch.as_tensor(cell_map, dtype=torch.int32, device=dev).contiguous()
    base = torch.as_tensor(base, dtype=torch.int32, device=dev).contiguous()
    planes = _f32(planes, dev)
    if planes.ndim != 5:
        raise ValueError(f"planes must be [Q, n_cells, 3, 3, L], got {tuple(planes.shape)}")
    q_n, nb = planes.shape[0], cell_map.shape[0]
    if nb == 0:
        return torch.zeros((q_n, 0), dtype=torch.int32, device=dev)
    if use_kernel(backend, dev):
        if lens is None:
            lens = cell_list_lengths(planes)
        if boxes is None:
            boxes = block_boxes(xs, ys, block)
        return grid_raycast_cells_batch(
            xs, ys, cell_map, planes, block=block, lens=lens, boxes=boxes, base=base
        )
    chunk = max(_CELL_CHUNK_ELEMS // max(q_n * block * int(planes.shape[-1]), 1), 1)
    counts = torch.cat(
        [
            _ref.grid_cells_count_batch_ref(
                xs[s * block : (s + chunk) * block],
                ys[s * block : (s + chunk) * block],
                cell_map[s : s + chunk],
                planes,
            )
            for s in range(0, nb, chunk)
        ],
        dim=1,
    )
    return counts + base[:, cell_map.long().repeat_interleave(block)]


def grid_count_cells(
    xs_sorted, ys_sorted, cell_map, base, planes, *, block: int, backend: str = "cuda",
    lens=None, boxes=None,
) -> torch.Tensor:
    """Single-query bucketed grid hit counts: ``[n_sorted]`` int32.

    ``base``: ``[n_cells]``; ``planes``: ``[n_cells, 3, 3, L]``; ``lens``:
    ``[n_cells]`` or ``None``.  Same contract as
    :func:`grid_count_cells_batch` at ``Q = 1``, whose kernel it launches.
    """
    dev = _device_of(xs_sorted)
    return grid_count_cells_batch(
        xs_sorted,
        ys_sorted,
        cell_map,
        torch.as_tensor(base, dtype=torch.int32, device=dev)[None],
        _f32(planes, dev)[None],
        block=block,
        backend=backend,
        lens=None if lens is None else lens[None],
        boxes=boxes,
    )[0]


def rank_count(
    users, facilities, q, *, exclude: int | None = None, backend: str = "cuda",
    order: UserOrder | None = None,
):
    """#facilities strictly closer than ``q`` per user (``[N]`` int32).

    ``users``: ``[N, 2]``; ``facilities``: ``[M, 2]``; ``q``: ``[2]``.
    ``exclude`` masks one facility row (the query itself for in-set
    queries): the plain version pushes it to infinity, the kernel skips
    it.  The thresholds ``d^2(u, q)`` are taken in f32 after the f32 cast
    of the users, as the JAX wrapper does (the kernel computes them itself,
    in the same order).  ``order``: the kernel's spatial order of these
    users, as in :func:`raycast_count`; the plain version does not read it.
    """
    dev = _device_of(users)
    users, facilities, q = _f32(users, dev), _f32(facilities, dev), _f32(q, dev)
    xs, ys = users[:, 0], users[:, 1]
    m = facilities.shape[0]
    if exclude is not None:
        exclude = operator.index(exclude)
        if not -m <= exclude < m:
            raise IndexError(f"exclude {exclude} is out of range for {m} facilities")
        exclude %= m
    if use_kernel(backend, dev):
        excl = torch.full((1,), -1 if exclude is None else exclude, dtype=torch.int32, device=dev)
        return rank_count_kernel_call(xs, ys, facilities, q, excl, order)
    fx, fy = facilities[:, 0].clone(), facilities[:, 1].clone()  # written below
    if exclude is not None:
        fx[exclude] = float("inf")
        fy[exclude] = float("inf")
    dx, dy = xs - q[0], ys - q[1]
    thr = dx * dx + dy * dy
    chunk = max(1, _RANK_CHUNK_ELEMS // max(m, 1))
    return torch.cat(
        [
            _ref.rank_count_ref(xs[s : s + chunk], ys[s : s + chunk], fx, fy, thr[s : s + chunk])
            for s in range(0, xs.shape[0], chunk)
        ]
        or [torch.zeros((0,), dtype=torch.int32, device=dev)]
    )


def rank_count_batch(
    users, facilities, q_pts, *, exclude=None, backend: str = "cuda",
    order: UserOrder | None = None,
) -> torch.Tensor:
    """Batched distance-rank counting: ``[Q, N]`` int32, one kernel launch
    for the whole batch on the card.

    ``users``: ``[N, 2]``; ``facilities``: ``[M, 2]``; ``q_pts``: ``[Q, 2]``.
    ``exclude`` is an optional length-``Q`` sequence of facility rows to
    mask per query (``-1`` / ``None`` entries mask nothing).  The JAX
    package computes this with plain jnp ops in one dispatch; here the
    rank-count kernel's query axis does it.  ``order`` as in
    :func:`rank_count`.
    """
    users = _f32(users, _device_of(users))
    return rank_count_batch_xy(
        users[:, 0], users[:, 1], facilities, q_pts, exclude=exclude, backend=backend, order=order
    )


def rank_count_batch_xy(
    xs, ys, facilities, q_pts, *, exclude=None, backend: str = "cuda",
    order: UserOrder | None = None,
) -> torch.Tensor:
    """:func:`rank_count_batch` of the users ``xs, ys`` (``[N]`` each, as
    the engine keeps them on its device): no ``[N, 2]`` copy is made."""
    dev = _device_of(xs)
    xs, ys = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (xs, ys))
    facilities, q_pts = _f32(facilities, dev), _f32(q_pts, dev)
    q_n, m = q_pts.shape[0], facilities.shape[0]
    excl = np.full(q_n, -1, dtype=np.int64)
    if exclude is not None:
        excl = np.asarray([-1 if e is None else int(e) for e in exclude], dtype=np.int64)
        if excl.shape != (q_n,):
            raise ValueError(f"exclude must have one entry per query ({q_n}), got {excl.shape}")
        if np.any(excl >= m):
            raise IndexError(f"exclude {int(excl.max())} is out of range for {m} facilities")
    if use_kernel(backend, dev):
        excl_d = torch.from_numpy(np.maximum(excl, -1).astype(np.int32)).to(dev)
        return rank_count_batch_kernel_call(xs, ys, facilities, q_pts, excl_d, order)
    fx = facilities[:, 0].expand(q_n, m).clone()
    fy = facilities[:, 1].expand(q_n, m).clone()
    rows = np.flatnonzero(excl >= 0)
    if len(rows):
        fx[rows, excl[rows]] = float("inf")
        fy[rows, excl[rows]] = float("inf")
    dx = xs[None, :] - q_pts[:, 0, None]
    dy = ys[None, :] - q_pts[:, 1, None]
    thr = dx * dx + dy * dy
    chunk = max(1, _RANK_CHUNK_ELEMS // max(q_n * m, 1))
    return torch.cat(
        [
            _ref.rank_count_batch_ref(
                xs[s : s + chunk], ys[s : s + chunk], fx, fy, thr[:, s : s + chunk]
            )
            for s in range(0, xs.shape[0], chunk)
        ]
        or [torch.zeros((q_n, 0), dtype=torch.int32, device=dev)],
        dim=1,
    )


def _bvh_k_cap(k, mt: int) -> int:
    """The walk's cap: ``k``, or ``Mt + 1`` (every hit) when ``None``."""
    if k is not None and k < 0:
        raise ValueError(f"k must be >= 0 or None, got {k}")
    # a count never exceeds Mt, so min(count, k) == min(count, Mt + 1) for k > Mt
    return mt + 1 if k is None else min(int(k), mt + 1)


def bvh_count_batch(
    xs, ys, left, right, bbox, coeffs, *, k: int | None = None,
    max_stack: int = BVH_MAX_STACK, backend: str = "cuda", order: UserOrder | None = None,
) -> torch.Tensor:
    """Batched BVH hit counts (``repro.core.bvh.bvh_hit_counts_batch``):
    ``[Q, N]`` int32 on the device of ``xs``, saturated at ``k`` (all hits,
    at most ``Mt``, when ``None``).

    ``xs, ys``: ``[N]`` shared users; ``left, right``: ``[Q, Nn]``;
    ``bbox``: ``[Q, Nn, 4]``; ``coeffs``: ``[Q, Mt, 3, 3]`` (from
    :func:`repro_torch.core.bvh.stack_bvhs`).  The stack the walk needs is
    taken from a host copy of ``left, right``; a tree deeper than
    ``max_stack`` (at most :data:`BVH_MAX_STACK`) raises ``ValueError``,
    where the JAX walk drops the push.  ``order`` as in
    :func:`raycast_count`; the plain version does not read it."""
    batch = bvh_batch(left, right, bbox, coeffs, _device_of(xs), max_stack=max_stack)
    return bvh_count_stacked(xs, ys, batch, k=k, backend=backend, order=order)


def bvh_count_stacked(
    xs, ys, batch: BvhBatch, *, k: int | None = None, backend: str = "cuda",
    order: UserOrder | None = None,
) -> torch.Tensor:
    """:func:`bvh_count_batch` on trees already put on the users' device by
    :func:`repro_torch.kernels.bvh.bvh_batch` (what ``BvhBackend`` keeps
    in the batch LRU)."""
    dev = _device_of(xs)
    xs, ys = _f32(xs, dev), _f32(ys, dev)
    k_cap = _bvh_k_cap(k, batch.coeffs.shape[1])
    if use_kernel(backend, dev):
        return bvh_count_batch_kernel_call(xs, ys, batch, k_cap, order)
    q_n = batch.left.shape[0]
    chunk = max(1, _BVH_CHUNK_LANES // max(q_n, 1))
    return torch.cat(
        [
            _ref.bvh_hit_counts_ref(xs[s : s + chunk], ys[s : s + chunk], *batch[:4], k_cap,
                                    batch.depth)
            for s in range(0, xs.shape[0], chunk)
        ]
        or [torch.zeros((q_n, 0), dtype=torch.int32, device=dev)],
        dim=1,
    )


def bvh_count(
    xs, ys, left, right, bbox, coeffs, *, k: int | None = None,
    max_stack: int = BVH_MAX_STACK, backend: str = "cuda", order: UserOrder | None = None,
) -> torch.Tensor:
    """Single-tree BVH hit counts (``repro.core.bvh.bvh_hit_counts``):
    ``[N]`` int32.  ``left, right``: ``[Nn]``; ``bbox``: ``[Nn, 4]``;
    ``coeffs``: ``[M, 3, 3]`` (unpadded: ``k=None`` caps at ``M + 1``, and
    ``M = 0`` counts 0).  Same contract as :func:`bvh_count_batch` at
    ``Q = 1``, whose kernel it launches."""
    dev = _device_of(xs)
    batch = bvh_batch(*(torch.as_tensor(v)[None] for v in (left, right, bbox, coeffs)), dev,
                      max_stack=max_stack)
    if use_kernel(backend, dev):
        k_cap = _bvh_k_cap(k, batch.coeffs.shape[1])
        return bvh_count_kernel_call(_f32(xs, dev), _f32(ys, dev), batch, k_cap, order)
    return bvh_count_stacked(xs, ys, batch, k=k, backend="ref")[0]
