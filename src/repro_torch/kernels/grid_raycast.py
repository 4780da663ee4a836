"""Cell-bucketed grid hit counting (``repro.kernels.grid_raycast``).

For non-pruned or conservatively pruned scenes (paper §4.8, Table 3) the
occluder count is large enough that the dense sweep wastes work.  The
grid index (:mod:`repro_torch.core.grid`) absorbs fully covering
triangles into a per-cell ``base`` counter; this module buckets users by
grid cell and tests each user only against its cell's partial-overlap
list.

The host sorts users by cell id and pads each cell's user run to a
multiple of the block size (:func:`prepare_cell_buckets`, numpy carried
over from the JAX package, as are the plane packers).  The port then
orders the users inside each run by a Morton code and gives the padding
rows their run's last user (:func:`order_cell_runs`, torch on the users'
device), so that each user block is small in space, and takes each
block's bounding box (:func:`block_boxes`).  One CUDA kernel
(``csrc/grid_raycast.cu``) replaces both Pallas kernels of the JAX
module: :func:`grid_raycast_cells_batch` launches it over
``(user block, query)`` and :func:`grid_raycast_cells` at ``Q = 1`` with
``base`` added in the kernel.  The kernel walks only each cell's listed
lanes (:func:`cell_list_lengths`) and classifies them once per user block
on the block's box, testing single users only where an edge crosses the
box.  :func:`unsort_cell_counts` maps the sorted counts back to user
order on the counts' device.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.user_order import morton_codes, tile_boxes

if TYPE_CHECKING:
    from repro_torch.core.grid import OccluderGrid

__all__ = [
    "auto_cell_block",
    "measured_pad_waste",
    "prepare_cell_buckets",
    "pack_cell_coeff_planes",
    "repack_cell_coeff_planes",
    "cell_list_lengths",
    "order_cell_runs",
    "block_boxes",
    "unsort_index",
    "unsort_cell_counts",
    "grid_raycast_cells",
    "grid_raycast_cells_batch",
    "batch_launches",
    "single_launches",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else): the batched wrapper and the single-query wrapper.
batch_launches = 0
single_launches = 0

_MAX_QUERIES = 65_535  # gridDim.y
_MAX_BLOCKS = 2**31 - 1  # gridDim.x

#: Coordinate filler for padded user slots in :func:`prepare_cell_buckets`
#: (the JAX package's): far outside every domain rect, and the rows are
#: dropped by :func:`unsort_cell_counts` regardless.  :func:`order_cell_runs`
#: replaces it with real coordinates, so that it does not widen the boxes.
_PAD_COORD = np.float32(2e9)


def auto_cell_block(n_users: int, n_occupied_cells: int) -> int:
    """Pick the per-cell user block size for a bucketing.

    Every occupied cell pads its user run up to a block multiple, so the
    padded total is ~``n + occupied * block``: a block near the mean cell
    occupancy keeps the waste bounded at ~2x while staying sublane-aligned
    (multiples of 8) for the TPU layout.  Clamped to [8, 256].
    """
    occ = max(int(n_occupied_cells), 1)
    mean = max(int(np.ceil(n_users / occ)), 1)
    return int(min(256, max(8, 1 << int(np.ceil(np.log2(mean))))))


def measured_pad_waste(xs, ys, rect, G: int) -> float:
    """Exact pad-waste ratio of :func:`prepare_cell_buckets` at
    ``block=None``: padded user rows / real user rows (≥ 1).

    The cell-bucketed kernels' verify cost tracks the *padded* total
    (``~ n + occupied · block``), not the raw user count — this ratio is
    the planner's occupancy feature (``log_pw``).  Computed from the same
    cell classification and :func:`auto_cell_block` choice as the real
    bucketing, without the sort or the scatter.
    """
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    n = len(xs)
    if n == 0:
        return 1.0
    w = rect.width / G
    h = rect.height / G
    cx = np.clip(np.floor((xs - rect.xmin) / w), 0, G - 1).astype(np.int64)
    cy = np.clip(np.floor((ys - rect.ymin) / h), 0, G - 1).astype(np.int64)
    _uniq, lens = np.unique(cx * G + cy, return_counts=True)
    block = auto_cell_block(n, len(lens))
    padded = ((lens + block - 1) // block) * block
    return float(max(int(padded.sum()) / n, 1.0))


def prepare_cell_buckets(xs, ys, rect, G: int, block: int | None = 256):
    """Host-side bucketing: sort users by cell; pad each cell to ``block``.

    Returns ``(xs_s, ys_s, order, cell_map, n_blocks)`` where ``order``
    maps sorted rows back to original rows (−1 for padding) and
    ``cell_map[b]`` is the cell id of user block ``b``.  ``block=None``
    picks :func:`auto_cell_block` from the measured cell occupancy.

    Fully vectorized: run boundaries come from ``np.searchsorted`` on the
    sorted cell ids and every padded destination index is computed in one
    shot — O(N log N) for the sort, O(N + cells) after, replacing the old
    per-unique-cell rescan of the full cell array (O(U · cells) host time
    inside ``t_filter_s``).
    """
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    n = len(xs)
    if n == 0:
        return (
            np.zeros(0, np.float32),
            np.zeros(0, np.float32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int32),
            0,
        )
    w = rect.width / G
    h = rect.height / G
    cx = np.clip(np.floor((xs - rect.xmin) / w), 0, G - 1).astype(np.int64)
    cy = np.clip(np.floor((ys - rect.ymin) / h), 0, G - 1).astype(np.int64)
    cell = cx * G + cy
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    uniq = np.unique(cell)
    starts = np.searchsorted(cell_sorted, uniq, side="left")
    ends = np.searchsorted(cell_sorted, uniq, side="right")
    lens = ends - starts
    if block is None:
        block = auto_cell_block(n, len(uniq))
    block = int(block)
    padded = ((lens + block - 1) // block) * block
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
    total = int(padded.sum())
    xs_s = np.full(total, _PAD_COORD, np.float32)
    ys_s = np.full(total, _PAD_COORD, np.float32)
    ord_s = np.full(total, -1, np.int64)
    run_id = np.repeat(np.arange(len(uniq)), lens)
    dest = offsets[run_id] + (np.arange(n) - starts[run_id])
    xs_s[dest] = xs[order]
    ys_s[dest] = ys[order]
    ord_s[dest] = order
    cell_map = np.repeat(uniq, padded // block).astype(np.int32)
    return xs_s, ys_s, ord_s, cell_map, len(cell_map)


def _fill_cell_planes(planes: np.ndarray, grid: OccluderGrid, cells) -> None:
    """Write the ``[3, 3, L]`` coefficient planes of ``cells`` in place.

    List-slot positions are preserved (a ``-1`` hole left by
    ``refit_grid`` stays a degenerate plane in place), so an incremental
    re-pack is bit-identical to a fresh :func:`pack_cell_coeff_planes`.
    """
    cells = np.asarray(cells, np.int64)
    if not len(cells) or not len(grid.coeffs):
        return
    lists = grid.lists[cells]  # [C, L]
    valid = lists >= 0
    gathered = np.transpose(
        grid.coeffs[np.maximum(lists, 0)], (0, 2, 3, 1)
    )  # [C, 3, 3, L]
    deg = np.zeros((3, 3, 1), np.float32)
    deg[:, 2, :] = -1.0
    planes[cells, :, :, : lists.shape[1]] = np.where(
        valid[:, None, None, :], gathered, deg
    )


def pack_cell_coeff_planes(grid: OccluderGrid):
    """``[G*G, 3(edges), 3(a,b,c), L]`` per-cell padded coefficient planes,
    ``L`` the grid's list width.

    Padding entries use the never-inside degenerate row (a=b=0, c=-1).
    ``L`` is not rounded up to a lane tile: the CUDA kernel walks any ``L``
    in shared-memory tiles, so padded lanes would only add degenerate work.
    """
    GG, L = grid.lists.shape
    L = max(L, 1)
    planes = np.zeros((GG, 3, 3, L), np.float32)
    planes[:, :, 2, :] = -1.0  # degenerate default
    occupied = np.flatnonzero((grid.lists >= 0).any(axis=1))
    _fill_cell_planes(planes, grid, occupied)
    return planes


def repack_cell_coeff_planes(
    planes: np.ndarray, grid: OccluderGrid, cells: np.ndarray
) -> np.ndarray:
    """Incrementally re-pack only ``cells`` of a packed plane array.

    ``planes`` must have been packed from a grid with the same list width
    (the refit contract: ``refit_grid`` preserves the
    padded list shape).  Returns a new array; the input is not mutated
    (cached indexes may still alias it).
    """
    out = planes.copy()
    _fill_cell_planes(out, grid, np.asarray(cells, np.int64))
    return out


def cell_list_lengths(planes: torch.Tensor) -> torch.Tensor:
    """``[..., n_cells]`` int32 on the planes' device: for packed planes
    ``[..., n_cells, 3, 3, L]``, one past the last lane that is not the
    degenerate plane (all three edges ``a = b = 0, c = -1``), 0 for a cell
    with no other lane.

    The degenerate plane holds no user, so a count over a cell's first
    ``lens`` lanes equals one over all ``L``; a ``-1`` hole that
    :func:`repro_torch.core.grid.refit_grid` leaves inside a list is a
    degenerate lane below the length and counts nothing either.
    """
    lanes = planes.shape[-1]
    if lanes == 0:
        return torch.zeros(planes.shape[:-3], dtype=torch.int32, device=planes.device)
    degenerate = (planes[..., 0, :] == 0) & (planes[..., 1, :] == 0) & (planes[..., 2, :] == -1)
    live = ~degenerate.all(dim=-2)  # [..., n_cells, L]
    lane = torch.arange(1, lanes + 1, dtype=torch.int32, device=planes.device)
    return (live * lane).amax(dim=-1).to(torch.int32)


def order_cell_runs(xs_s, ys_s, order, ranks, block: int, rect):
    """Users in Morton order inside each cell run of a bucketing:
    ``(xs_s, ys_s, order)`` with the rows of every run permuted.

    ``xs_s, ys_s`` ``[n_sorted]`` f32, ``order`` ``[n_sorted]`` int64 and
    ``block`` as :func:`prepare_cell_buckets` returns them (``-1`` marks a
    padding row, and every run starts with its real users), ``ranks``
    ``[n_blocks]`` the run key of each user block, non-decreasing (the
    bucketing's ``cell_map`` or its rank among the occupied cells).
    Inside each run the real users are sorted stably by their Morton code
    on ``rect``, and every padding row takes the coordinates of its run's
    last real user, so that a block's bounding box is that of its users.
    Torch ops on the tensors' device, with no transfer to the host.  The
    order decides only how much work the grid kernel skips, never a count.
    """
    n_sorted = xs_s.shape[0]
    if n_sorted == 0:
        return xs_s, ys_s, order
    dev = xs_s.device
    xy = torch.stack([xs_s, ys_s])  # [2, n_sorted]
    lo = torch.tensor([[rect.xmin], [rect.ymin]], dtype=torch.float32, device=dev)
    hi = torch.tensor([[rect.xmax], [rect.ymax]], dtype=torch.float32, device=dev)
    real = order >= 0
    # key: (run, real users by code, then the padding rows in place)
    code = torch.where(real, morton_codes(xy, lo, hi).long(), 1 << 30)
    run = ranks.long().repeat_interleave(int(block))
    perm = torch.sort((run << 31) | code, stable=True).indices
    order_r = order.index_select(0, perm)
    rows = torch.arange(n_sorted, device=dev)
    last_real = torch.cummax(torch.where(order_r >= 0, rows, -1), dim=0).values
    xy_r = xy.index_select(1, perm.index_select(0, last_real))
    return xy_r[0].contiguous(), xy_r[1].contiguous(), order_r


def block_boxes(xs_s, ys_s, block: int) -> torch.Tensor:
    """``[n_blocks, 4]`` f32 ``(x_lo, y_lo, x_hi, y_hi)``: the bounding box
    of every row (padding included) of each user block, on the users'
    device."""
    if xs_s.shape[0] == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=xs_s.device)
    return tile_boxes(torch.stack([xs_s, ys_s]), int(block))


def unsort_index(order, n: int) -> torch.Tensor:
    """``[n]`` int64 on the order's device: the sorted row of each user,
    the inverse of ``order`` (``[n_sorted]``, numpy or torch, whose ``-1``
    entries are padding rows)."""
    order = torch.as_tensor(order).long()
    rows = torch.arange(order.shape[0], device=order.device)
    dest = torch.where(order >= 0, order, int(n))  # padding rows land past the end
    index = torch.empty(int(n) + 1, dtype=torch.int64, device=order.device)
    return index.scatter_(0, dest, rows)[: int(n)]


def unsort_cell_counts(counts: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Bucketed counts ``[..., Ns]`` back in user order ``[..., n]``, on the
    counts' device, the padding rows dropped.

    Every user has exactly one sorted row, so the JAX version's scatter by
    ``order`` is a gather by ``index = unsort_index(order, n)`` (on the
    counts' device; the grid backends keep it with their bucketing).
    """
    return counts.index_select(-1, index)


def _lib() -> ctypes.CDLL:
    lib = build.load("grid_raycast")
    fn = lib.grid_raycast_cells
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.grid_raycast_error_string.argtypes = [ctypes.c_int]
    lib.grid_raycast_error_string.restype = ctypes.c_char_p
    return lib


def grid_raycast_cells_batch(
    xs_sorted, ys_sorted, cell_map, planes, *, block: int, lens, boxes, base=None
):
    """Batched bucketed counting on the card: ``[Q, n_blocks*block]`` int32.

    ``xs_sorted, ys_sorted``: ``[n_blocks*block]`` f32 cell-sorted padded
    users (shared by the queries); ``cell_map``: ``[n_blocks]`` int32, each
    entry an index into the planes' cell axis; ``planes``:
    ``[Q, n_cells, 3, 3, L]`` f32.  Returns partial-list hit counts in
    sorted order.  ``lens``: ``[Q, n_cells]`` int32, the
    :func:`cell_list_lengths` of these planes (the kernel walks no lane
    past them: a shorter length gives wrong counts); ``boxes``:
    ``[n_blocks, 4]`` f32, the :func:`block_boxes` of these users (a box
    that misses a row gives it a wrong count).  ``base`` ``[Q, n_cells]``
    int32, if given, is added in the kernel (the JAX kernel leaves it to
    its caller).  All contiguous CUDA tensors on one device; launches on
    the current stream and does not synchronize; an empty ``Q`` or
    ``n_blocks`` launches nothing.
    """
    global batch_launches
    out, launched = _launch(xs_sorted, ys_sorted, cell_map, base, planes, lens, boxes, block)
    batch_launches += launched
    return out


def grid_raycast_cells(xs_sorted, ys_sorted, cell_map, base, planes, *, block: int, lens, boxes):
    """Bucketed grid hit counting for one query on the card, ``base`` added
    in the kernel: ``[n_blocks*block]`` int32 in sorted order.

    ``base`` and ``lens``: ``[n_cells]`` int32; ``planes``:
    ``[n_cells, 3, 3, L]`` f32; the rest as
    :func:`grid_raycast_cells_batch`.  The batched kernel at ``Q = 1``.
    """
    global single_launches
    if planes.ndim != 4 or base.ndim != 1 or lens.ndim != 1:
        raise ValueError(
            f"planes must be [n_cells, 3, 3, L], base and lens [n_cells], got "
            f"{tuple(planes.shape)}, {tuple(base.shape)}, {tuple(lens.shape)}"
        )
    out, launched = _launch(
        xs_sorted, ys_sorted, cell_map, base[None], planes[None], lens[None], boxes, block
    )
    single_launches += launched
    return out[0]


def _launch(xs, ys, cell_map, base, planes, lens, boxes, block: int) -> tuple[torch.Tensor, int]:
    """Check, allocate and launch; returns ``(out, 1 if launched else 0)``."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the grid ray-cast kernel needs CUDA tensors, got {dev}")
    checks = [("xs", xs, torch.float32), ("ys", ys, torch.float32),
              ("cell_map", cell_map, torch.int32), ("planes", planes, torch.float32),
              ("lens", lens, torch.int32), ("boxes", boxes, torch.float32)]
    if base is not None:
        checks.append(("base", base, torch.int32))
    for name, t, dtype in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
    block = int(block)
    nb = cell_map.shape[0]
    n_sorted = xs.shape[0]
    if block < 1 or cell_map.ndim != 1 or xs.ndim != 1 or ys.shape != xs.shape or n_sorted != nb * block:
        raise ValueError(
            f"xs, ys must be [n_blocks * block] = [{nb} * {block}], got "
            f"{tuple(xs.shape)}, {tuple(ys.shape)}"
        )
    if planes.ndim != 5 or planes.shape[2:4] != (3, 3):
        raise ValueError(f"planes must be [Q, n_cells, 3, 3, L], got {tuple(planes.shape)}")
    q_n, n_cells, _, _, lanes = planes.shape
    for name, t in (("base", base), ("lens", lens)):
        if t is not None and t.shape != (q_n, n_cells):
            raise ValueError(f"{name} must be [Q, n_cells] = [{q_n}, {n_cells}], got {tuple(t.shape)}")
    if boxes.shape != (nb, 4):
        raise ValueError(f"boxes must be [n_blocks, 4] = [{nb}, 4], got {tuple(boxes.shape)}")
    if q_n > _MAX_QUERIES or nb > _MAX_BLOCKS:
        raise ValueError(f"at most {_MAX_QUERIES} queries and {_MAX_BLOCKS} user blocks per launch")
    out = torch.empty((q_n, n_sorted), dtype=torch.int32, device=dev)
    if q_n == 0 or nb == 0:
        return out, 0
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.grid_raycast_cells(
            xs.data_ptr(), ys.data_ptr(), cell_map.data_ptr(),
            None if base is None else base.data_ptr(), planes.data_ptr(), lens.data_ptr(),
            boxes.data_ptr(), out.data_ptr(), nb, block, q_n, n_cells, lanes, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"grid_raycast_cells launch failed: {lib.grid_raycast_error_string(rc).decode()}"
        )
    return out, 1
