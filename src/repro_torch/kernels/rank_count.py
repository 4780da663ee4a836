"""Launch the distance-rank count kernel (``csrc/rank_count.cu``).

Replaces the Pallas TPU kernel of ``repro/kernels/rank_count.py``
(``rank_count_kernel_call``), and with its query axis serves the batched
count of :func:`repro_torch.kernels.ops.rank_count_batch` too.  The kernel
computes each user's threshold ``d^2(u, q)`` itself and reads the users
in the spatial order of :mod:`repro_torch.kernels.user_order`; a caller
that has that order (the engine keeps one per user set) passes it, else
it is built here.  Any order of the users gives the same counts: the
order decides only how much work the kernel's classes skip.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.user_order import TILE_USERS, UserOrder, build_user_order, check_order

__all__ = [
    "rank_count_batch_kernel_call",
    "rank_count_kernel_call",
    "batch_launches",
    "launches",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else): the single-query wrapper and the batched wrapper.
launches = 0
batch_launches = 0

_MAX_QUERIES = 65_535  # gridDim.y
#: Blocks a launch should have for each SM before the facilities are split
#: (``csrc/rank_count.cu``, "Facility splits"): with fewer (tile, query)
#: blocks the few warps whose boxes straddle a jump of the Morton curve
#: would hold the launch.
_BLOCKS_PER_SM = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("rank_count")
    fn = lib.rank_count_tiles
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.rank_count_error_string.argtypes = [ctypes.c_int]
    lib.rank_count_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def facilities_per_split(n_blocks: int, m: int, dev: torch.device) -> int:
    """Facilities each block walks: all ``m`` (rounded up to a warp) when
    the ``n_blocks`` (tile, query) blocks fill ``_BLOCKS_PER_SM`` blocks on
    each SM of ``dev``, else ``m`` cut into as many runs as make up the
    difference."""
    want = -(-_BLOCKS_PER_SM * _sm_count(dev) // max(n_blocks, 1))
    per_split = -(-m // max(1, min(want, -(-m // 32))))  # ceil(m / splits)
    return 32 * max(1, -(-per_split // 32))


def rank_count_batch_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, fxy: torch.Tensor, q_pts: torch.Tensor,
    excl: torch.Tensor, order: UserOrder | None = None,
) -> torch.Tensor:
    """``[Q, N]`` int32 rank counts on the card, in the users' order.

    ``xs, ys``: ``[N]`` f32 users; ``fxy``: ``[M, 2]`` f32 facilities;
    ``q_pts``: ``[Q, 2]`` f32 query points; ``excl``: ``[Q]`` int32, the
    facility row each query leaves out (``< 0``: none).  All CUDA tensors
    on one device, all but ``xs, ys`` contiguous (the kernel reads the
    order's copies of them).  ``order``: the
    :class:`~repro_torch.kernels.user_order.UserOrder` built from these
    very ``xs, ys`` (built here if ``None``; only its shapes are checked,
    and an order of other users gives wrong counts).  Launches on the
    current stream and does not synchronize; an empty ``Q`` or ``N``
    launches nothing.
    """
    global batch_launches
    out, launched = _launch(xs, ys, fxy, q_pts, excl, order)
    batch_launches += launched
    return out


def rank_count_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, fxy: torch.Tensor, q: torch.Tensor,
    excl: torch.Tensor, order: UserOrder | None = None,
) -> torch.Tensor:
    """``[N]`` int32 rank counts of one query point ``q`` (``[2]``) with
    ``excl`` ``[1]``: the batched kernel at ``Q = 1``."""
    global launches
    out, launched = _launch(xs, ys, fxy, q[None], excl, order)
    launches += launched
    return out[0]


def _launch(xs, ys, fxy, q_pts, excl, order, per_split: int | None = None):
    """Check, allocate and launch: ``(out, 1 if launched else 0)``, ``out``
    ``[Q, N]`` in the users' order (the kernel stores through the order's
    permutation).  ``per_split``: facilities a block walks (a multiple of
    32), by default :func:`facilities_per_split`'s choice."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the rank-count kernel needs CUDA tensors, got {dev}")
    for name, t in (("xs", xs), ("ys", ys), ("fxy", fxy), ("q_pts", q_pts)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
    for name, t in (("fxy", fxy), ("q_pts", q_pts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = xs.shape[0]
    if xs.ndim != 1 or ys.shape != (n,):
        raise ValueError(f"xs, ys must both be [N], got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if fxy.ndim != 2 or fxy.shape[1] != 2:
        raise ValueError(f"fxy must be [M, 2], got {tuple(fxy.shape)}")
    if q_pts.ndim != 2 or q_pts.shape[1] != 2:
        raise ValueError(f"q_pts must be [Q, 2], got {tuple(q_pts.shape)}")
    q_n, m = q_pts.shape[0], fxy.shape[0]
    if (excl.device != dev or excl.dtype != torch.int32 or excl.shape != (q_n,)
            or not excl.is_contiguous()):
        raise ValueError(f"excl must be contiguous int32 [{q_n}] on {dev}")
    if q_n > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, got {q_n}")
    if q_n == 0 or n == 0:
        return torch.empty((q_n, n), dtype=torch.int32, device=dev), 0
    if order is None:
        order = build_user_order(xs, ys)
    check_order(order, n, dev)
    if per_split is None:
        per_split = facilities_per_split(-(-n // TILE_USERS) * q_n, m, dev)
    split = m > per_split  # several blocks add into each count
    out = (torch.zeros if split else torch.empty)((q_n, n), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rank_count_tiles(
            order.xs_s.data_ptr(), order.ys_s.data_ptr(), order.perm.data_ptr(), fxy.data_ptr(),
            q_pts.data_ptr(), excl.data_ptr(), out.data_ptr(), n, m, q_n, per_split, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"rank_count_tiles launch failed: {lib.rank_count_error_string(rc).decode()}"
        )
    return out, 1
