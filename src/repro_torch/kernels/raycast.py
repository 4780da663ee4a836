"""Launch the dense ray-cast count kernel (``csrc/raycast.cu``).

Replaces the Pallas TPU kernels of ``repro/kernels/raycast.py``
(``raycast_count_batch_kernel_call`` and ``raycast_count_kernel_call``):
one CUDA kernel with a query axis serves both, the single query being
``Q = 1``.  The kernel reads the users in the spatial order of
:mod:`repro_torch.kernels.user_order`; a caller that has that order
(the engine keeps one per user set) passes it, else it is built here.
Padding and layout live in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.user_order import TILE_USERS, UserOrder, build_user_order, check_order

__all__ = [
    "raycast_count_batch_kernel_call",
    "raycast_count_kernel_call",
    "batch_launches",
    "single_launches",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else): the batched wrapper and the single-query wrapper.
batch_launches = 0
single_launches = 0

_MAX_QUERIES = 65_535  # gridDim.y


def _lib() -> ctypes.CDLL:
    lib = build.load("raycast")
    fn = lib.raycast_count_tiles
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.raycast_error_string.argtypes = [ctypes.c_int]
    lib.raycast_error_string.restype = ctypes.c_char_p
    return lib


def raycast_count_batch_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, coeffs: torch.Tensor, order: UserOrder | None = None
):
    """``[Q, N]`` int32 hit counts on the card, in the users' order.

    ``xs, ys``: ``[N]`` contiguous f32 CUDA tensors; ``coeffs``:
    ``[Q, Mp, 3, 3]`` contiguous f32 on the same device, padding rows
    degenerate (``a = b = 0, c = -1``).  ``order``: the
    :class:`~repro_torch.kernels.user_order.UserOrder` built from these
    very ``xs, ys`` (built here if ``None``; only its shapes are checked,
    and an order of other users gives wrong counts).  Launches on the current stream and does not
    synchronize; an empty ``Q`` or ``N`` launches nothing.
    """
    global batch_launches
    out, launched = _launch(xs, ys, coeffs, order)
    batch_launches += launched
    return out


def raycast_count_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, coeffs: torch.Tensor, order: UserOrder | None = None
):
    """``[N]`` int32 hit counts of one query, ``coeffs`` ``[Mp, 3, 3]``:
    the batched kernel at ``Q = 1``."""
    global single_launches
    if coeffs.ndim != 3:
        raise ValueError(f"coeffs must be [Mp, 3, 3], got {tuple(coeffs.shape)}")
    out, launched = _launch(xs, ys, coeffs[None], order)
    single_launches += launched
    return out[0]


def _launch(xs, ys, coeffs, order) -> tuple[torch.Tensor, int]:
    """The counts in the users' order, and 1 if the kernel was launched
    (else 0): the kernel's store in tile order, gathered back on the card."""
    out, order, launched = _launch_sorted(xs, ys, coeffs, order)
    return (out.index_select(1, order.unsort) if launched else out), launched


def _launch_sorted(xs, ys, coeffs, order) -> tuple[torch.Tensor, UserOrder | None, int]:
    """Check, allocate and launch: ``(out, order, 1 if launched else 0)``
    with ``out`` ``[Q, N]`` in the order's tile order (the order is built
    here if ``None``)."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the ray-cast kernel needs CUDA tensors, got {dev}")
    for name, t in (("xs", xs), ("ys", ys), ("coeffs", coeffs)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    n = xs.shape[0]
    if xs.ndim != 1 or ys.shape != (n,):
        raise ValueError(f"xs, ys must both be [N], got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if coeffs.ndim != 4 or coeffs.shape[2:] != (3, 3):
        raise ValueError(f"coeffs must be [Q, Mp, 3, 3], got {tuple(coeffs.shape)}")
    q_n, mp = coeffs.shape[:2]
    if q_n > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, got {q_n}")
    out = torch.empty((q_n, n), dtype=torch.int32, device=dev)
    if q_n == 0 or n == 0:
        return out, order, 0
    if order is None:
        order = build_user_order(xs, ys)
    check_order(order, n, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.raycast_count_tiles(
            order.xs_s.data_ptr(), order.ys_s.data_ptr(), order.boxes.data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), n, q_n, mp, TILE_USERS, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"raycast_count_tiles launch failed: {lib.raycast_error_string(rc).decode()}"
        )
    return out, order, 1

