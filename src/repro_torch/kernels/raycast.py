"""Launch the dense ray-cast count kernel (``csrc/raycast.cu``).

Replaces the Pallas TPU kernels of ``repro/kernels/raycast.py``
(``raycast_count_batch_kernel_call`` and ``raycast_count_kernel_call``):
one CUDA kernel with a query axis serves both, the single query being
``Q = 1``.  Padding and layout live in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

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
    fn = lib.raycast_count_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.raycast_error_string.argtypes = [ctypes.c_int]
    lib.raycast_error_string.restype = ctypes.c_char_p
    return lib


def raycast_count_batch_kernel_call(xs: torch.Tensor, ys: torch.Tensor, coeffs: torch.Tensor):
    """``[Q, N]`` int32 hit counts on the card.

    ``xs, ys``: ``[N]`` contiguous f32 CUDA tensors; ``coeffs``:
    ``[Q, Mp, 3, 3]`` contiguous f32 on the same device, padding rows
    degenerate (``a = b = 0, c = -1``).  Launches on the current stream
    and does not synchronize; an empty ``Q`` or ``N`` launches nothing.
    """
    global batch_launches
    out, launched = _launch(xs, ys, coeffs)
    batch_launches += launched
    return out


def raycast_count_kernel_call(xs: torch.Tensor, ys: torch.Tensor, coeffs: torch.Tensor):
    """``[N]`` int32 hit counts of one query, ``coeffs`` ``[Mp, 3, 3]``:
    the batched kernel at ``Q = 1``."""
    global single_launches
    if coeffs.ndim != 3:
        raise ValueError(f"coeffs must be [Mp, 3, 3], got {tuple(coeffs.shape)}")
    out, launched = _launch(xs, ys, coeffs[None])
    single_launches += launched
    return out[0]


def _launch(xs, ys, coeffs) -> tuple[torch.Tensor, int]:
    """Check, allocate and launch; returns ``(out, 1 if launched else 0)``."""
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
        return out, 0
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.raycast_count_batch(
            xs.data_ptr(), ys.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            n, q_n, mp, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"raycast_count_batch launch failed: {lib.raycast_error_string(rc).decode()}"
        )
    return out, 1
