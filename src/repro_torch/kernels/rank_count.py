"""Launch the distance-rank count kernel (``csrc/rank_count.cu``).

Replaces the Pallas TPU kernel of ``repro/kernels/rank_count.py``
(``rank_count_kernel_call``).  Thresholds and the excluded facility are
prepared by :func:`repro_torch.kernels.ops.rank_count`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rank_count_kernel_call", "launches"]

#: Kernel launches since the last reset to 0 (one per launch, nowhere else).
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rank_count")
    fn = lib.rank_count
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rank_count_error_string.argtypes = [ctypes.c_int]
    lib.rank_count_error_string.restype = ctypes.c_char_p
    return lib


def rank_count_kernel_call(xs, ys, fx, fy, thr):
    """``[N]`` int32 rank counts on the card.

    ``xs, ys, thr``: ``[N]``; ``fx, fy``: ``[M]`` (facilities at +inf are
    never closer); all contiguous f32 CUDA tensors on one device.  Launches
    on the current stream and does not synchronize; ``N = 0`` launches
    nothing.
    """
    global launches
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the rank-count kernel needs CUDA tensors, got {dev}")
    n, m = xs.shape[0], fx.shape[0]
    for name, t, length in (("xs", xs, n), ("ys", ys, n), ("thr", thr, n),
                            ("fx", fx, m), ("fy", fy, m)):
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != (length,)):
            raise ValueError(f"{name} must be a contiguous float32 [{length}] on {dev}")
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rank_count(
            xs.data_ptr(), ys.data_ptr(), thr.data_ptr(), fx.data_ptr(),
            fy.data_ptr(), out.data_ptr(), n, m, stream,
        )
    launches += 1
    if rc != 0:
        raise RuntimeError(
            f"rank_count launch failed: {lib.rank_count_error_string(rc).decode()}"
        )
    return out
