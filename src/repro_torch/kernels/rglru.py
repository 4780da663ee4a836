"""Launch row 14, the RG-LRU's linear recurrence (``csrc/rglru.cu``).

:func:`rglru_scan` replaces the jnp ``_rglru_scan`` of
``repro/models/rglru.py`` after its gates (an elementwise prologue and a
``lax.associative_scan``; not a Pallas site), and the same terms of
``rglru_block_decode``, which calls it at ``S = 1`` with the cache's
state.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.rglru_scan_ref`); a CUDA tensor launches
the kernel on the current stream or raises: a failed build or launch is
never caught.  The kernel takes contiguous float32 gates ``r``, ``i``
``[B, S, w]``, ``h`` bf16 or float32 of the same shape, ``lam`` float32
``[w]`` and ``init_state`` None or float32 ``[B, w]``; anything else on the
card raises ``ValueError``.

The kernel walks ``t`` in order (``y_t = a_t y_{t-1} + x_t``, one thread
a (row, channel)), where the plain version and JAX pair terms in a log-depth
tree: the two round apart by a few float32 ulps of ``y``.

On the card no input may require grad: the recurrence's backward (hybrid
training) is ROADMAP queue 1, LM item 9, and nothing falls back to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = ["rglru_scan", "rglru_scan_kernel_call", "launches"]

#: Launches since the last reset to 0 (one per launch, nowhere else).
launches = 0

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("rglru")
        lib.rglru_scan.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def rglru_scan(r: torch.Tensor, i: torch.Tensor, h: torch.Tensor, lam: torch.Tensor,
               init_state: torch.Tensor | None = None):
    """``(y [B, S, w] f32, final state [B, w] f32)`` of the RG-LRU over the
    gates ``r``, ``i`` and the conv output ``h``, from ``init_state`` (zero
    when None).  On the CPU the plain version."""
    if r.device.type == "cpu":
        return _ref.rglru_scan_ref(r, i, h, lam, init_state)
    return rglru_scan_kernel_call(r, i, h, lam, init_state)


def rglru_scan_kernel_call(r, i, h, lam, init_state=None):
    """Row 14 on the card.  Does not synchronize."""
    global launches
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"the RG-LRU kernel needs CUDA tensors, got {dev}")
    inputs = {"r": r, "i": i, "h": h, "lam": lam,
              **({} if init_state is None else {"init_state": init_state})}
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs.values()):
        raise NotImplementedError(
            "row 14 has no backward yet: hybrid training is ROADMAP queue 1, LM item 9")
    if r.ndim != 3:
        raise ValueError(f"r must be [B, S, w], got {tuple(r.shape)}")
    B, S, w = r.shape
    want = {"r": (torch.float32, (B, S, w)), "i": (torch.float32, (B, S, w)),
            "h": (h.dtype, (B, S, w)), "lam": (torch.float32, (w,)),
            "init_state": (torch.float32, (B, w))}
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"h must be bfloat16 or float32, got {h.dtype}")
    for name, t in inputs.items():
        dtype, shape = want[name]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)} on {dev}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((B, S, w), dtype=torch.float32, device=dev)
    state = torch.empty((B, w), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_() if init_state is None else state.copy_(init_state)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rglru_scan(r.data_ptr(), i.data_ptr(), h.data_ptr(),
                            int(h.dtype == torch.float32), lam.data_ptr(),
                            None if init_state is None else init_state.data_ptr(),
                            y.data_ptr(), state.data_ptr(), B, S, w,
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: {lib.rglru_error_string(rc).decode()}")
    launches += 1
    return y, state
