"""Launch the fused AdamW kernels (``csrc/adamw.cu``).

:func:`adamw_fused` (row 10: float32 moments, replacing the jnp body of
``repro/optim/adamw.py`` ``adamw_update``) and :func:`adamw8bit_fused`
(row 11: block-wise int8 moments, replacing ``repro/optim/adamw8bit.py``
``adamw8bit_update``) update every leaf of a model in one launch, in
place.  The leaves on the CPU run the plain versions
(:func:`repro_torch.kernels.ref.adamw_ref`, ``adamw8bit_ref``); on the
card the kernel runs or the wrapper raises: a failed build or launch is
never caught, and leaves on more than one device raise ``ValueError``.

Each launch reads a table of the leaves' pointers and sizes that the
wrapper builds on the host, pins and copies to the card on the current
stream (a few bytes a leaf), so nothing synchronizes: ``lr``, the bias
corrections ``bc1 = 1 - b1^t``, ``bc2 = 1 - b2^t`` and the clip's
``scale`` are 0-d float32 tensors on the card, read by the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = ["adamw_fused", "adamw8bit_fused", "adamw_kernel_call", "adamw8bit_kernel_call",
           "adamw_launches", "adamw8bit_launches", "CHUNK_F32", "CHUNK_INT8"]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else).
adamw_launches = 0
adamw8bit_launches = 0

#: Elements of a block's chunk (the kernels' ``kChunkF32`` and
#: ``kChunkInt8``, checked against the library's own when it is loaded).
CHUNK_F32 = 8192
CHUNK_INT8 = 4096

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("adamw")
        scalars = [ctypes.c_float] * 6
        lib.adamw_f32.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                                  + [ctypes.c_void_p] * 4 + scalars + [ctypes.c_void_p])
        lib.adamw_f32.restype = ctypes.c_int
        lib.adamw_int8.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                                   + [ctypes.c_void_p] * 4 + scalars + [ctypes.c_float,
                                                                        ctypes.c_void_p])
        lib.adamw_int8.restype = ctypes.c_int
        lib.adamw_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.adamw_geometry.restype = None
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int(0) for _ in range(3)]
        lib.adamw_geometry(*(ctypes.byref(c) for c in got))
        if tuple(c.value for c in got) != (CHUNK_F32, CHUNK_INT8, _ref.QUANT_BLOCK):
            raise RuntimeError(f"the AdamW kernels' chunks and block are "
                               f"{tuple(c.value for c in got)}; the wrapper plans with "
                               f"{(CHUNK_F32, CHUNK_INT8, _ref.QUANT_BLOCK)}")
        _LIB = lib
    return _LIB


def _device(leaves: Sequence[torch.Tensor], step_tensors: Sequence[torch.Tensor]) -> torch.device:
    """The one device of every leaf and step tensor; ``ValueError`` if they
    lie on more than one."""
    devs = {t.device for t in leaves} | {t.device for t in step_tensors}
    if len(devs) != 1:
        raise ValueError(f"AdamW leaves lie on more than one device: {sorted(map(str, devs))}")
    return devs.pop()


def adamw_fused(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], lr, bc1, bc2, scale, *,
                b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """Row 10 in place over the leaves ``ps`` (float32) with their gradients
    ``gs`` and float32 moments ``ms``, ``vs`` (all of one shape a leaf):
    ``g * scale``, the moments, the bias corrections, the weight decay and
    ``p``.  On the CPU the plain version."""
    dev = _device([*ps, *gs, *ms, *vs], (lr, bc1, bc2, scale))
    if dev.type == "cpu":
        call = _ref.adamw_ref
    else:
        call = adamw_kernel_call
    call(ps, gs, ms, vs, lr, bc1, bc2, scale, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adamw8bit_fused(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    states: Sequence[Mapping[str, torch.Tensor]], lr, bc1, bc2, scale, *,
                    b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """Row 11 in place over the leaves ``ps`` with their gradients ``gs``
    and 8-bit moments ``states`` (``{"mq", "ms", "vq", "vs"}`` a leaf).  On
    the CPU the plain version."""
    dev = _device([*ps, *gs, *(t for s in states for t in s.values())], (lr, bc1, bc2, scale))
    if dev.type == "cpu":
        call = _ref.adamw8bit_ref
    else:
        call = adamw8bit_kernel_call
    call(ps, gs, states, lr, bc1, bc2, scale, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def _check(dev: torch.device, name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _step_tensors(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be a float32 scalar tensor on {dev}")


def _table(rows: list[list[int]], n: list[int], chunk: int, dev: torch.device):
    """The leaves' table on the card: each row's pointers, its size and its
    first chunk; and the chunks in all.  Leaves without elements own no
    chunk."""
    counts = np.array([-(-k // chunk) for k in n], dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    host = np.concatenate([np.array(rows, dtype=np.int64).reshape(len(n), -1),
                           np.array(n, dtype=np.int64)[:, None], first[:, None]], axis=1)
    table = torch.from_numpy(np.ascontiguousarray(host)).pin_memory().to(dev, non_blocking=True)
    return table, int(counts.sum())


def _launch(fn: str, table, n_leaves: int, n_chunks: int, dev, lr, bc1, bc2, scale,
            b1: float, b2: float, eps: float, weight_decay: float, *extra) -> None:
    """Launches ``fn`` of the library on the current stream; raises if the
    launch fails.  ``1 - b1`` and ``1 - b2`` are rounded to float32 from
    the Python numbers, as torch rounds ``(1 - b1) * g``'s scalar."""
    lib = _lib()
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(table.data_ptr(), n_leaves, n_chunks, lr.data_ptr(),
                              bc1.data_ptr(), bc2.data_ptr(), scale.data_ptr(), b1, 1 - b1, b2,
                              1 - b2, eps, weight_decay, *extra,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.adamw_error_string(rc).decode()}")


def adamw_kernel_call(ps, gs, ms, vs, lr, bc1, bc2, scale, *, b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """Row 10 on the card, one launch for every leaf.  Does not
    synchronize; no leaf with elements launches nothing."""
    global adamw_launches
    dev = ps[0].device if ps else lr.device
    if dev.type != "cuda":
        raise ValueError(f"the AdamW kernel needs CUDA tensors, got {dev}")
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError("ps, gs, ms and vs must have one entry a leaf")
    _step_tensors(dev, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    rows, n = [], []
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
            _check(dev, f"{name}[{i}]", t, tuple(p.shape), torch.float32)
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()])
        n.append(p.numel())
    if sum(n) == 0:
        return
    table, n_chunks = _table(rows, n, CHUNK_F32, dev)
    _launch("adamw_f32", table, len(n), n_chunks, dev, lr, bc1, bc2, scale,
            b1, b2, eps, weight_decay)
    adamw_launches += 1


def adamw8bit_kernel_call(ps, gs, states, lr, bc1, bc2, scale, *, b1: float, b2: float,
                          eps: float, weight_decay: float) -> None:
    """Row 11 on the card, one launch for every leaf.  Does not
    synchronize; no leaf with elements launches nothing."""
    global adamw8bit_launches
    dev = ps[0].device if ps else lr.device
    if dev.type != "cuda":
        raise ValueError(f"the 8-bit AdamW kernel needs CUDA tensors, got {dev}")
    if not len(ps) == len(gs) == len(states):
        raise ValueError("ps, gs and states must have one entry a leaf")
    _step_tensors(dev, lr=lr, bc1=bc1, bc2=bc2, scale=scale)
    rows, n = [], []
    for i, (p, g, s8) in enumerate(zip(ps, gs, states)):
        nb = -(-p.numel() // _ref.QUANT_BLOCK)
        _check(dev, f"p[{i}]", p, tuple(p.shape), torch.float32)
        _check(dev, f"g[{i}]", g, tuple(p.shape), torch.float32)
        for key in ("mq", "vq"):
            _check(dev, f"{key}[{i}]", s8[key], (nb, _ref.QUANT_BLOCK), torch.int8)
        for key in ("ms", "vs"):
            _check(dev, f"{key}[{i}]", s8[key], (nb,), torch.float32)
        rows.append([p.data_ptr(), g.data_ptr(), s8["mq"].data_ptr(), s8["ms"].data_ptr(),
                     s8["vq"].data_ptr(), s8["vs"].data_ptr()])
        n.append(p.numel())
    if sum(n) == 0:
        return
    table, n_chunks = _table(rows, n, CHUNK_INT8, dev)
    _launch("adamw_int8", table, len(n), n_chunks, dev, lr, bc1, bc2, scale,
            b1, b2, eps, weight_decay, _ref.SCALE_FLOOR)
    adamw8bit_launches += 1
