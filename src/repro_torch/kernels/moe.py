"""Launch row 12, the MoE FFN's routed experts (``csrc/moe.cu``).

:func:`moe_expert_mlp` replaces the jnp ``_expert_mlp`` of
``repro/models/ffn.py`` ``moe_ffn`` (not a Pallas site).  Its rows are the
kept (token, choice) pairs laid out by (expert, group, position):
``xc [R, d]``, each (expert, group)'s run from ``offsets[e*n + g]`` to
``offsets[e*n + g + 1]`` (``offsets [E*n + 1]`` int32 on the device, at
most ``rows_bound`` rows a run), so each expert's rows from every group
are one stretch.  Rows past an expert's stretch may be read (a row tile
is one TMA box) but are never written.  A CPU tensor runs the plain
version (:func:`repro_torch.kernels.ref.moe_expert_mlp_ref`); a CUDA
tensor launches the two kernels (gate/up with the activation, then down)
on the current stream or raises: a failed build or launch is never
caught.  The kernels take contiguous bf16 rows and weights, 16-byte
aligned, ``d`` and ``f`` multiples of 64, and at most ``MOE_MAX_EXPERTS``
experts; anything else on the card raises ``ValueError``.  Nothing is read
back to the host: the persistent grid is sized from the SMs and
``rows_bound``, and each block walks only the row tiles the experts hold,
so an empty expert loads no weight.  The geometry follows ``rows_bound``
alone (wide tiles above ``MOE_NARROW_MAX_BOUND``, narrow ones at decode);
every output element is one f32 sum over k in the same order in both, with
no atomics, so a call gives the same result every time.

On the card no input may require grad: the backward of row 12 (MoE
training) is ROADMAP queue 1, LM item 7, and nothing falls back to the
plain version.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = ["moe_expert_mlp", "moe_expert_mlp_kernel_call", "moe_launches", "MOE_ACTS",
           "MOE_GEOMETRY", "MOE_DEPTH", "MOE_NARROW_MAX_BOUND", "MOE_MAX_EXPERTS"]

#: Launches of the two kernels since the last reset to 0 (one per launch,
#: nowhere else: two a call).
moe_launches = 0

#: The activations and their codes in the kernel (``csrc/moe.cu`` ``Act``).
MOE_ACTS = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu2": 3}
#: The kernels' geometry (``csrc/moe.cu`` ``moe_geometry``), checked
#: against the library's own when it is loaded: rows of a wide and of a
#: narrow tile, columns (of each weight) of a wide gate/up and down item and
#: of a narrow one, the depth of a stage, the largest bound that runs
#: narrow, the most experts.
MOE_GEOMETRY = {"wide_rows": 128, "narrow_rows": 64, "wide_up_cols": 128, "wide_down_cols": 256,
                "narrow_up_cols": 64, "narrow_down_cols": 128, "depth": 64,
                "narrow_max_bound": 64, "max_experts": 8192}
MOE_DEPTH = MOE_GEOMETRY["depth"]
MOE_NARROW_MAX_BOUND = MOE_GEOMETRY["narrow_max_bound"]
MOE_MAX_EXPERTS = MOE_GEOMETRY["max_experts"]

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("moe")
        lib.moe_mlp.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.moe_mlp.restype = ctypes.c_int
        lib.moe_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.moe_geometry.restype = None
        lib.moe_error_string.argtypes = [ctypes.c_int]
        lib.moe_error_string.restype = ctypes.c_char_p
        got = (ctypes.c_int * len(MOE_GEOMETRY))()
        lib.moe_geometry(got)
        want = tuple(MOE_GEOMETRY.values())
        if tuple(got) != want:
            raise RuntimeError(f"the MoE kernels' geometry is {tuple(got)}; the wrapper "
                               f"checks shapes against {want} ({', '.join(MOE_GEOMETRY)})")
        _LIB = lib
    return _LIB


def moe_expert_mlp(xc: torch.Tensor, offsets: torch.Tensor, rows_bound: int,
                   w_in: torch.Tensor, w_gate: torch.Tensor | None, w_out: torch.Tensor,
                   act: str) -> torch.Tensor:
    """Each (expert, group)'s rows of ``xc [R, d]`` through expert ``e``'s
    MLP (``w_in``/``w_gate [E, d, f]``, ``w_out [E, f, d]``; ``w_gate``
    None for ``gelu``/``relu2``) -> ``[R, d]`` in ``xc``'s dtype.  On the
    CPU the plain version."""
    if xc.device.type == "cpu":
        return _ref.moe_expert_mlp_ref(xc, offsets, rows_bound, w_in, w_gate, w_out, act)
    return moe_expert_mlp_kernel_call(xc, offsets, rows_bound, w_in, w_gate, w_out, act)


def _check_bf16(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on {dev}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def moe_expert_mlp_kernel_call(xc, offsets, rows_bound: int, w_in, w_gate, w_out,
                               act: str) -> torch.Tensor:
    """Row 12 on the card: ``[R, d]`` bf16.  Does not synchronize."""
    global moe_launches
    dev = xc.device
    if dev.type != "cuda":
        raise ValueError(f"the MoE expert kernels need CUDA tensors, got {dev}")
    if act not in MOE_ACTS:
        raise ValueError(f"unknown ffn_act {act!r}")
    glu = act in ("swiglu", "geglu")
    if glu != (w_gate is not None):
        raise ValueError(f"{act} takes {'a' if glu else 'no'} w_gate")
    weights = {"w_in": w_in, "w_out": w_out, **({"w_gate": w_gate} if glu else {})}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xc, *weights.values())):
        raise NotImplementedError(
            "row 12 has no backward yet: MoE training is ROADMAP queue 1, LM item 7")
    _check_bf16(dev, xc=xc, **weights)
    if xc.ndim != 2 or w_in.ndim != 3:
        raise ValueError(f"xc must be [R, d] and w_in [E, d, f], got {tuple(xc.shape)}, "
                         f"{tuple(w_in.shape)}")
    R, d = xc.shape
    E, _, f = w_in.shape
    if (w_in.shape != (E, d, f) or w_out.shape != (E, f, d)
            or (glu and w_gate.shape != w_in.shape)):
        raise ValueError(f"the weights must be [{E}, {d}, f] and [{E}, f, {d}], got "
                         f"{ {n: tuple(t.shape) for n, t in weights.items()} }")
    if d % MOE_DEPTH or f % MOE_DEPTH:
        raise ValueError(f"the MoE kernels take d and f multiples of {MOE_DEPTH}, got d={d}, "
                         f"f={f}")
    n_runs = offsets.numel() - 1
    if (offsets.device != dev or offsets.dtype != torch.int32 or offsets.ndim != 1
            or not offsets.is_contiguous() or n_runs < 1 or n_runs % E):
        raise ValueError(f"offsets must be contiguous int32 [{E} * n_groups + 1] on {dev}")
    if E > MOE_MAX_EXPERTS:
        raise ValueError(f"the MoE kernels take at most {MOE_MAX_EXPERTS} experts, got {E}")
    if not 0 <= rows_bound <= R:
        raise ValueError(f"rows_bound {rows_bound} outside [0, {R}]")
    y = xc.new_empty((R, d))
    if R == 0 or rows_bound == 0:
        return y
    h = xc.new_empty((R, f))
    lib = _lib()
    # the raw handle of the current stream, without building a Stream object
    # (a few microseconds a call: decode is bound by the host's launches)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    launched = ctypes.c_int(0)
    same = torch.cuda.current_device() == dev.index
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        # one call launches both kernels (gate/up, then down)
        rc = lib.moe_mlp(xc.data_ptr(), offsets.data_ptr(), w_in.data_ptr(),
                         w_gate.data_ptr() if glu else None, w_out.data_ptr(), h.data_ptr(),
                         y.data_ptr(), R, d, f, E, n_runs // E, rows_bound, MOE_ACTS[act],
                         stream, ctypes.byref(launched))
    moe_launches += launched.value
    if rc != 0:
        step = ("moe_up", "moe_down")[launched.value]
        raise RuntimeError(f"{step} launch failed: {lib.moe_error_string(rc).decode()}")
    return y
