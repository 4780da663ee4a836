"""Launch row 12, the MoE FFN's routed experts (``csrc/moe.cu``).

:func:`moe_expert_mlp` replaces the jnp ``_expert_mlp`` of
``repro/models/ffn.py`` ``moe_ffn`` (not a Pallas site).  Its rows are the
kept (token, choice) pairs laid out by (group, expert, position):
``xc [R, d]``, each (group, expert)'s run from ``offsets[g*E + e]`` to
``offsets[g*E + e + 1]`` (``offsets [n_groups*E + 1]`` int32 on the
device, at most ``rows_bound`` rows a run).  Rows past the last run are
neither read nor written.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.moe_expert_mlp_ref`); a CUDA tensor
launches the two kernels (gate/up with the activation, then down) on the
current stream or raises: a failed build or launch is never caught.  The
kernels take contiguous bf16 rows and weights, 16-byte aligned, ``d`` a
multiple of 128 and ``f`` of 64; anything else on the card raises
``ValueError``.  Nothing is read back to the host: the grid is sized from
``rows_bound``, and a block whose tile lies past its run returns at once.

On the card no input may require grad: the backward of row 12 (MoE
training) is ROADMAP queue 1, LM item 7, and nothing falls back to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = ["moe_expert_mlp", "moe_expert_mlp_kernel_call", "moe_launches", "MOE_ACTS",
           "MOE_ROW_TILE", "MOE_UP_COLS", "MOE_DOWN_COLS", "MOE_DEPTH"]

#: Launches of the two kernels since the last reset to 0 (one per launch,
#: nowhere else: two a call).
moe_launches = 0

#: The activations and their codes in the kernel (``csrc/moe.cu`` ``Act``).
MOE_ACTS = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu2": 3}
#: The kernels' tiles (``kRows``, ``kUpCols``, ``kDownCols``, ``kDepth``),
#: checked against the library's own when it is loaded: rows of a block,
#: columns of the gate/up and of the down kernel, depth of a stage.
MOE_ROW_TILE = 64
MOE_UP_COLS = 64
MOE_DOWN_COLS = 128
MOE_DEPTH = 32

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("moe")
        lib.moe_up.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.moe_up.restype = ctypes.c_int
        lib.moe_down.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.moe_down.restype = ctypes.c_int
        lib.moe_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.moe_geometry.restype = None
        lib.moe_error_string.argtypes = [ctypes.c_int]
        lib.moe_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int(0) for _ in range(4)]
        lib.moe_geometry(*(ctypes.byref(c) for c in got))
        want = (MOE_ROW_TILE, MOE_UP_COLS, MOE_DOWN_COLS, MOE_DEPTH)
        if tuple(c.value for c in got) != want:
            raise RuntimeError(f"the MoE kernels' tiles are {tuple(c.value for c in got)}; "
                               f"the wrapper checks shapes against {want}")
        _LIB = lib
    return _LIB


def moe_expert_mlp(xc: torch.Tensor, offsets: torch.Tensor, rows_bound: int,
                   w_in: torch.Tensor, w_gate: torch.Tensor | None, w_out: torch.Tensor,
                   act: str) -> torch.Tensor:
    """Each (group, expert)'s rows of ``xc [R, d]`` through expert ``e``'s
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
    if d % MOE_DOWN_COLS or f % MOE_UP_COLS:
        raise ValueError(f"the MoE kernels take d a multiple of {MOE_DOWN_COLS} and f of "
                         f"{MOE_UP_COLS}, got d={d}, f={f}")
    n_runs = offsets.numel() - 1
    if (offsets.device != dev or offsets.dtype != torch.int32 or offsets.ndim != 1
            or not offsets.is_contiguous() or n_runs < 1 or n_runs % E):
        raise ValueError(f"offsets must be contiguous int32 [n_groups * {E} + 1] on {dev}")
    if not 0 <= rows_bound <= R:
        raise ValueError(f"rows_bound {rows_bound} outside [0, {R}]")
    y = torch.empty((R, d), dtype=torch.bfloat16, device=dev)
    if R == 0 or rows_bound == 0:
        return y
    h = torch.empty((R, f), dtype=torch.bfloat16, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.moe_up(xc.data_ptr(), offsets.data_ptr(), w_in.data_ptr(),
                        w_gate.data_ptr() if glu else None, h.data_ptr(), d, f, E, n_runs // E,
                        rows_bound, MOE_ACTS[act], stream)
        if rc != 0:
            raise RuntimeError(f"moe_up launch failed: {lib.moe_error_string(rc).decode()}")
        moe_launches += 1
        rc = lib.moe_down(h.data_ptr(), offsets.data_ptr(), w_out.data_ptr(), y.data_ptr(), f,
                          d, E, n_runs // E, rows_bound, stream)
        if rc != 0:
            raise RuntimeError(f"moe_down launch failed: {lib.moe_error_string(rc).decode()}")
        moe_launches += 1
    return y
