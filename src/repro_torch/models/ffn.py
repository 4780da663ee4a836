"""Dense feed-forward layers (``repro.models.ffn``): the GLU variants
``swiglu`` and ``geglu`` and the plain ``gelu`` and ``relu2`` (squared
ReLU), with the JAX package's parameter names ``w_in``, ``w_gate``,
``w_out``.  Each weight is cast to the input's dtype at use, which is
free for serving weights already held in the compute dtype.  The MoE
layer waits for a later slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import activation, dense_init, param

__all__ = ["DenseFFN", "init_dense_ffn", "dense_ffn", "init_moe", "moe_ffn"]

_ACTS = ("swiglu", "geglu", "gelu", "relu2")


class DenseFFN(nn.Module):
    """Parameters of one dense FFN: ``w_in [d, ff]``, ``w_out [ff, d]`` and,
    for the GLU variants, ``w_gate [d, ff]``."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor,
                 w_gate: torch.Tensor | None = None):
        super().__init__()
        self.w_in = param(w_in)
        self.w_out = param(w_out)
        self.w_gate = None if w_gate is None else param(w_gate)


def init_dense_ffn(generator: torch.Generator, d_model: int, d_ff: int, act: str,
                   dtype: torch.dtype | None = None) -> DenseFFN:
    """The JAX package's draw order: ``w_in``, ``w_out``, then ``w_gate``."""
    if act not in _ACTS:
        raise ValueError(f"unknown ffn_act {act!r}")
    w_in = dense_init((d_model, d_ff), generator, dtype=dtype)
    w_out = dense_init((d_ff, d_model), generator, dtype=dtype)
    w_gate = dense_init((d_model, d_ff), generator, dtype=dtype) if act in ("swiglu", "geglu") else None
    return DenseFFN(w_in, w_out, w_gate)


def dense_ffn(params: DenseFFN, x: torch.Tensor, act: str) -> torch.Tensor:
    """``x [..., d]`` -> ``[..., d]`` in ``x``'s dtype."""
    h = x @ params.w_in.to(x.dtype)
    if act in ("swiglu", "geglu"):
        g = x @ params.w_gate.to(x.dtype)
        h = h * (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh"))
    else:
        h = activation(act, h)
    return h @ params.w_out.to(x.dtype)


def init_moe(*args, **kwargs):
    raise NotImplementedError(
        "the MoE FFN is not ported yet: ROADMAP queue 1, LM item 3 (deepseek, dbrx)")


def moe_ffn(*args, **kwargs):
    raise NotImplementedError(
        "the MoE FFN is not ported yet: ROADMAP queue 1, LM item 3 (deepseek, dbrx)")
