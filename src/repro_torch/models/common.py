"""Shared building blocks of the LM substrate (``repro.models.common``).

Plain PyTorch functions on tensors: the dtype policy, the init rule,
norms, activations, RoPE and the embedding lookup.  Each repeats the JAX
package's arithmetic and order of casts, so the parity tests can hold
the port's decoder against the JAX decoder leaf for leaf:

* the norms compute in float32 and scale by ``1 + weight`` (the weights
  start at zero), then cast back to the input's dtype;
* RoPE rotates split halves (``x[..., :D/2]``, ``x[..., D/2:]``), not
  interleaved pairs, over per-row positions ``[B, S]``, in float32;
* the embedding lookup returns the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Policy",
    "param",
    "dense_init",
    "rmsnorm",
    "layernorm",
    "norm_apply",
    "activation",
    "rope_freqs",
    "apply_rope",
    "rope_tables",
    "rotate",
    "take_embedding",
]


class Policy:
    """Mixed-precision policy: float32 master parameters, bfloat16 compute.

    Read at call time, so a test may set ``compute_dtype`` to float32 (as
    it sets the JAX package's) and run both packages in float32."""

    param_dtype = torch.float32
    compute_dtype = torch.bfloat16


def param(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter: trainable when it is held in
    ``Policy.param_dtype`` (float32 master parameters), frozen otherwise
    (serving weights in the compute dtype)."""
    return nn.Parameter(t, requires_grad=t.dtype == Policy.param_dtype)


def dense_init(shape, generator: torch.Generator, scale: float | None = None,
               dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """Truncated normal at ±2σ with the fan-in rule of the JAX package:
    ``std = scale`` or ``shape[-2] ** -0.5`` (``shape[-1]`` for a vector).

    Drawn in float32 from ``generator`` (whose device it lives on unless
    ``device`` says otherwise), then cast once to ``dtype`` (default
    ``Policy.param_dtype``).  The numbers differ from ``jax.random``'s for
    the same seed; the law and the std are the same."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    dev = generator.device if device is None else device
    w = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    w.mul_(std)
    return w.to(dtype or Policy.param_dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * (1.0 + weight.float())
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def norm_apply(kind: str, x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, scale, bias)
    return rmsnorm(x, scale)


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default."""
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":  # squared ReLU (Primer / Nemotron-4)
        r = F.relu(x)
        return r * r
    if kind == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {kind!r}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings: ``[head_dim // 2]`` f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` ``[B, S, 1, head_dim/2]`` f32 of ``positions [B, S]``:
    what :func:`apply_rope` rotates by, for a caller that rotates many
    tensors at the same positions."""
    inv = rope_freqs(head_dim, theta, device=positions.device)  # [D/2]
    ang = positions.float()[..., None] * inv  # [B, S, D/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by :func:`rope_tables`: split halves, in
    float32, cast back to ``x``'s dtype."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by per-token ``positions [B, S]`` (int)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def take_embedding(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup, compute-dtype output."""
    return embed[tokens].to(Policy.compute_dtype)
