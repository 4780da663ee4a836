"""RG-LRU recurrent block (``repro.models.rglru``; Griffin / RecurrentGemma,
arXiv:2402.19427).

Two input branches, ``gate = GeLU(x W_g)`` and ``h = conv1d(x W_x)``, the
RG-LRU over ``h``, merged multiplicatively and projected out:

    r_t = σ(h_t W_a),  i_t = σ(h_t W_i)   (block-diagonal, float32)
    a_t = σ(Λ)^(c r_t),  c = 8
    y_t = a_t y_{t-1} + sqrt(1 - a_t²) (i_t h_t)

The gates are float32 products over the ``n_heads`` diagonal blocks
(``torch.einsum``, as the JAX package leaves them to XLA); the recurrence
is :func:`repro_torch.kernels.rglru.rglru_scan` (row 14: the CUDA kernel on
the card, on the CPU its plain version, which pairs terms as JAX's
``lax.associative_scan`` does).  Decode runs the same wrapper at ``S = 1``
from the cache's state.  The causal conv is computed in the compute dtype
in JAX's order of terms (the sum over the 4 taps, then ``+ b``), and
``jax.nn.gelu`` is the tanh approximation.  Weights are cast to the
activations' dtype at use, as JAX's ``astype``; the gates and Λ are used
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import rglru as krglru
from repro_torch.models.common import dense_init, param

__all__ = [
    "RGLRUBlock",
    "init_rglru_block",
    "rglru_block_forward",
    "rglru_block_decode",
    "init_rglru_cache",
    "lru_width",
]

CONV_WIDTH = 4  # the causal conv's taps (``conv_w [4, w]``)


def _n_blocks(cfg: ArchConfig) -> int:
    return max(1, cfg.n_heads)


def lru_width(cfg: ArchConfig) -> int:
    """The recurrence's width ``w`` (``lru_width``, else ``d_model``)."""
    return cfg.hybrid.lru_width or cfg.d_model


class RGLRUBlock(nn.Module):
    """Parameters under JAX's leaf names: ``w_gate_in``, ``w_x_in [d, w]``,
    ``conv_w [4, w]``, ``conv_b [w]``, ``w_a``, ``w_i [nb, w/nb, w/nb]``,
    ``lambda [w]`` (an attribute named by a keyword: reach it with
    :meth:`lam`), ``w_out [w, d]``."""

    def __init__(self, w_gate_in, w_x_in, conv_w, conv_b, w_a, w_i, lam, w_out):
        super().__init__()
        self.w_gate_in, self.w_x_in = param(w_gate_in), param(w_x_in)
        self.conv_w, self.conv_b = param(conv_w), param(conv_b)
        self.w_a, self.w_i = param(w_a), param(w_i)
        self.register_parameter("lambda", param(lam))
        self.w_out = param(w_out)

    def lam(self) -> torch.Tensor:
        return getattr(self, "lambda")


def init_rglru_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype | None = None) -> RGLRUBlock:
    """The JAX package's rules, drawn in float32 and cast once to ``dtype``:
    the products by the fan-in rule (``conv_w`` at std 0.5), ``conv_b``
    zero, ``lambda ~ U(2.2, 6.9)`` (``a = σ(Λ)`` in about (0.9, 0.999))."""
    d, w, nb = cfg.d_model, lru_width(cfg), _n_blocks(cfg)
    bs = w // nb
    dev = generator.device

    def draw(shape, scale=None):
        return dense_init(shape, generator, scale=scale, dtype=dtype)

    w_gate_in, w_x_in = draw((d, w)), draw((d, w))
    conv_w = draw((CONV_WIDTH, w), scale=0.5)
    w_a = draw((nb, bs, bs))
    lam = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(2.2, 6.9,
                                                                       generator=generator)
    w_i, w_out = draw((nb, bs, bs)), draw((w, d))
    dt = dtype or w_a.dtype
    return RGLRUBlock(w_gate_in, w_x_in, conv_w,
                      torch.zeros((w,), dtype=dt, device=dev), w_a, w_i, lam.to(dt), w_out)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x [B, S, w]`` through the causal conv of ``w [W, w]`` and ``b [w]``
    in ``x``'s dtype: ``sum_i pad(x)[:, i:i+S] * w[i]``, then ``+ b``."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
    return out + b[None, None, :].to(x.dtype)


def _gates(p: RGLRUBlock, h: torch.Tensor, nb: int):
    """Block-diagonal gate projections in float32: ``h [..., w]`` -> ``(r,
    i)`` float32 ``[..., w]``."""
    shp = h.shape
    hb = h.reshape(*shp[:-1], nb, shp[-1] // nb).float()
    r = torch.sigmoid(torch.einsum("...nb,nbc->...nc", hb, p.w_a.float()))
    i = torch.sigmoid(torch.einsum("...nb,nbc->...nc", hb, p.w_i.float()))
    return r.reshape(shp), i.reshape(shp)


def rglru_block_forward(p: RGLRUBlock, x: torch.Tensor, cfg: ArchConfig, init_state=None):
    """``x [B, S, d]`` -> ``(out [B, S, d], final state [B, w] f32, hx)``:
    ``hx = x W_x`` (before the conv) is what a prefill keeps the last 3 of."""
    nb = _n_blocks(cfg)
    gate = F.gelu(x @ p.w_gate_in.to(x.dtype), approximate="tanh")
    hx = x @ p.w_x_in.to(x.dtype)
    h = _causal_conv(hx, p.conv_w, p.conv_b)
    r, i = _gates(p, h, nb)
    y, state = krglru.rglru_scan(r, i, h.contiguous(), p.lam().float(), init_state)
    out = (y.to(x.dtype) * gate) @ p.w_out.to(x.dtype)
    return out, state, hx


def init_rglru_cache(cfg: ArchConfig, batch, dtype=torch.float32, device=None,
                     rows: int = CONV_WIDTH - 1) -> dict:
    """``{"conv": [*lead, rows, w] in dtype (float32 and 3 rows by default,
    as JAX's; a prefill keeps ``min(3, S)`` rows in the compute dtype),
    "state": [*lead, w] float32}``, zeros.  ``batch`` is an int or the
    leading dims (a decoder's ``(repeat, batch)``)."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    w = lru_width(cfg)
    return {"conv": torch.zeros((*lead, rows, w), dtype=dtype, device=device),
            "state": torch.zeros((*lead, w), dtype=torch.float32, device=device)}


def rglru_block_decode(p: RGLRUBlock, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token, ``x [B, 1, d]`` -> ``(out [B, 1, d], {"conv", "state"})``
    (new tensors; the caller writes them where it keeps the cache).  The
    conv's window is the cache's 3 inputs and this one, in their common
    dtype (float32 where the cache is, as JAX promotes)."""
    nb = _n_blocks(cfg)
    xt = x[:, 0]
    gate = F.gelu(xt @ p.w_gate_in.to(x.dtype), approximate="tanh")
    hx = xt @ p.w_x_in.to(x.dtype)  # [B, w]
    ct = torch.promote_types(cache["conv"].dtype, hx.dtype)
    conv_in = torch.cat([cache["conv"].to(ct), hx[:, None, :].to(ct)], dim=1)  # [B, 4, w]
    w = p.conv_w.to(x.dtype).to(ct)
    h = torch.einsum("bwc,wc->bc", conv_in, w) + p.conv_b.to(x.dtype).to(ct)
    r, i = _gates(p, h, nb)
    y, state = krglru.rglru_scan(r[:, None], i[:, None], h[:, None].contiguous(),
                                 p.lam().float(), cache["state"])
    out = (state.to(x.dtype) * gate) @ p.w_out.to(x.dtype)
    return out[:, None, :], {"conv": conv_in[:, 1:, :], "state": state}
