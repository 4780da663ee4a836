"""Feed-forward layers (``repro.models.ffn``): dense and MoE.

The dense FFN has the GLU variants ``swiglu`` and ``geglu`` and the plain
``gelu`` and ``relu2`` (squared ReLU), with the JAX package's parameter
names ``w_in``, ``w_gate``, ``w_out``.  Each weight is cast to the
input's dtype at use, which is free for serving weights already held in
the compute dtype.

The MoE FFN (:func:`moe_ffn`) routes as the JAX function does: tokens in
groups of ``group_size`` (the last padded with zero rows, which are
routed too and enter the aux loss), router logits in the input's dtype
then float32, softmax, the top ``k`` by a stable descending sort (the
lower expert first on ties, as ``jax.lax.top_k``), ``router_norm_topk``,
each (token, choice) pair's position in its expert's queue by a cumsum in
(token, choice) order, and ``keep`` where the position is under the
capacity.  Instead of JAX's ``[n, g, E, C]`` one-hot dispatch or its
capacity-padded gather, the kept pairs are laid out compactly in (expert,
group, position) order (a stable sort of their expert ids, on the
device: nothing is read back to the host), so each expert's rows from
every group are one stretch, and
:func:`repro_torch.kernels.moe.moe_expert_mlp` (row 12) runs each
expert's MLP over its rows only, so an expert that no token picked costs
nothing.  The combine gathers each pair's row back and sums the choices
in order in float32, weighted by ``topv * keep`` cast to the input's
dtype, which is what JAX's einsums compute; both of JAX's dispatch paths
give the same values, so ``gather_dispatch`` changes nothing here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoECfg
from repro_torch.kernels import moe as kmoe
from repro_torch.models.common import activation, dense_init, param

__all__ = ["DenseFFN", "init_dense_ffn", "dense_ffn", "MoEFFN", "init_moe", "Routing",
           "moe_capacity", "route", "moe_ffn"]

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


class MoEFFN(nn.Module):
    """Parameters of one MoE FFN, under JAX's leaf names: ``router [d, E]``,
    ``w_in [E, d, f]``, ``w_out [E, f, d]``, for the GLU variants
    ``w_gate [E, d, f]``, and with shared experts ``shared``, a
    :class:`DenseFFN` of width ``(d_ff_shared or d_ff_expert) * n_shared``."""

    def __init__(self, router: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                 w_gate: torch.Tensor | None = None, shared: DenseFFN | None = None):
        super().__init__()
        self.router = param(router)
        self.w_in = param(w_in)
        self.w_out = param(w_out)
        self.w_gate = None if w_gate is None else param(w_gate)
        self.shared = shared


def init_moe(generator: torch.Generator, d_model: int, cfg: MoECfg, act: str,
             dtype: torch.dtype | None = None) -> MoEFFN:
    """The JAX package's draw order: ``router`` (std 0.02), ``w_in``,
    ``w_out``, ``w_gate``, then the shared experts."""
    if act not in _ACTS:
        raise ValueError(f"unknown ffn_act {act!r}")
    E, f = cfg.n_experts, cfg.d_ff_expert
    router = dense_init((d_model, E), generator, scale=0.02, dtype=dtype)
    w_in = dense_init((E, d_model, f), generator, dtype=dtype)
    w_out = dense_init((E, f, d_model), generator, dtype=dtype)
    w_gate = (dense_init((E, d_model, f), generator, dtype=dtype)
              if act in ("swiglu", "geglu") else None)
    shared = None
    if cfg.n_shared:
        ff_sh = (cfg.d_ff_shared or cfg.d_ff_expert) * cfg.n_shared
        shared = init_dense_ffn(generator, d_model, ff_sh, act, dtype=dtype)
    return MoEFFN(router, w_in, w_out, w_gate, shared)


class Routing(NamedTuple):
    """What :func:`route` decides for ``n`` groups of ``g`` tokens."""

    topv: torch.Tensor  # [n, g, k] f32 gate weights (normalised under router_norm_topk)
    topi: torch.Tensor  # [n, g, k] int64 expert of each (token, choice) pair
    pos: torch.Tensor  # [n, g, k] int32 the pair's place in its expert's queue
    keep: torch.Tensor  # [n, g, k] bool: pos < capacity
    counts: torch.Tensor  # [n, E] int32 pairs routed to each expert, kept or not


def moe_capacity(cfg: MoECfg, gs: int, no_drop: bool) -> int:
    """Rows an expert takes from a group of ``gs`` tokens (JAX's rule)."""
    if no_drop:
        return gs * cfg.top_k
    return max(1, int(cfg.capacity_factor * gs * cfg.top_k / cfg.n_experts))


def route(probs: torch.Tensor, cfg: MoECfg, capacity: int) -> Routing:
    """Top-k routing of router probabilities ``[n, g, E]`` (float32).

    The top ``k`` by a stable descending sort: on equal probabilities the
    lower expert comes first, as in ``jax.lax.top_k`` (``torch.topk``
    orders ties otherwise).  The normalising sum adds the ``k`` values in
    order.  A pair's position is the number of earlier pairs of its group,
    in (token, choice) order, routed to the same expert (JAX's cumsum over
    a one-hot ``[n, g*k, E]``; here a stable sort of the pairs by (group,
    expert), which keeps that order within each expert, and each pair's
    rank in its run)."""
    n, g, E = probs.shape
    k = cfg.top_k
    dev = probs.device
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    if cfg.router_norm_topk:
        total = topv[..., 0]
        for j in range(1, k):
            total = total + topv[..., j]
        topv = topv / torch.clamp_min(total, 1e-9)[..., None]
    key = (torch.arange(n, device=dev)[:, None, None] * E + topi).reshape(-1)  # (group, expert)
    order = torch.argsort(key, stable=True)
    run = key[order]
    starts = torch.searchsorted(run, torch.arange(n * E + 1, device=dev))
    rank = torch.arange(key.numel(), device=dev) - starts[run]
    pos = torch.empty_like(rank)
    pos[order] = rank
    pos = pos.to(torch.int32).reshape(n, g, k)
    counts = (starts[1:] - starts[:-1]).to(torch.int32).reshape(n, E)
    return Routing(topv, topi, pos, pos < capacity, counts)


def _dispatch_rows(r: Routing, capacity: int):
    """The compact layout of the kept pairs: ``(perm, offsets, row)``.

    ``perm [n*g*k]`` lists the pairs (flattened (group, token, choice)
    order) with the kept ones first, in (expert, group, position) order;
    ``offsets [E*n + 1]`` int32 is where each (expert, group)'s rows start,
    at ``offsets[e*n + g]``; ``row [n, g, k]`` is each kept pair's row
    (meaningless for a dropped one).  All on the device, with shapes known
    on the host."""
    n, g, k = r.topi.shape
    E = r.counts.shape[1]
    eg = r.topi * n + torch.arange(n, device=r.topi.device)[:, None, None]  # [n, g, k]
    key = torch.where(r.keep, eg, n * E).reshape(-1)
    perm = torch.argsort(key, stable=True)
    kept = torch.clamp_max(r.counts, capacity).t().reshape(-1)  # expert-major
    offsets = torch.zeros(n * E + 1, dtype=torch.int32, device=kept.device)
    offsets[1:] = torch.cumsum(kept, 0, dtype=torch.int32)
    row = offsets[eg] + r.pos
    return perm, offsets, row


def moe_ffn(params: MoEFFN, x: torch.Tensor, cfg: MoECfg, act: str, group_size: int = 4096,
            no_drop: bool = False, gather_dispatch: bool = False):
    """Top-k routed experts with capacity-bounded dispatch: ``x [B, S, d]``
    -> ``(y [B, S, d], {"moe_aux": f32 scalar})``.

    ``no_drop=True`` takes the capacity of the worst case, so no pair is
    dropped (decode).  ``gather_dispatch`` picks between JAX's two
    dispatch paths, which compute the same function: it is accepted and
    changes nothing."""
    del gather_dispatch
    B, S, d = x.shape
    G = B * S
    gs = min(group_size, G)
    n_groups = -(-G // gs)
    pad = n_groups * gs - G
    xf = x.reshape(G, d)
    if pad:
        xf = torch.cat([xf, torch.zeros((pad, d), dtype=x.dtype, device=x.device)])
    xg = xf.reshape(n_groups, gs, d)

    probs = torch.softmax((xg @ params.router.to(x.dtype)).float(), dim=-1)  # [n, g, E]
    capacity = moe_capacity(cfg, gs, no_drop)
    r = route(probs, cfg, capacity)
    k = cfg.top_k
    perm, offsets, row = _dispatch_rows(r, capacity)
    tok = torch.arange(n_groups * gs, device=x.device).repeat_interleave(k)  # pair -> token
    xc = xf[tok[perm]]  # [n*g*k, d]: the kept pairs' rows first, by (expert, group, position)
    w_gate = None if params.w_gate is None else params.w_gate.to(x.dtype)
    yc = kmoe.moe_expert_mlp(xc, offsets, min(capacity, gs), params.w_in.to(x.dtype),
                             w_gate, params.w_out.to(x.dtype), act)

    # combine: each choice's row, weighted, summed in choice order in f32
    # (a dropped pair's row is never written: where() keeps it out)
    w = (r.topv * r.keep).to(x.dtype).float()
    picked = torch.where(r.keep[..., None], yc[torch.clamp(row, 0, yc.shape[0] - 1)], 0)
    terms = w[..., None] * picked.float()  # [n, g, k, d]
    acc = terms[:, :, 0]
    for j in range(1, k):
        acc = acc + terms[:, :, j]
    y = acc.to(x.dtype).reshape(n_groups * gs, d)[:G].reshape(B, S, d)
    if cfg.n_shared and params.shared is not None:
        y = y + dense_ffn(params.shared, x, act)

    # load-balance aux loss (Switch-style): mean prob * mean assignment
    inv = 1.0 / (n_groups * gs)
    me = probs.sum(dim=(0, 1)) * inv
    ce = r.counts.sum(0).float() * inv
    aux = cfg.n_experts * torch.sum(me * ce)
    return y, {"moe_aux": aux}
