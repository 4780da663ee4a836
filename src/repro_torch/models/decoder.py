"""Decoder-only LM (``repro.models.decoder``) for the ``attn`` mixer and the
``dense`` and ``moe`` FFNs: the serving path of the dense and MoE families.

The parameters are ``nn.Module``\\ s laid out as the JAX package's tree:
:class:`Decoder` holds ``embed``, ``final_norm``, ``unembed`` (unless
tied) and ``groups[gi]["p{i}"]``, one :class:`DecoderLayer` for each of a
group's ``repeat`` layers where the JAX tree stacks them on a leading
``R`` axis.  The functions over them follow the JAX ones:

* :func:`decoder_forward` — tokens ``[B, S]`` -> f32 logits ``[B, S, V]``;
* :func:`decoder_prefill` — the last position's logits and the cache;
* :func:`decoder_decode` — one token against the cache (``serve_step``).

Parameters held in ``Policy.param_dtype`` (float32 master parameters, what
``init_decoder`` draws by default) are trainable; serving weights in the
compute dtype are frozen.  Under grad mode with trainable parameters the
forward builds the graph of training: its attention is
``flash_attention_fused`` (row 7 with its log-sum-exp, and row 9 for the
backward) whatever ``cfg.flash_vjp`` says, since JAX's two branches give
the same gradient up to rounding, and ``cfg.remat`` maps to each layer:
``"full"`` recomputes the layer in the backward
(``torch.utils.checkpoint``), ``"dots"`` recomputes all but the matrix
products' outputs (a selective checkpoint), ``"none"`` keeps everything.
Prefill and decode run without grad.

What the JAX package does and this repeats: the head packing
``h = k * G + g``; biases added in the compute dtype; every weight cast
to the activations' dtype at use (free for serving weights already held
in it); logits as ``x @ w`` in the compute dtype, then cast to f32.  The
cache is ``{"groups": [{"p{i}": {"k", "v"}}], "pos": [B] int32}`` with
``k``/``v`` ``[R, B, Smax, K, hd]``, as JAX's.  Unlike the JAX function,
:func:`decoder_decode` writes the new token's keys and values into the
cache it is given (an indexed write per layer, no copy of the cache) and
returns the same tensors.

A ``moe`` layer's FFN is :func:`~repro_torch.models.ffn.moe_ffn`: with
capacity dropping in the forward and the prefill (JAX's default group of
4,096 tokens), drop-free (``no_drop``) in the decode; the forward returns
the sum of the MoE layers' ``moe_aux`` as ``aux_loss``, as JAX's
``_run_groups`` does.  MoE training (the routed experts' backward) is a
later slice: on the card the forward under grad raises there.

Other mixers (``local``, ``ssd``, ``rglru``, ``xattn``) raise
``NotImplementedError``: they are later slices of the port.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import attention as kattn
from repro_torch.models import attention as mattn
from repro_torch.models.common import (
    Policy,
    dense_init,
    norm_apply,
    param,
    rope_tables,
    rotate,
    take_embedding,
)
from repro_torch.models.ffn import DenseFFN, MoEFFN, dense_ffn, init_dense_ffn, init_moe, moe_ffn

__all__ = [
    "Norm",
    "Attention",
    "DecoderLayer",
    "Decoder",
    "check_supported",
    "init_decoder",
    "decoder_forward",
    "decoder_prefill",
    "decoder_decode",
    "init_cache",
]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer is ``attn`` with a
    ``dense`` or ``moe`` FFN."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet: ROADMAP queue 1, "
            "LM item 4 (encdec)")
    later = {"local": "item 2 (local_attention and rglru)",
             "rglru": "item 2 (local_attention and rglru)", "ssd": "item 3 (ssd)",
             "xattn": "item 4 (encdec)"}
    for group in cfg.layer_groups():
        for spec in group.specs:
            for part in (spec.mixer, spec.ffn):
                if part in later:
                    raise NotImplementedError(
                        f"{cfg.name}: layer {spec} is not ported yet: ROADMAP queue 1, LM "
                        f"{later[part]}")
            if spec.mixer != "attn" or spec.ffn not in ("dense", "moe"):
                raise NotImplementedError(f"{cfg.name}: layer {spec} is not ported")


class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm); applied as ``1 + scale``."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.scale = param(scale)
        self.bias = None if bias is None else param(bias)


class Attention(nn.Module):
    """``wq [d, H*hd]``, ``wk``/``wv [d, K*hd]``, ``wo [H*hd, d]`` and,
    with ``qkv_bias``, ``bq``, ``bk``, ``bv``."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = param(wq), param(wk), param(wv), param(wo)
        self.bq = None if bq is None else param(bq)
        self.bk = None if bk is None else param(bk)
        self.bv = None if bv is None else param(bv)


class DecoderLayer(nn.Module):
    """One ``attn`` layer: ``norm1``, ``attn``, ``norm2`` and either ``ffn``
    (a dense layer) or ``moe`` (a MoE layer); the other is None."""

    def __init__(self, norm1: Norm, attn_p: Attention, norm2: Norm,
                 ffn: DenseFFN | None = None, moe: MoEFFN | None = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a layer holds exactly one of ffn and moe")
        self.norm1, self.attn, self.norm2 = norm1, attn_p, norm2
        self.ffn, self.moe = ffn, moe


class Decoder(nn.Module):
    """The model's parameters: ``embed [V, d]``, ``final_norm``, ``unembed
    [d, V]`` (``None`` when tied) and ``groups``."""

    def __init__(self, embed, final_norm: Norm, groups: list[dict[str, list[DecoderLayer]]],
                 unembed=None):
        super().__init__()
        self.embed = param(embed)
        self.final_norm = final_norm
        self.unembed = None if unembed is None else param(unembed)
        self.groups = nn.ModuleList(
            nn.ModuleDict({key: nn.ModuleList(layers) for key, layers in g.items()})
            for g in groups)

    def unembedding(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.unembed if self.unembed is not None else self.embed.T
        return w.to(dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _zeros_norm(cfg: ArchConfig, device, dtype) -> Norm:
    z = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)  # noqa: E731
    return Norm(z(), z() if cfg.norm == "layernorm" else None)


def _init_attn(gen: torch.Generator, cfg: ArchConfig, dtype) -> Attention:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = [dense_init((d, H * hd), gen, dtype=dtype), dense_init((d, K * hd), gen, dtype=dtype),
         dense_init((d, K * hd), gen, dtype=dtype),
         dense_init((H * hd, d), gen, scale=(H * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                    dtype=dtype)]
    if cfg.qkv_bias:
        dev = gen.device
        p += [torch.zeros((H * hd,), dtype=dtype, device=dev),
              torch.zeros((K * hd,), dtype=dtype, device=dev),
              torch.zeros((K * hd,), dtype=dtype, device=dev)]
    return Attention(*p)


def init_decoder(generator: torch.Generator, cfg: ArchConfig,
                 dtype: torch.dtype | None = None) -> Decoder:
    """Fresh parameters on ``generator``'s device, each drawn in float32
    by the JAX package's rules (:func:`~repro_torch.models.common.dense_init`;
    norms and biases zero) and cast once to ``dtype`` (default
    ``Policy.param_dtype``; the compute dtype gives serving weights)."""
    check_supported(cfg)
    dtype = dtype or Policy.param_dtype
    dev = generator.device
    embed = dense_init((cfg.vocab, cfg.d_model), generator, scale=0.02, dtype=dtype)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = dense_init((cfg.d_model, cfg.vocab), generator, scale=0.02, dtype=dtype)
    groups = []
    for group in cfg.layer_groups():
        g = {}
        for i, spec in enumerate(group.specs):
            layers = []
            for _ in range(group.repeat):
                norm1 = _zeros_norm(cfg, dev, dtype)
                attn_p = _init_attn(generator, cfg, dtype)
                norm2 = _zeros_norm(cfg, dev, dtype)
                if spec.ffn == "moe":
                    layers.append(DecoderLayer(norm1, attn_p, norm2, moe=init_moe(
                        generator, cfg.d_model, cfg.moe, cfg.ffn_act, dtype=dtype)))
                else:
                    layers.append(DecoderLayer(norm1, attn_p, norm2, ffn=init_dense_ffn(
                        generator, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype=dtype)))
            g[f"p{i}"] = layers
        groups.append(g)
    return Decoder(embed, _zeros_norm(cfg, dev, dtype), groups, unembed)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _norm(cfg: ArchConfig, x: torch.Tensor, p: Norm) -> torch.Tensor:
    return norm_apply(cfg.norm, x, p.scale, p.bias)


def _qkv(p: Attention, x: torch.Tensor, rope, cfg: ArchConfig):
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // K
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = rotate(q.reshape(B, S, K * G, hd), rope).reshape(B, S, K, G, hd)
    k = rotate(k.reshape(B, S, K, hd), rope)
    return q, k, v.reshape(B, S, K, hd)


def _attn_out(p: Attention, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # o: [B, S, K, G, hd]; head h = k * G + g matches the _qkv packing
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo.to(o.dtype)


def _ffn_residual(layer: DecoderLayer, x: torch.Tensor, cfg: ArchConfig,
                  no_drop: bool = False):
    """``(x + ffn(norm2(x)), aux)``: ``aux`` the MoE layer's ``moe_aux``, or
    None for a dense layer."""
    h = _norm(cfg, x, layer.norm2)
    if layer.moe is None:
        return x + dense_ffn(layer.ffn, h, cfg.ffn_act), None
    y, aux = moe_ffn(layer.moe, h, cfg.moe, cfg.ffn_act, no_drop=no_drop,
                     gather_dispatch=cfg.moe_gather)
    return x + y, aux["moe_aux"]


def _layer_forward(layer: DecoderLayer, x, rope, cfg: ArchConfig):
    """Returns ``(x, k, v, aux)``: the layer's output, its cache entries and
    its MoE aux loss (None for a dense layer)."""
    q, k, v = _qkv(layer.attn, _norm(cfg, x, layer.norm1), rope, cfg)
    if torch.is_grad_enabled() and layer.attn.wq.requires_grad:
        o = mattn.flash_attention_fused(q, k, v, True, cfg.q_block, cfg.kv_block, cfg.q_parallel)
    else:
        o = kattn.flash_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                  kv_block=cfg.kv_block)
    x = x + _attn_out(layer.attn, o, cfg)
    x, aux = _ffn_residual(layer, x, cfg)
    return x, k, v, aux


#: The outputs a ``"dots"`` checkpoint keeps (JAX's ``dots_saveable``):
#: matrix products, as ``x @ w`` and the plain attention's einsums reach
#: the dispatcher.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _layer_train(layer: DecoderLayer, x, rope, cfg: ArchConfig):
    """The layer's ``(output, aux)`` under ``cfg.remat`` (the JAX scan
    body's ``jax.checkpoint``, taken per layer)."""
    def run(x_):
        out = _layer_forward(layer, x_, rope, cfg)
        return out[0], out[3]

    if cfg.remat == "none":
        return run(x)
    if cfg.remat == "dots":
        return checkpoint(run, x, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _dots_policy))
    return checkpoint(run, x, use_reentrant=False)


def _layers(params: Decoder, cfg: ArchConfig):
    """``(gi, key, r, layer)`` in the JAX scan's order: each group's
    repeats, each repeat's specs."""
    for gi, group in enumerate(cfg.layer_groups()):
        for r in range(group.repeat):
            for i in range(len(group.specs)):
                yield gi, f"p{i}", r, params.groups[gi][f"p{i}"][r]


def _run(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig, cache_len: int | None):
    """Embedding and every layer over ``tokens [B, S]``: ``(x, caches,
    aux)``; with ``cache_len`` also the KV cache, padded (or cut to its last
    slots) to that length.  ``aux`` sums the MoE layers' aux losses in
    float32, in layer order."""
    B, S = tokens.shape
    x = take_embedding(params.embed, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)  # once for every layer
    caches = None
    if cache_len is not None:
        caches = init_cache(cfg, B, cache_len, dtype=x.dtype, device=x.device)["groups"]
        keep = min(S, cache_len)  # JAX keeps the last slots of a longer prefill
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, key, r, layer in _layers(params, cfg):
        if caches is None and torch.is_grad_enabled() and layer.attn.wq.requires_grad:
            x, aux = _layer_train(layer, x, rope, cfg)
        else:
            x, k, v, aux = _layer_forward(layer, x, rope, cfg)
            if caches is not None:
                caches[gi][key]["k"][r, :, :keep] = k[:, S - keep:]
                caches[gi][key]["v"][r, :, :keep] = v[:, S - keep:]
        if aux is not None:
            aux_total = aux_total + aux
    return _norm(cfg, x, params.final_norm), caches, aux_total


def decoder_forward(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig):
    """Training forward: tokens ``[B, S]`` -> ``(logits [B, S, V] f32,
    {"aux_loss": the MoE layers' summed aux loss, 0 without them})``."""
    x, _, aux = _run(params, tokens, cfg, None)
    logits = (x @ params.unembedding(x.dtype)).float()
    return logits, {"aux_loss": aux}


@torch.no_grad()
def decoder_prefill(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig,
                    pad_cache_to: int | None = None):
    """Prefill: ``(last-position logits [B, V] f32, cache)``; the cache's
    time axis is ``S``, or ``pad_cache_to`` (zero-padded, or the last
    ``pad_cache_to`` positions of a longer prompt)."""
    B, S = tokens.shape
    x, caches, _ = _run(params, tokens, cfg, S if pad_cache_to is None else pad_cache_to)
    logits = (x[:, -1, :] @ params.unembedding(x.dtype)).float()
    pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)  # next token's index
    return logits, {"groups": caches, "pos": pos}


# --------------------------------------------------------------------------
# cache init + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """Zeroed serving cache: per group ``{"p{i}": {"k", "v"}}``, each
    ``[R, batch, max_len, K, hd]`` in ``dtype`` (default the compute
    dtype), and ``pos`` ``[batch]`` int32 zeros."""
    check_supported(cfg)
    dtype = dtype or Policy.compute_dtype
    K, hd = cfg.n_kv_heads, cfg.hd
    groups = []
    for group in cfg.layer_groups():
        shape = (group.repeat, batch, max_len, K, hd)
        groups.append({
            f"p{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(len(group.specs))
        })
    return {"groups": groups, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _scatter_time(cache_kv: torch.Tensor, new_kv: torch.Tensor, rows: torch.Tensor,
                  slot: torch.Tensor, keep: torch.Tensor) -> None:
    """Write ``new_kv [B, K, hd]`` into ``cache_kv [B, S, K, hd]`` at time
    ``slot [B]``, in place.  A slot past the end is dropped, as JAX's
    ``.at[].set`` drops it: that row writes back what its last slot holds."""
    at = torch.where(keep, slot, cache_kv.shape[1] - 1)
    new = torch.where(keep[:, None, None], new_kv.to(cache_kv.dtype), cache_kv[rows, at])
    cache_kv[rows, at] = new


@torch.no_grad()
def decoder_decode(params: Decoder, token: torch.Tensor, cache: dict, cfg: ArchConfig):
    """``serve_step``: one new token ``[B, 1]`` -> ``(logits [B, V] f32,
    cache)``; the cache's keys and values are written in place and its
    ``pos`` advanced (a new tensor)."""
    B = token.shape[0]
    pos = cache["pos"]  # index of the new token
    x = take_embedding(params.embed, token)
    rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    rows = torch.arange(B, device=token.device)
    groups = cache["groups"]
    keep = pos < groups[0]["p0"]["k"].shape[2]  # slots past the end are dropped
    for gi, key, r, layer in _layers(params, cfg):
        kc, vc = groups[gi][key]["k"][r], groups[gi][key]["v"][r]
        q, k, v = _qkv(layer.attn, _norm(cfg, x, layer.norm1), rope, cfg)
        _scatter_time(kc, k[:, 0], rows, pos, keep)
        _scatter_time(vc, v[:, 0], rows, pos, keep)
        o = kattn.decode_attention(q, kc, vc, pos)
        x = x + _attn_out(layer.attn, o, cfg)
        x, _ = _ffn_residual(layer, x, cfg, no_drop=True)
    x = _norm(cfg, x, params.final_norm)
    logits = (x[:, 0] @ params.unembedding(x.dtype)).float()
    return logits, {"groups": groups, "pos": pos + 1}
