"""Decoder-only LM (``repro.models.decoder``) for the ``attn``, ``local`` and
``rglru`` mixers and the ``dense`` and ``moe`` FFNs: the serving path of
the dense, MoE and hybrid families.

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
cache is ``{"groups": [{"p{i}": ...}], "pos": [B] int32}`` as JAX's: an
``attn`` or ``local`` layer's entry ``{"k", "v"}`` ``[R, B, T, K, hd]``, an
``rglru`` layer's ``{"conv": [R, B, 3, w], "state": [R, B, w] f32}``.
Unlike the JAX function, :func:`decoder_decode` writes the new token's
keys and values and the new recurrent state into the cache it is given
(an indexed write per layer, no copy of the cache) and returns the same
tensors.

The hybrid family (recurrentgemma): a ``local`` layer attends over a
sliding window (:func:`~repro_torch.kernels.attention.local_attention`,
row 13) and keeps the last ``min(window, S)`` keys of a prefill, in time
order, then padded or cut to ``pad_cache_to`` as JAX's ``_pad_kv_caches``
does every ``k``/``v`` cache; its decode writes ring slot ``pos % T`` (``T``
the cache's length) and attends to slots up to ``min(pos, T - 1)`` (row 8).
Both of JAX's quirks follow: a prefill padded past the window leaves a
cache of ``pad_cache_to`` slots that decode attends over, and the ring
agrees with the prefill's order only when ``S <= window`` or ``S % window
== 0`` (ROADMAP queue 3).  An ``rglru`` layer is
:mod:`~repro_torch.models.rglru` (row 14); its prefill keeps ``x W_x``'s
last 3 rows and the final state.

A ``moe`` layer's FFN is :func:`~repro_torch.models.ffn.moe_ffn`: with
capacity dropping in the forward and the prefill (JAX's default group of
4,096 tokens), drop-free (``no_drop``) in the decode; the forward returns
the sum of the MoE layers' ``moe_aux`` as ``aux_loss``, as JAX's
``_run_groups`` does.  MoE and hybrid training (the backward of rows 12,
13 and 14) are later slices: on the card the forward under grad raises
there.

The ``ssd`` and ``xattn`` mixers raise ``NotImplementedError``: they are
later slices of the port.
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
from repro_torch.models.rglru import (
    CONV_WIDTH,
    RGLRUBlock,
    init_rglru_block,
    init_rglru_cache,
    rglru_block_decode,
    rglru_block_forward,
)

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
    ``dense`` or ``moe`` FFN, or ``local`` or ``rglru`` with a ``dense``
    FFN."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet: ROADMAP queue 1, "
            "LM item 4 (encdec)")
    later = {"ssd": "item 3 (ssd)", "xattn": "item 4 (encdec)"}
    for group in cfg.layer_groups():
        for spec in group.specs:
            for part in (spec.mixer, spec.ffn):
                if part in later:
                    raise NotImplementedError(
                        f"{cfg.name}: layer {spec} is not ported yet: ROADMAP queue 1, LM "
                        f"{later[part]}")
            ffns = ("dense", "moe") if spec.mixer == "attn" else ("dense",)
            if spec.mixer not in ("attn", "local", "rglru") or spec.ffn not in ffns:
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
    """One layer: ``norm1``, its mixer, ``attn`` (an ``attn`` or ``local``
    layer) or ``rglru`` (the other None), ``norm2`` and either ``ffn`` (a
    dense layer) or ``moe`` (a MoE layer; the other None)."""

    def __init__(self, norm1: Norm, attn_p: Attention | None, norm2: Norm,
                 ffn: DenseFFN | None = None, moe: MoEFFN | None = None,
                 rglru: RGLRUBlock | None = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a layer holds exactly one of ffn and moe")
        if (attn_p is None) == (rglru is None):
            raise ValueError("a layer holds exactly one of attn and rglru")
        self.norm1, self.attn, self.rglru, self.norm2 = norm1, attn_p, rglru, norm2
        self.ffn, self.moe = ffn, moe

    def trainable(self) -> bool:
        """Held in ``Policy.param_dtype`` and so under training."""
        return self.norm1.scale.requires_grad


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
                attn_p = rglru = None
                if spec.mixer == "rglru":
                    rglru = init_rglru_block(generator, cfg, dtype)
                else:
                    attn_p = _init_attn(generator, cfg, dtype)
                norm2 = _zeros_norm(cfg, dev, dtype)
                if spec.ffn == "moe":
                    layers.append(DecoderLayer(norm1, attn_p, norm2, rglru=rglru, moe=init_moe(
                        generator, cfg.d_model, cfg.moe, cfg.ffn_act, dtype=dtype)))
                else:
                    layers.append(DecoderLayer(norm1, attn_p, norm2, rglru=rglru,
                                               ffn=init_dense_ffn(generator, cfg.d_model,
                                                                  cfg.d_ff, cfg.ffn_act,
                                                                  dtype=dtype)))
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


def _mixer_forward(layer: DecoderLayer, mixer: str, h, rope, cfg: ArchConfig):
    """``(out, kept)``: the mixer's output over ``h`` and what a prefill's
    cache is made of, ``{"k", "v"}`` of every position or ``{"hx", "state"}``
    (``h W_x`` and the final recurrent state)."""
    if mixer == "rglru":
        out, state, hx = rglru_block_forward(layer.rglru, h, cfg)
        return out, {"hx": hx, "state": state}
    q, k, v = _qkv(layer.attn, h, rope, cfg)
    if mixer == "local":
        o = kattn.local_attention(q, k, v, window=cfg.hybrid.window)
    elif torch.is_grad_enabled() and layer.trainable():
        o = mattn.flash_attention_fused(q, k, v, True, cfg.q_block, cfg.kv_block, cfg.q_parallel)
    else:
        o = kattn.flash_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                  kv_block=cfg.kv_block)
    return _attn_out(layer.attn, o, cfg), {"k": k, "v": v}


def _layer_forward(layer: DecoderLayer, mixer: str, x, rope, cfg: ArchConfig):
    """Returns ``(x, kept, aux)``: the layer's output, its cache's makings
    (:func:`_mixer_forward`) and its MoE aux loss (None for a dense layer)."""
    out, kept = _mixer_forward(layer, mixer, _norm(cfg, x, layer.norm1), rope, cfg)
    x, aux = _ffn_residual(layer, x + out, cfg)
    return x, kept, aux


#: The outputs a ``"dots"`` checkpoint keeps (JAX's ``dots_saveable``):
#: matrix products, as ``x @ w`` and the plain attention's einsums reach
#: the dispatcher.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _layer_train(layer: DecoderLayer, mixer: str, x, rope, cfg: ArchConfig):
    """The layer's ``(output, aux)`` under ``cfg.remat`` (the JAX scan
    body's ``jax.checkpoint``, taken per layer)."""
    def run(x_):
        out = _layer_forward(layer, mixer, x_, rope, cfg)
        return out[0], out[2]

    if cfg.remat == "none":
        return run(x)
    if cfg.remat == "dots":
        return checkpoint(run, x, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _dots_policy))
    return checkpoint(run, x, use_reentrant=False)


def _layers(params: Decoder, cfg: ArchConfig):
    """``(gi, key, r, mixer, layer)`` in the JAX scan's order: each group's
    repeats, each repeat's specs."""
    for gi, group in enumerate(cfg.layer_groups()):
        for r in range(group.repeat):
            for i, spec in enumerate(group.specs):
                yield gi, f"p{i}", r, spec.mixer, params.groups[gi][f"p{i}"][r]


def _kept_len(cfg: ArchConfig, mixer: str, S: int) -> int:
    """The keys a prefill of ``S`` tokens keeps: a ``local`` layer its
    last ``min(window, S)``, an ``attn`` layer every one."""
    return min(cfg.hybrid.window, S) if mixer == "local" else S


def _cache_groups(cfg: ArchConfig, B: int, kv_len, dtype, conv_rows: int, conv_dtype,
                  device) -> list[dict]:
    """Zeroed cache entries, per group ``{"p{i}": entry}``: an ``attn`` or
    ``local`` layer's ``{"k", "v"}`` ``[R, B, kv_len(mixer), K, hd]`` in
    ``dtype``, an ``rglru`` layer's ``{"conv": [R, B, conv_rows, w] in
    conv_dtype, "state": [R, B, w] float32}`` (:func:`init_rglru_cache`)."""
    K, hd = cfg.n_kv_heads, cfg.hd
    groups = []
    for group in cfg.layer_groups():
        g = {}
        for i, spec in enumerate(group.specs):
            lead = (group.repeat, B)
            if spec.mixer == "rglru":
                g[f"p{i}"] = init_rglru_cache(cfg, lead, conv_dtype, device, conv_rows)
            else:
                T = kv_len(spec.mixer)
                g[f"p{i}"] = {name: torch.zeros((*lead, T, K, hd), dtype=dtype, device=device)
                              for name in ("k", "v")}
        groups.append(g)
    return groups


def _prefill_cache(cfg: ArchConfig, B: int, S: int, pad_cache_to: int | None, dtype,
                   device) -> list[dict]:
    """The empty cache a prefill of ``S`` tokens fills: an ``attn`` layer
    ``S`` slots, a ``local`` one the last ``min(window, S)``, either padded
    or cut to ``pad_cache_to`` when given (JAX's ``_pad_kv_caches``); an
    ``rglru`` layer's ``conv`` in ``dtype`` (``min(3, S)`` rows, as JAX's
    ``hx[:, -3:]``) and float32 ``state``."""
    def kv_len(mixer):
        return _kept_len(cfg, mixer, S) if pad_cache_to is None else pad_cache_to

    return _cache_groups(cfg, B, kv_len, dtype, min(CONV_WIDTH - 1, S), dtype, device)


def _keep(cache: dict, r: int, mixer: str, kept: dict, cfg: ArchConfig) -> None:
    """Write one layer's ``kept`` (:func:`_mixer_forward`) into repeat ``r``
    of its ``cache`` entry: the last ``min(window, S)`` keys of a ``local``
    layer (every key of an ``attn`` one) at the front of its slots, or the
    last of them where it has fewer; an ``rglru`` layer's last ``h W_x``
    rows and state."""
    if mixer == "rglru":
        conv = cache["conv"][r]
        conv.copy_(kept["hx"][:, kept["hx"].shape[1] - conv.shape[1]:])
        cache["state"][r].copy_(kept["state"])
        return
    for name in ("k", "v"):
        t = kept[name]
        S = t.shape[1]
        keep = min(_kept_len(cfg, mixer, S), cache[name].shape[2])
        cache[name][r, :, :keep] = t[:, S - keep:]


def _run(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig, want_cache: bool = False,
         pad_cache_to: int | None = None):
    """Embedding and every layer over ``tokens [B, S]``: ``(x, caches,
    aux)``; with ``want_cache`` also the cache (:func:`_prefill_cache`).
    ``aux`` sums the MoE layers' aux losses in float32, in layer order."""
    B, S = tokens.shape
    x = take_embedding(params.embed, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)  # once for every layer
    caches = None
    if want_cache:
        caches = _prefill_cache(cfg, B, S, pad_cache_to, x.dtype, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, key, r, mixer, layer in _layers(params, cfg):
        if caches is None and torch.is_grad_enabled() and layer.trainable():
            x, aux = _layer_train(layer, mixer, x, rope, cfg)
        else:
            x, kept, aux = _layer_forward(layer, mixer, x, rope, cfg)
            if caches is not None:
                _keep(caches[gi][key], r, mixer, kept, cfg)
            del kept
        if aux is not None:
            aux_total = aux_total + aux
    return _norm(cfg, x, params.final_norm), caches, aux_total


def decoder_forward(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig):
    """Training forward: tokens ``[B, S]`` -> ``(logits [B, S, V] f32,
    {"aux_loss": the MoE layers' summed aux loss, 0 without them})``."""
    x, _, aux = _run(params, tokens, cfg)
    logits = (x @ params.unembedding(x.dtype)).float()
    return logits, {"aux_loss": aux}


@torch.no_grad()
def decoder_prefill(params: Decoder, tokens: torch.Tensor, cfg: ArchConfig,
                    pad_cache_to: int | None = None):
    """Prefill: ``(last-position logits [B, V] f32, cache)``; an ``attn``
    layer's time axis is ``S`` and a ``local`` layer's ``min(window, S)``,
    or either ``pad_cache_to`` (zero-padded, or the last ``pad_cache_to``
    positions kept)."""
    B, S = tokens.shape
    x, caches, _ = _run(params, tokens, cfg, want_cache=True, pad_cache_to=pad_cache_to)
    logits = (x[:, -1, :] @ params.unembedding(x.dtype)).float()
    pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)  # next token's index
    return logits, {"groups": caches, "pos": pos}


# --------------------------------------------------------------------------
# cache init + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """Zeroed serving cache: per group ``{"p{i}": entry}``, an ``attn``
    layer's ``{"k", "v"}`` ``[R, batch, max_len, K, hd]`` and a ``local``
    layer's ``[R, batch, min(window, max_len), K, hd]`` in ``dtype``
    (default the compute dtype), an ``rglru`` layer's ``{"conv": [R, batch,
    3, w], "state": [R, batch, w]}`` in float32 (JAX's
    ``init_rglru_cache``); and ``pos`` ``[batch]`` int32 zeros."""
    check_supported(cfg)
    groups = _cache_groups(cfg, batch, lambda mixer: _kept_len(cfg, mixer, max_len),
                           dtype or Policy.compute_dtype, CONV_WIDTH - 1, torch.float32, device)
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
    cache)``; the cache's keys, values, conv inputs and states are written
    in place and its ``pos`` advanced (a new tensor)."""
    B = token.shape[0]
    pos = cache["pos"]  # index of the new token
    x = take_embedding(params.embed, token)
    rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    rows = torch.arange(B, device=token.device)
    groups = cache["groups"]
    keep, ring = {}, {}  # by cache length: slots kept (attn); ring slot, last valid (local)
    for gi, key, r, mixer, layer in _layers(params, cfg):
        c = groups[gi][key]
        h = _norm(cfg, x, layer.norm1)
        if mixer == "rglru":
            y, nc = rglru_block_decode(layer.rglru, h, {"conv": c["conv"][r],
                                                        "state": c["state"][r]}, cfg)
            c["conv"][r].copy_(nc["conv"])
            c["state"][r].copy_(nc["state"])
            x = x + y
        else:
            kc, vc = c["k"][r], c["v"][r]
            T = kc.shape[1]
            q, k, v = _qkv(layer.attn, h, rope, cfg)
            if mixer == "local":  # a ring of T slots: JAX's w = cache["k"].shape[1]
                if T not in ring:
                    ring[T] = (pos % T, torch.clamp(pos, max=T - 1))
                slot, last = ring[T]
                kc[rows, slot] = k[:, 0].to(kc.dtype)
                vc[rows, slot] = v[:, 0].to(vc.dtype)
                o = kattn.decode_attention(q, kc, vc, last)
            else:
                if T not in keep:
                    keep[T] = pos < T  # slots past the end are dropped
                _scatter_time(kc, k[:, 0], rows, pos, keep[T])
                _scatter_time(vc, v[:, 0], rows, pos, keep[T])
                o = kattn.decode_attention(q, kc, vc, pos)
            x = x + _attn_out(layer.attn, o, cfg)
        x, _ = _ffn_residual(layer, x, cfg, no_drop=True)
    x = _norm(cfg, x, params.final_norm)
    logits = (x[:, 0] @ params.unembedding(x.dtype)).float()
    return logits, {"groups": groups, "pos": pos + 1}
