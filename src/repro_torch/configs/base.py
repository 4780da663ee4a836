"""Architecture configuration system (a copy of ``repro.configs.base``).

The port keeps its own copy, data only, so that it imports nothing of the
JAX package; the parity tests hold ``param_count`` and ``describe``
equal to the JAX package's for every config.

Every assigned architecture gets one module in this package defining a
``CONFIG`` (the exact published dims) plus a ``reduced()`` smoke-test
variant.  ``ArchConfig.layer_groups()`` canonicalises the layer stack into
repeating groups so the model assembly can ``lax.scan`` over repeats
(bounded HLO size even at 126 layers) while still expressing mixed-layer
patterns (RecurrentGemma's 2×RG-LRU + 1×local-attn, DeepSeekMoE's dense
first layer, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = [
    "MoECfg",
    "SSMCfg",
    "HybridCfg",
    "EncDecCfg",
    "ArchConfig",
    "LayerSpec",
    "BlockGroup",
]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeekMoE-style
    d_ff_shared: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeekMoE layer 0)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    a_init_range: tuple[float, float] = (1.0, 16.0)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    lru_width: int = 0  # 0 -> d_model
    window: int = 2048  # local attention window
    pattern_recurrent: int = 2  # recurrent layers per local-attn layer
    rglru_c: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int = 24
    n_frames: int = 1500  # precomputed frame embeddings (conv stem stubbed)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "local" | "ssd" | "rglru" | "xattn" (enc-dec)
    ffn: str  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    specs: tuple[LayerSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.specs) * self.repeat


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    ffn_act: str = "swiglu"  # swiglu | geglu | gelu | relu2
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    hybrid: HybridCfg | None = None
    encdec: EncDecCfg | None = None
    # execution policy knobs (overridable per shape at launch)
    remat: str = "full"  # none | dots | full
    q_block: int = 512
    kv_block: int = 1024
    sub_quadratic: bool = False  # can run long_500k decode
    # ---- beyond-paper optimization switches (§Perf hillclimb; default off
    # so the baseline stays the paper-faithful/naive implementation) -------
    flash_vjp: bool = False  # fused flash backward (O(S) residuals)
    q_parallel: bool = False  # vmap (shardable) q-blocks instead of scan
    moe_gather: bool = False  # gather/scatter MoE dispatch (no one-hot flops)
    layout: str = "tp"  # tp | dp_only  (activation layout strategy)
    fsdp_gather: bool = False  # constrain weights to gathered TP layout at
    # use — forces per-layer weight all-gather (textbook FSDP) instead of
    # GSPMD's activation-side resolutions (§Perf iteration 3)

    # ---- derived -------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None

    def layer_groups(self) -> list[BlockGroup]:
        """Decoder layer stack as scan-able repeating groups."""
        if self.ssm is not None:
            return [BlockGroup((LayerSpec("ssd", "none"),), self.n_layers)]
        if self.hybrid is not None:
            p = self.hybrid.pattern_recurrent
            block = tuple([LayerSpec("rglru", "dense")] * p + [LayerSpec("local", "dense")])
            reps = self.n_layers // (p + 1)
            tail = self.n_layers - reps * (p + 1)
            groups = [BlockGroup(block, reps)]
            if tail:
                groups.append(BlockGroup((LayerSpec("rglru", "dense"),), tail))
            return groups
        if self.moe is not None:
            groups = []
            if self.moe.first_k_dense:
                groups.append(
                    BlockGroup((LayerSpec("attn", "dense"),), self.moe.first_k_dense)
                )
            groups.append(
                BlockGroup(
                    (LayerSpec("attn", "moe"),), self.n_layers - self.moe.first_k_dense
                )
            )
            return groups
        if self.is_encdec:
            return [BlockGroup((LayerSpec("xattn", "dense"),), self.n_layers)]
        return [BlockGroup((LayerSpec("attn", "dense"),), self.n_layers)]

    def encoder_groups(self) -> list[BlockGroup]:
        assert self.encdec is not None
        return [BlockGroup((LayerSpec("attn", "dense"),), self.encdec.n_enc_layers)]

    # ---- parameter counting (for MODEL_FLOPS = 6·N·D) -------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        # embeddings (+ untied unembed)
        n += self.vocab * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b

        def dense_ffn_params(ff: int) -> int:
            mult = 3 if self.ffn_act in ("swiglu", "geglu") else 2
            return mult * d * ff

        for group in self.layer_groups():
            for spec in group.specs:
                per = 2 * d  # two norms
                if spec.mixer in ("attn", "local"):
                    per += attn_params()
                elif spec.mixer == "xattn":
                    per += 2 * attn_params() + d  # self + cross + extra norm
                elif spec.mixer == "ssd":
                    assert self.ssm is not None
                    di = self.ssm.d_inner(d)
                    nh = self.ssm.n_heads(d)
                    conv_dim = di + 2 * self.ssm.d_state
                    per += d * (2 * di + 2 * self.ssm.d_state + nh)  # in_proj
                    per += conv_dim * self.ssm.conv_width
                    per += di * d  # out_proj
                    per += 2 * nh + di  # A_log, D, gated-norm
                elif spec.mixer == "rglru":
                    assert self.hybrid is not None
                    w = self.hybrid.lru_width or d
                    per += 2 * d * w + self.ssm_conv(w) + 2 * w * w // 1  # in projs + conv
                    per += 2 * w + 2 * w  # gates a/x diag params + Lambda
                    per += w * d  # out proj
                if spec.ffn == "dense":
                    per += dense_ffn_params(self.d_ff)
                elif spec.ffn == "moe":
                    assert self.moe is not None
                    e_all = self.moe.n_experts
                    e_act = self.moe.top_k
                    per_expert = dense_ffn_params(self.moe.d_ff_expert)
                    shared = self.moe.n_shared * (
                        dense_ffn_params(self.moe.d_ff_shared or self.moe.d_ff_expert)
                    )
                    router = d * e_all
                    if active_only:
                        per += e_act * per_expert + shared + router
                    else:
                        per += e_all * per_expert + shared + router
                n += per * group.repeat
        if self.is_encdec:
            for group in self.encoder_groups():
                per_l = 2 * d + attn_params() + dense_ffn_params(self.d_ff)
                n += per_l * group.repeat
        n += d  # final norm
        return n

    def ssm_conv(self, w: int) -> int:
        return 4 * w  # conv width 4 over lru width

    def describe(self) -> str:
        return (
            f"{self.name} [{self.family}] {self.n_layers}L d={self.d_model} "
            f"H={self.n_heads}/kv{self.n_kv_heads} ff={self.d_ff} V={self.vocab} "
            f"params≈{self.param_count() / 1e9:.2f}B"
        )


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32,
        q_block=64,
        kv_block=64,
        remat="none",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=2,
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.n_shared else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=32
        )
        small["d_ff"] = 0
    if cfg.hybrid is not None:
        small["hybrid"] = dataclasses.replace(cfg.hybrid, lru_width=128, window=64)
        small["n_layers"] = 4  # 3-block group + 1 tail
        small["n_kv_heads"] = 1
    if cfg.encdec is not None:
        small["encdec"] = dataclasses.replace(cfg.encdec, n_enc_layers=2, n_frames=16)
        small["n_layers"] = 2
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
