"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,          # per-expert FFN width
    vocab=100_352,
    ffn_act="swiglu",
    rope_theta=5e5,
    moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10_752),
    sub_quadratic=False,
)
