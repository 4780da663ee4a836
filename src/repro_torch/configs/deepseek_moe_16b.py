"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, layer-0 dense
[arXiv:2401.06066]."""

from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10_944,          # the dense first layer's FFN width
    vocab=102_400,
    ffn_act="swiglu",
    moe=MoECfg(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        d_ff_shared=1408,
        first_k_dense=1,
    ),
    sub_quadratic=False,
)
