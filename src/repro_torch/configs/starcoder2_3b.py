"""starcoder2-3b [dense] — GQA kv=2, RoPE [arXiv:2402.19173]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12_288,
    vocab=49_152,
    ffn_act="gelu",
    norm="layernorm",
    rope_theta=1e5,
    sub_quadratic=False,
)
