"""llama3-405b [dense] — GQA kv=8, 128k vocab [arXiv:2407.21783]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    vocab=128_256,
    ffn_act="swiglu",
    rope_theta=5e5,
    sub_quadratic=False,
)
