"""mamba2-130m [ssm] — SSD state-space duality [arXiv:2405.21060]."""

from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,           # = d_inner / head_dim (derived; attn-free)
    n_kv_heads=24,
    d_ff=0,               # attn-free block, no separate FFN
    vocab=50_280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    sub_quadratic=True,   # O(1) decode state -> long_500k runs
)
