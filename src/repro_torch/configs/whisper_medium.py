"""whisper-medium [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""

from repro_torch.configs.base import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder layers (encoder listed separately)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,        # MHA (GQA kv=16)
    d_ff=4096,
    vocab=51_865,
    ffn_act="gelu",
    norm="layernorm",
    encdec=EncDecCfg(n_enc_layers=24, n_frames=1500),
    sub_quadratic=False,  # full-attention decoder -> long_500k skipped
)
