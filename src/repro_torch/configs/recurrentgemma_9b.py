"""recurrentgemma-9b [hybrid] — RG-LRU + local attn 1:2 [arXiv:2402.19427]."""

from repro_torch.configs.base import ArchConfig, HybridCfg

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,          # 12 x (2 RG-LRU + 1 local-attn) + 2 RG-LRU tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,         # MQA on the local-attention layers
    d_ff=12_288,
    vocab=256_000,
    ffn_act="geglu",
    hybrid=HybridCfg(lru_width=4096, window=2048, pattern_recurrent=2),
    tie_embeddings=True,
    sub_quadratic=True,   # bounded window + recurrent state -> long_500k runs
)
