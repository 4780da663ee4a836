"""chameleon-34b [vlm] — early fusion; VQ image tokens live in the vocab
(the modality frontend is the VQ tokenizer, stubbed: inputs are token ids)
[arXiv:2405.09818]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    ffn_act="swiglu",
    sub_quadratic=False,
)
