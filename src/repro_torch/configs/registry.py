"""Config registry: ``--arch <id>`` -> ArchConfig (``repro.configs.registry``).

Each arch module defines ``CONFIG``; ``get_config(name)`` resolves it and
``get_reduced(name)`` gives the smoke-test variant.  Input-shape sets
(assigned per the brief) live here too.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig, reduced_config

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_reduced", "shape_applicable"]

ARCH_IDS = (
    "mamba2_130m",
    "whisper_medium",
    "recurrentgemma_9b",
    "chameleon_34b",
    "nemotron4_15b",
    "starcoder2_3b",
    "qwen2_7b",
    "llama3_405b",
    "dbrx_132b",
    "deepseek_moe_16b",
)

# assigned LM shape set: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def get_reduced(name: str, **overrides) -> ArchConfig:
    return reduced_config(get_config(name), **overrides)


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic decode memory (DESIGN.md §5)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k KV cache is O(S) per layer x 126L -> skipped per brief"
    return True, ""
