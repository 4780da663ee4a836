"""LM attention (``repro.models.attention``): causal GQA attention for the
forward and prefill, and one-token attention against the KV cache for
decode, in the JAX package's grouped-query layout: ``q [B, S, K, G, D]``
(K key/value heads, G query heads per KV head), ``k``/``v [B, S, K, D]``.

``flash_attention`` and ``decode_attention`` are the wrappers of
:mod:`repro_torch.kernels.attention`: on CUDA tensors the hand-written
kernels (``csrc/attention.cu``), on CPU tensors their plain versions
(:func:`flash_attention_ref`, :func:`decode_attention_ref`).

The fused-backward flash attention of training and the sliding-window
attention of the hybrid family wait for later slices of the port.
"""

from __future__ import annotations

from repro_torch.kernels.attention import decode_attention, flash_attention
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref

__all__ = [
    "flash_attention",
    "decode_attention",
    "flash_attention_ref",
    "decode_attention_ref",
    "flash_attention_fused",
    "local_attention",
]


def flash_attention_fused(*args, **kwargs):
    raise NotImplementedError(
        "flash_attention_fused (the fused-backward flash attention of training) is not "
        "ported yet: ROADMAP queue 1, LM item 1 (training)")


def local_attention(*args, **kwargs):
    raise NotImplementedError(
        "local_attention (the hybrid family's sliding window) is not ported yet: "
        "ROADMAP queue 1, LM item 4 (local_attention and rglru)")
