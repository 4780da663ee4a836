"""LM attention (``repro.models.attention``): causal GQA attention for the
forward and prefill, its fused-backward form for training, and one-token
attention against the KV cache for decode, in the JAX package's
grouped-query layout: ``q [B, S, K, G, D]`` (K key/value heads, G query
heads per KV head), ``k``/``v [B, S, K, D]``.

``flash_attention`` and ``decode_attention`` are the wrappers of
:mod:`repro_torch.kernels.attention`: on CUDA tensors the hand-written
kernels (``csrc/attention.cu``), on CPU tensors their plain versions
(:func:`flash_attention_ref`, :func:`decode_attention_ref`).
:func:`flash_attention_fused` is ``flash_attention`` with the JAX
package's custom VJP: its forward is row 7 with the log-sum-exp, its
backward row 9 (``csrc/attention_bwd.cu``), and it keeps only ``(q, k,
v, out, lse)`` for the backward.

``local_attention`` (the hybrid family's sliding window: key ``j`` seen
by query ``i`` iff ``i - window < j <= i``) is the wrapper of row 13, the
flash kernel with a window, and on CPU tensors its plain version
:func:`local_attention_ref` (JAX's blocks of ``w`` queries against key
blocks ``i - 1`` and ``i``).  It has no backward kernel yet: on the card it
raises under grad; on the CPU the plain version is differentiable.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import attention as kattn
from repro_torch.kernels.attention import decode_attention, flash_attention, local_attention
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref, local_attention_ref

__all__ = [
    "flash_attention",
    "decode_attention",
    "flash_attention_ref",
    "decode_attention_ref",
    "flash_attention_fused",
    "local_attention",
    "local_attention_ref",
]


class _FlashFused(torch.autograd.Function):
    """Residuals ``(q, k, v, out, lse)`` as JAX's ``_flash_fused_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block):
        out, lse = kattn.flash_attention_fwd(q, k, v, causal=causal, q_block=q_block,
                                             kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_block, kv_block = ctx.opts
        dq, dk, dv = kattn.flash_attention_bwd(q, k, v, out, lse, do.contiguous(), causal=causal,
                                               q_block=q_block, kv_block=kv_block)
        return dq, dk, dv, None, None, None


def flash_attention_fused(q, k, v, causal: bool = True, q_block: int = 512,
                          kv_block: int = 1024, parallel_q: bool = False):
    """Flash attention with O(S) residuals (``repro.models.attention``
    ``flash_attention_fused``): the same output as :func:`flash_attention`,
    and a backward that recomputes the scores block by block from
    ``(q, k, v, out, lse)``.  ``parallel_q`` is the JAX package's sharding
    hint for GSPMD; it changes no value and is accepted and ignored."""
    del parallel_q
    return _FlashFused.apply(q, k, v, causal, q_block, kv_block)
