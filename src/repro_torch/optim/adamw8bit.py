"""Block-wise 8-bit Adam moments (``repro.optim.adamw8bit``; Dettmers et
al., arXiv:2110.02861 style).

Float32 Adam keeps 8 bytes of moments a parameter.  Quantizing both to
int8 in blocks of 128 elements, each with one float32 scale, keeps about
2.06: ``m`` signed and zero-symmetric (``scale = absmax / 127``), ``v``
non-negative with an unsigned scale (``scale = max / 255``, stored as
``q - 128``).  Each step dequantizes, applies the AdamW law of
:mod:`repro_torch.optim.adamw` and requantizes; the quantization error
acts as bounded noise on the moments.

The state is ``{"m8": {name: {"mq", "ms", "vq", "vs"}}, "step"}``, keyed
by the parameters' names as :func:`repro_torch.optim.adamw.adamw_init`'s
moments are: ``mq``/``vq`` int8 ``[nblocks, 128]``, ``ms``/``vs`` float32
``[nblocks]``.  Where JAX returns new trees, :func:`adamw8bit_update`
updates the parameters, the moments and the step in place, in one fused
pass over every leaf (:func:`repro_torch.kernels.adamw.adamw8bit_fused`:
the CUDA kernel of row 11 on the card, which keeps no float32 moment in
device memory, and its plain version on the CPU).
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.kernels.adamw import adamw8bit_fused
from repro_torch.kernels.ref import QUANT_BLOCK, dequantize_blockwise, quantize_blockwise
from repro_torch.optim.adamw import AdamWConfig, clip_scale, named_tensors, step_scalars

__all__ = ["adamw8bit_init", "adamw8bit_update", "quantize_blockwise", "dequantize_blockwise"]


def adamw8bit_init(params) -> dict:
    """Zero moments in the 8-bit format, one per parameter (``v`` stored as
    ``q - 128 = -128``), and ``step`` 0 (int32)."""
    named = named_tensors(params)
    dev = next(iter(named.values())).device

    def one(p: torch.Tensor) -> dict:
        nb = -(-p.numel() // QUANT_BLOCK)
        return {"mq": torch.zeros((nb, QUANT_BLOCK), dtype=torch.int8, device=p.device),
                "ms": torch.zeros((nb,), dtype=torch.float32, device=p.device),
                "vq": torch.full((nb, QUANT_BLOCK), -128, dtype=torch.int8, device=p.device),
                "vs": torch.zeros((nb,), dtype=torch.float32, device=p.device)}

    return {"m8": {n: one(p) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw8bit_update(params, grads: Mapping[str, torch.Tensor], state: dict, cfg: AdamWConfig):
    """:func:`repro_torch.optim.adamw.adamw_update`'s law over int8-backed
    moments, in place.  Returns ``(params, state, {"grad_norm", "lr"})``."""
    named = named_tensors(params)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    lr, bc1, bc2 = step_scalars(state, cfg)
    adamw8bit_fused([p.detach() for p in named.values()], [grads[n] for n in named],
                    [state["m8"][n] for n in named], lr, bc1, bc2, scale, b1=cfg.b1, b2=cfg.b2,
                    eps=cfg.eps, weight_decay=cfg.weight_decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}
