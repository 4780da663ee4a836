"""Cross-entropy loss over the logits (``repro.steps.loss``).

Computed in float32 with the max-shifted log-sum-exp, the max carrying no
gradient (JAX's ``stop_gradient``), plus the z-loss ``z_loss_coeff *
lse**2`` that keeps the softmax normaliser near 1 (PaLM-style).
"""

from __future__ import annotations

import torch

__all__ = ["softmax_xent"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, z_loss_coeff: float = 1e-4,
                 mask: torch.Tensor | None = None):
    """``logits [B, S, V]`` (any float dtype), ``labels [B, S]`` (integer),
    ``mask [B, S]`` or None -> ``(mean loss, {"nll", "accuracy"})``; the
    metrics carry no gradient."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]  # [B, S]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    per_tok = nll + z_loss_coeff * lse.square()
    with torch.no_grad():
        hit = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (per_tok * mask).sum() / denom
        acc = (hit * mask).sum() / denom
        nll = nll * mask
    else:
        loss = per_tok.mean()
        acc = hit.mean()
    return loss, {"nll": nll.detach().mean(), "accuracy": acc}
