"""AdamW, gradient clipping and learning-rate schedules
(``repro.optim.adamw``), without ``torch.optim``.

The optimizer state is congruent with the parameters: ``m`` and ``v`` map
each parameter's name (``nn.Module.named_parameters``) to a float32
tensor of its shape, and ``step`` is an int32 tensor on their device.  All
moment maths runs in float32.  Unlike the JAX function, which returns new
trees, :func:`adamw_update` updates the parameters, the moments and the
step in place (under ``torch.no_grad()``): at full width a second copy
would cost a tensor per parameter.  The clip's scale, the moments, the
bias corrections, the weight decay and the parameters are one fused pass
over every leaf (:func:`repro_torch.kernels.adamw.adamw_fused`: the CUDA
kernel of row 10 on the card, its plain version on the CPU), which leaves
the gradients as they were.  The schedule runs from the step count in the
state, as JAX's does, on the card with no host synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch
from torch import nn

from repro_torch.kernels.adamw import adamw_fused

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm",
           "clip_scale", "make_schedule", "named_tensors", "step_scalars"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant


def named_tensors(params) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or a mapping as given."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> dict:
    """Zero moments, float32, one per parameter, and ``step`` 0 (int32)."""
    named = named_tensors(params)
    dev = next(iter(named.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": {n: zeros(p) for n, p in named.items()},
            "v": {n: zeros(p) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = list(tree.values())
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))


def clip_scale(grads: Mapping[str, torch.Tensor], max_norm: float):
    """``(scale, norm)``: the factor that brings ``grads`` to a global norm
    of at most ``max_norm``, and their norm, 0-d float32 tensors."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scales ``grads`` (float32) in place to a global norm of at most
    ``max_norm``; returns ``(grads, norm before the clip)``."""
    scale, norm = clip_scale(grads, max_norm)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, norm


def make_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step`` (int tensor) -> learning rate (float32 tensor): linear
    warm-up, then cosine, linear or constant decay to ``total_steps``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            decay = 1.0
        else:
            frac = torch.clamp((step - cfg.warmup_steps)
                               / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            if cfg.schedule == "linear":
                decay = 1.0 - frac
            else:  # cosine
                decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.lr * warm * decay

    return sched


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, torch.Tensor], state: dict, cfg: AdamWConfig):
    """One AdamW step in place.  ``params`` a module or ``{name: tensor}``
    (float32), ``grads`` float32 ``{name: tensor}`` with the same names
    (left as they are), ``state`` from :func:`adamw_init` (its moments and
    step updated in place).  Returns ``(params, state, {"grad_norm",
    "lr"})``, the metrics float32 tensors on the parameters' device."""
    named = named_tensors(params)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    lr, bc1, bc2 = step_scalars(state, cfg)
    adamw_fused([p.detach() for p in named.values()], [grads[n] for n in named],
                [state["m"][n] for n in named], [state["v"][n] for n in named],
                lr, bc1, bc2, scale, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                weight_decay=cfg.weight_decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def step_scalars(state: dict, cfg: AdamWConfig):
    """Adds one to ``state["step"]`` in place and returns ``(lr, 1 - b1^t,
    1 - b2^t)`` at the new step ``t``, 0-d float32 tensors on its device."""
    state["step"] += 1
    step = state["step"]
    lr = make_schedule(cfg)(step)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    return lr, bc1, bc2
