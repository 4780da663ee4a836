"""Int8 error-feedback gradient compression (``repro.runtime.compression``).

Quantising gradients to int8 with one scale per leaf cuts the bytes of a
data-parallel all-reduce 4x against float32; error feedback carries the
residual ``g - Q(g)`` in the training state and adds it back before the
next quantisation, so the compression is unbiased in the long run.
:func:`make_compressor` returns the hook that
:func:`repro_torch.steps.train.make_train_step` calls after the
microbatches' accumulation and before the optimizer.

The error-feedback state ``ef`` is congruent with the parameters: it maps
each parameter's name to a float32 tensor of its shape.  The hook updates
the gradients and ``ef`` in place and returns the state it was given,
where JAX returns new trees.  The scale is one per JAX leaf: where the
JAX tree stacks a layer group's repeats on one ``R`` axis, the port holds
one tensor per repeat (``groups.{gi}.p{i}.{r}.<leaf>``), and those share
one scale, the max over the group, as the stacked leaf has.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["make_compressor", "init_error_feedback", "quantize_int8", "dequantize_int8"]


def _scale(leaves) -> torch.Tensor:
    return torch.clamp(torch.stack([t.abs().max() for t in leaves]).max(), min=1e-30) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor):
    """``(q int8, scale f32)``: ``scale = max(max |g|, 1e-30) / 127`` and
    ``q = clip(round(g / scale), -127, 127)`` (round half to even)."""
    scale = _scale([g])
    return _quantize(g, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _jax_leaf(name: str) -> str:
    """The JAX leaf a parameter belongs to: its name without the repeat
    index of a layer group (``groups.{gi}.p{i}.{r}.attn.wq`` ->
    ``groups.{gi}.p{i}.attn.wq``)."""
    parts = name.split(".")
    if len(parts) > 4 and parts[0] == "groups" and parts[3].isdigit():
        return ".".join(parts[:3] + parts[4:])
    return name


def make_compressor():
    """Hook ``(grads, state) -> (grads', state')`` over ``{name: tensor}``
    gradients; adds ``state["ef"]`` on first use if it is missing or None.
    (The JAX package's ``quantized_allreduce`` flag steers its lowered
    collectives and changes no value; the port has none.)"""

    @torch.no_grad()
    def compress(grads: dict[str, torch.Tensor], state: dict):
        if state.get("ef") is None:
            state["ef"] = init_error_feedback(grads)
        ef = state["ef"]
        leaves: dict[str, list[str]] = {}
        for name in grads:
            leaves.setdefault(_jax_leaf(name), []).append(name)
        for names in leaves.values():
            g32 = [grads[n].float().add_(ef[n]) for n in names]  # in place when float32
            scale = _scale(g32)
            for n, g in zip(names, g32):
                deq = dequantize_int8(_quantize(g, scale), scale)
                ef[n].copy_(g - deq)
                grads[n] = g.copy_(deq)
        return grads, state

    return compress
