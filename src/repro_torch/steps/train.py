"""Train and serve steps (``repro.steps.train``).

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with:

* microbatch gradient accumulation: each microbatch's gradient of
  ``loss / n_microbatches`` is added into the parameters' ``.grad``
  (float32), so no second copy of the gradients is kept;
* float32 master parameters and bf16 compute (``Policy``);
* AdamW with global-norm clipping and the schedule
  (:mod:`repro_torch.optim.adamw`);
* an optional hook on the accumulated gradients before the optimizer,
  such as the int8 error-feedback compression of
  :mod:`repro_torch.runtime.compression`.

Where JAX returns a new state, the port updates the state it is given in
place (parameters, moments, step, ``ef``) and returns it; the gradients
are dropped (``.grad = None``) when the step ends.

``make_prefill_step`` / ``make_decode_step`` are the serving halves
(``serve_step`` in the brief is the decode step).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.steps.loss import softmax_xent

__all__ = ["TrainState", "init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]

TrainState = dict  # {"params": Decoder, "opt": {"m", "v", "step"}, optionally "ef"}


def init_train_state(model: Model, key, opt_cfg: AdamWConfig) -> TrainState:
    """Fresh trainable float32 parameters from ``model.init(key)`` (a seed
    or a ``torch.Generator``) and zero AdamW state."""
    params = model.init(key)
    return {"params": params, "opt": adamw_init(params)}


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, n_microbatches: int = 1,
                    compress_grads: Callable | None = None):
    def loss_fn(params, tokens, labels, extras):
        logits, aux = model.forward(params, tokens, extras)
        loss, metrics = softmax_xent(logits, labels)
        return loss + 1e-2 * aux.get("aux_loss", 0.0), metrics

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        B = tokens.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} is not a multiple of {n_microbatches} microbatches")
        mb = B // n_microbatches
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None

        if n_microbatches == 1:
            loss, metrics = loss_fn(params, tokens, labels, extras)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_microbatches):
                part = slice(i * mb, (i + 1) * mb)
                l_i, _ = loss_fn(params, tokens[part], labels[part],
                                 {k: v[part] for k, v in extras.items()})
                (l_i / n_microbatches).backward()
                loss += l_i.detach() / n_microbatches
            metrics = {}
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}

        if compress_grads is not None:
            grads, state = compress_grads(grads, state)

        _, state["opt"], opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        for p in named.values():
            p.grad = None
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(model: Model, pad_cache_to: int | None = None):
    def prefill_step(params, tokens, extras=None):
        return model.prefill(params, tokens, extras, pad_cache_to=pad_cache_to)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, cache):
        return model.decode(params, token, cache)

    return decode_step
