"""Serving steps (``repro.steps.train``): ``make_prefill_step`` and
``make_decode_step`` (the decode step is the brief's ``serve_step``).

The training step, its loss and the optimizers come with the training
slice of the port (ROADMAP queue 1, LM item 1); ``make_train_step`` raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

from repro_torch.models.registry import Model

__all__ = ["make_prefill_step", "make_decode_step", "make_train_step"]


def make_prefill_step(model: Model, pad_cache_to: int | None = None):
    def prefill_step(params, tokens, extras=None):
        return model.prefill(params, tokens, extras, pad_cache_to=pad_cache_to)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, cache):
        return model.decode(params, token, cache)

    return decode_step


def make_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_train_step is not ported yet: ROADMAP queue 1, LM item 1 (training)")
