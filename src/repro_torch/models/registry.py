"""Model registry (``repro.models.registry``): ArchConfig -> Model.

``Model`` carries the JAX package's fields, ``init``, ``forward``,
``prefill``, ``decode`` and ``init_cache``, as functions over the port's
parameters (:class:`~repro_torch.models.decoder.Decoder`) on one device.
``build_model(cfg)`` without a device serves on the card and raises
where there is none, as every entry point of the port does; the parity
tests pass ``device="cpu"``.  ``forward``, ``prefill`` and ``decode`` raise
``ValueError`` when the parameters, tokens or cache lie on another device
than the model's.

``init(seed)`` gives trainable float32 master parameters (``forward``
then builds the graph of training under grad mode).  Serving weights:
``init(seed, dtype=Policy.compute_dtype)`` draws each weight in float32
and casts it once to the compute dtype, which is what the JAX package's
``_w`` casts at every use; they are frozen.  The ``attn`` layer stacks
with ``dense`` and ``moe`` FFNs are ported (the dense and MoE families:
deepseek-moe-16b, dbrx-132b), and the hybrid family's ``local`` and
``rglru`` layers with dense FFNs (recurrentgemma-9b); the encoder-decoder
and SSM families raise ``NotImplementedError``.  A MoE or hybrid model
serves (prefill, decode, the forward without grad) on the card; its
forward under grad runs on the CPU only, as rows 12, 13 and 14 have no
backward yet (on the card they raise ``NotImplementedError``: ROADMAP
queue 1, LM items 7 and 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import decoder as dec

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]  # (seed or torch.Generator, dtype=None) -> params
    forward: Callable[..., Any]  # (params, tokens, extras) -> (logits, aux)
    prefill: Callable[..., Any]  # (params, tokens, extras, pad_cache_to) -> (logits, cache)
    decode: Callable[..., Any]  # (params, token, cache) -> (logits, cache)
    init_cache: Callable[..., Any]  # (batch, max_len) -> cache
    device: torch.device

    def extras_shapes(self, batch: int) -> dict:
        """Modality-stub inputs: none for the decoder-only families."""
        return {}


def _check_device(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, the model on {dev}")


def build_model(cfg: ArchConfig, device=None) -> Model:
    dec.check_supported(cfg)
    dev = resolve_device(device)

    def init(seed, dtype: torch.dtype | None = None):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(dev).manual_seed(int(seed))
        return dec.init_decoder(gen, cfg, dtype=dtype)

    def forward(params, tokens, extras=None):
        _check_device(dev, params=params.embed, tokens=tokens)
        return dec.decoder_forward(params, tokens, cfg)

    def prefill(params, tokens, extras=None, pad_cache_to=None):
        _check_device(dev, params=params.embed, tokens=tokens)
        return dec.decoder_prefill(params, tokens, cfg, pad_cache_to=pad_cache_to)

    def decode(params, token, cache):
        _check_device(dev, params=params.embed, tokens=token, cache=cache["pos"])
        return dec.decoder_decode(params, token, cache, cfg)

    def init_cache(batch, max_len):
        return dec.init_cache(cfg, batch, max_len, device=dev)

    return Model(cfg, init, forward, prefill, decode, init_cache, dev)
