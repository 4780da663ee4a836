"""Carry the JAX package's decoder parameters over to the port.

:func:`params_from_jax` takes the tree of ``repro.models.decoder``
``init_decoder`` with numpy leaves (``jax.tree.map(np.asarray, params)``):
``embed``, ``final_norm``, ``unembed`` (unless tied) and
``groups[gi]["p{i}"]``, whose leaves stack a group's ``repeat`` layers on
a leading ``R`` axis.  It returns the port's :class:`Decoder` with the
same values, on the card unless ``device`` names another (raising where
there is none), as every entry point of the port.  The parity tests use
it with ``device="cpu"``; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.decoder import Attention, Decoder, DecoderLayer, Norm, check_supported
from repro_torch.models.ffn import DenseFFN

__all__ = ["params_from_jax"]


def params_from_jax(tree: dict, cfg: ArchConfig, *, device=None,
                    dtype: torch.dtype = torch.float32) -> Decoder:
    """The port's parameters of ``tree``, on ``device`` in ``dtype``."""
    check_supported(cfg)
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)

    def norm(p) -> Norm:
        return Norm(t(p["scale"]), t(p["bias"]) if "bias" in p else None)

    groups = []
    for gi, group in enumerate(cfg.layer_groups()):
        g = {}
        for i in range(len(group.specs)):
            st = tree["groups"][gi][f"p{i}"]
            layers = []
            for r in range(group.repeat):
                a, f = st["attn"], st["ffn"]
                bias = [t(a[n][r]) for n in ("bq", "bk", "bv")] if "bq" in a else []
                layers.append(DecoderLayer(
                    Norm(t(st["norm1"]["scale"][r]),
                         t(st["norm1"]["bias"][r]) if "bias" in st["norm1"] else None),
                    Attention(t(a["wq"][r]), t(a["wk"][r]), t(a["wv"][r]), t(a["wo"][r]), *bias),
                    Norm(t(st["norm2"]["scale"][r]),
                         t(st["norm2"]["bias"][r]) if "bias" in st["norm2"] else None),
                    DenseFFN(t(f["w_in"][r]), t(f["w_out"][r]),
                             t(f["w_gate"][r]) if "w_gate" in f else None)))
            g[f"p{i}"] = layers
        groups.append(g)
    unembed = t(tree["unembed"]) if "unembed" in tree else None
    return Decoder(t(tree["embed"]), norm(tree["final_norm"]), groups, unembed)
