"""Carry the JAX package's decoder parameters and training state over to
the port, and back.

:func:`params_from_jax` takes the tree of ``repro.models.decoder``
``init_decoder`` with numpy leaves (``jax.tree.map(np.asarray, params)``):
``embed``, ``final_norm``, ``unembed`` (unless tied) and
``groups[gi]["p{i}"]``, whose leaves stack a group's ``repeat`` layers on
a leading ``R`` axis.  It returns the port's :class:`Decoder` with the
same values, on the card unless ``device`` names another (raising where
there is none), as every entry point of the port.  Float32 parameters are
trainable (``Policy.param_dtype``).  :func:`train_state_from_jax` carries
a whole ``repro.steps.train`` state (``params``, ``opt.m``, ``opt.v``,
``opt.step`` and, where present, ``ef``), the moments and residuals as
``{name: tensor}`` congruent with the parameters; :func:`to_jax_layout`
gives any of these back as numpy leaves in JAX's layout, so that a test
compares leaf by leaf.  The parity tests use them with ``device="cpu"``;
nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.decoder import Attention, Decoder, DecoderLayer, Norm, check_supported
from repro_torch.models.ffn import DenseFFN

__all__ = ["params_from_jax", "train_state_from_jax", "to_jax_layout"]


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


def _congruent(tree: dict, cfg: ArchConfig, device) -> dict[str, torch.Tensor]:
    """A JAX tree laid out as the parameters (moments, residuals) as
    ``{name: float32 tensor}`` under the port's parameter names."""
    mod = params_from_jax(tree, cfg, device=device, dtype=torch.float32)
    return {n: p.detach() for n, p in mod.named_parameters()}


def train_state_from_jax(state: dict, cfg: ArchConfig, *, device=None) -> dict:
    """The port's training state (:func:`repro_torch.steps.train.init_train_state`'s
    layout) with the values of a JAX state whose leaves are numpy arrays."""
    device = resolve_device(device)
    opt = state["opt"]
    out = {"params": params_from_jax(state["params"], cfg, device=device),
           "opt": {"m": _congruent(opt["m"], cfg, device), "v": _congruent(opt["v"], cfg, device),
                   "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                        device=device)}}
    if state.get("ef") is not None:
        out["ef"] = _congruent(state["ef"], cfg, device)
    return out


def _jax_params(named: Mapping[str, torch.Tensor], cfg: ArchConfig) -> dict:
    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    tree: dict = {"groups": [{f"p{i}": {} for i in range(len(g.specs))}
                             for g in cfg.layer_groups()]}
    stacks: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "groups":  # groups.{gi}.p{i}.{r}.{module}.{leaf}
            gi, key, r, mod, leaf = int(parts[1]), parts[2], int(parts[3]), parts[4], parts[5]
            stacks.setdefault((gi, key, mod, leaf), {})[r] = a(t)
        elif len(parts) == 1:
            tree[parts[0]] = a(t)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = a(t)
    for (gi, key, mod, leaf), by_r in stacks.items():
        tree["groups"][gi][key].setdefault(mod, {})[leaf] = np.stack(
            [by_r[r] for r in range(len(by_r))])
    return tree


def to_jax_layout(tree, cfg: ArchConfig) -> dict:
    """Numpy leaves in the JAX package's layout, float32, from the port's
    parameters (a :class:`Decoder` or ``{name: tensor}``) or from a whole
    training state (``{"params", "opt": {"m", "v", "step"}, "ef"?}``)."""
    if isinstance(tree, nn.Module):
        return _jax_params(dict(tree.named_parameters()), cfg)
    if "params" in tree:
        opt = tree["opt"]
        out = {"params": to_jax_layout(tree["params"], cfg),
               "opt": {"m": _jax_params(opt["m"], cfg), "v": _jax_params(opt["v"], cfg),
                       "step": np.asarray(int(opt["step"]), dtype=np.int32)}}
        if tree.get("ef") is not None:
            out["ef"] = _jax_params(tree["ef"], cfg)
        return out
    return _jax_params(tree, cfg)
