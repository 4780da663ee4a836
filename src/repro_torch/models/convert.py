"""Carry the JAX package's decoder parameters and training state over to
the port, and back.

:func:`params_from_jax` takes the tree of ``repro.models.decoder``
``init_decoder`` with numpy leaves (``jax.tree.map(np.asarray, params)``):
``embed``, ``final_norm``, ``unembed`` (unless tied) and
``groups[gi]["p{i}"]``, whose leaves stack a group's ``repeat`` layers on
a leading ``R`` axis; a MoE layer's ``moe`` subtree (``router``, ``w_in``,
``w_gate``, ``w_out`` and the shared experts' ``shared``) comes over
under the same names, as do a hybrid layer's ``rglru`` subtree
(``w_gate_in``, ``w_x_in``, ``conv_w``, ``conv_b``, ``w_a``, ``w_i``,
``lambda``, ``w_out``) and a ``local`` layer's ``attn``.  It returns the
port's :class:`Decoder` with the same values, on the card unless
``device`` names another (raising where there is none), as every entry
point of the port.  Float32 parameters are
trainable (``Policy.param_dtype``).  :func:`train_state_from_jax` carries
a whole ``repro.steps.train`` state (``params``, ``opt.m``, ``opt.v``,
``opt.step`` and, where present, ``ef``), the moments and residuals as
``{name: tensor}`` congruent with the parameters; :func:`to_jax_layout`
gives any of these back as numpy leaves in JAX's layout, so that a test
compares leaf by leaf.  :func:`jax_layout_views` gives the same tree over
the live tensors themselves, a stacked leaf as a :class:`StackedLeaf` of
its repeats: what a checkpoint of a training state saves and restores in
place, under the leaf names of the JAX package's checkpoints.  The parity
tests use them with ``device="cpu"``; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.decoder import Attention, Decoder, DecoderLayer, Norm, check_supported
from repro_torch.models.ffn import DenseFFN, MoEFFN
from repro_torch.models.rglru import RGLRUBlock

__all__ = ["params_from_jax", "train_state_from_jax", "to_jax_layout", "jax_layout_views",
           "StackedLeaf"]


def params_from_jax(tree: dict, cfg: ArchConfig, *, device=None,
                    dtype: torch.dtype = torch.float32) -> Decoder:
    """The port's parameters of ``tree``, on ``device`` in ``dtype``."""
    check_supported(cfg)
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)

    def norm(p) -> Norm:
        return Norm(t(p["scale"]), t(p["bias"]) if "bias" in p else None)

    def dense(f, r) -> DenseFFN:
        return DenseFFN(t(f["w_in"][r]), t(f["w_out"][r]),
                        t(f["w_gate"][r]) if "w_gate" in f else None)

    def moe(m, r) -> MoEFFN:
        return MoEFFN(t(m["router"][r]), t(m["w_in"][r]), t(m["w_out"][r]),
                      t(m["w_gate"][r]) if "w_gate" in m else None,
                      dense(m["shared"], r) if "shared" in m else None)

    def attn(a, r) -> Attention:
        bias = [t(a[n][r]) for n in ("bq", "bk", "bv")] if "bq" in a else []
        return Attention(t(a["wq"][r]), t(a["wk"][r]), t(a["wv"][r]), t(a["wo"][r]), *bias)

    def rglru(b, r) -> RGLRUBlock:
        return RGLRUBlock(*(t(b[n][r]) for n in ("w_gate_in", "w_x_in", "conv_w", "conv_b", "w_a",
                                                 "w_i", "lambda", "w_out")))

    groups = []
    for gi, group in enumerate(cfg.layer_groups()):
        g = {}
        for i in range(len(group.specs)):
            st = tree["groups"][gi][f"p{i}"]
            layers = []
            for r in range(group.repeat):
                layers.append(DecoderLayer(
                    Norm(t(st["norm1"]["scale"][r]),
                         t(st["norm1"]["bias"][r]) if "bias" in st["norm1"] else None),
                    attn(st["attn"], r) if "attn" in st else None,
                    Norm(t(st["norm2"]["scale"][r]),
                         t(st["norm2"]["bias"][r]) if "bias" in st["norm2"] else None),
                    ffn=dense(st["ffn"], r) if "ffn" in st else None,
                    moe=moe(st["moe"], r) if "moe" in st else None,
                    rglru=rglru(st["rglru"], r) if "rglru" in st else None))
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


class StackedLeaf:
    """A leaf of JAX's layout that stacks a layer group's ``R`` repeats on
    a leading axis, over the port's ``R`` tensors (one a repeat), without
    copying them: ``shape`` and ``dtype`` are the stacked leaf's,
    ``np.asarray`` stacks the parts into a new host array, and
    ``copy_(src)`` writes ``src[r]`` into part ``r`` in place."""

    __slots__ = ("parts",)

    def __init__(self, parts: list[torch.Tensor]):
        self.parts = parts

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = torch.empty(self.shape, dtype=self.dtype)
        for r, t in enumerate(self.parts):
            out[r].copy_(t.detach())
        arr = out.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)

    def copy_(self, src: torch.Tensor) -> "StackedLeaf":
        for r, t in enumerate(self.parts):
            t.copy_(src[r])
        return self


def _layout(named: Mapping[str, torch.Tensor], cfg: ArchConfig, leaf, stack) -> dict:
    """The parameters' tree in JAX's layout: ``leaf(t)`` of each unstacked
    tensor, ``stack([t0, t1, ...])`` of each group's repeats."""
    tree: dict = {"groups": [{f"p{i}": {} for i in range(len(g.specs))}
                             for g in cfg.layer_groups()]}
    stacks: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "groups":  # groups.{gi}.p{i}.{r}.{module}[.{sub}].{leaf}
            gi, key, r, path = int(parts[1]), parts[2], int(parts[3]), tuple(parts[4:])
            stacks.setdefault((gi, key, path), {})[r] = t
        elif len(parts) == 1:
            tree[parts[0]] = leaf(t)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = leaf(t)
    for (gi, key, path), by_r in stacks.items():
        node = tree["groups"][gi][key]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = stack([by_r[r] for r in range(len(by_r))])
    return tree


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _jax_params(named: Mapping[str, torch.Tensor], cfg: ArchConfig) -> dict:
    return _layout(named, cfg, _host_f32, lambda ts: np.stack([_host_f32(t) for t in ts]))


def _views(named: Mapping[str, torch.Tensor], cfg: ArchConfig) -> dict:
    return _layout({n: t.detach() for n, t in named.items()}, cfg, lambda t: t, StackedLeaf)


def _state_tree(tree, cfg: ArchConfig, params_fn, step_fn) -> dict:
    if isinstance(tree, nn.Module):
        return params_fn(dict(tree.named_parameters()), cfg)
    if "params" in tree:
        opt = tree["opt"]
        out = {"params": _state_tree(tree["params"], cfg, params_fn, step_fn),
               "opt": {"m": params_fn(opt["m"], cfg), "v": params_fn(opt["v"], cfg),
                       "step": step_fn(opt["step"])}}
        if tree.get("ef") is not None:
            out["ef"] = params_fn(tree["ef"], cfg)
        return out
    return params_fn(tree, cfg)


def to_jax_layout(tree, cfg: ArchConfig) -> dict:
    """Numpy leaves in the JAX package's layout, float32, from the port's
    parameters (a :class:`Decoder` or ``{name: tensor}``) or from a whole
    training state (``{"params", "opt": {"m", "v", "step"}, "ef"?}``)."""
    return _state_tree(tree, cfg, _jax_params,
                       lambda step: np.asarray(int(step), dtype=np.int32))


def jax_layout_views(tree, cfg: ArchConfig) -> dict:
    """:func:`to_jax_layout`'s tree over the live tensors: each leaf the
    port's tensor itself (detached) or a :class:`StackedLeaf` of a group's
    repeats, and ``opt.step`` the state's int32 tensor.  Saving it writes
    the JAX package's leaves; restoring into it (``restore_checkpoint(...,
    into=True)``) writes the checkpoint into the state in place."""
    return _state_tree(tree, cfg, _views, lambda step: step)
