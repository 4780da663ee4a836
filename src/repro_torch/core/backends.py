"""Pluggable verification backends behind one registry (``repro.core.backends``).

A backend is ONE class implementing

* :meth:`Backend.build_index`    — host-side index build (filter phase),
* :meth:`Backend.count`          — single-query device count (verify phase),
* :meth:`Backend.prepare_batch`  — host-side batch stacking (filter phase),
* :meth:`Backend.count_batch`    — one batched device dispatch (verify phase),

registered with :func:`register_backend` and resolved with
:func:`get_backend`.  The split between ``prepare_batch`` and
``count_batch`` keeps the paper's two-stage timing honest: host work
lands in ``t_filter_s``, the device dispatch (and the copy of its counts
back to the host, which waits for it) in ``t_verify_s``.

Built-in backends (all produce identical verdict sets):

* ``"dense"``     — the hand-written CUDA ray-cast kernel
                    (``repro_torch/csrc/raycast.cu``) over the padded scene.
* ``"dense-ref"`` — the plain PyTorch version of the same count.
* ``"brute"``     — exact distance-rank counting (no geometry; baseline),
                    plain PyTorch as in the JAX package.

The grid, grid-pallas, BVH and ``auto`` planner backends of the JAX
package are not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch

from repro_torch.core.geometry import Rect
from repro_torch.core.scene import Scene, _next_pad, pad_scene_arrays
from repro_torch.kernels import ops as _ops

__all__ = [
    "Backend",
    "QueryRequest",
    "BatchRequest",
    "register_backend",
    "get_backend",
    "available_backends",
    "DenseBackend",
    "DenseRefBackend",
    "BruteBackend",
]


@dataclasses.dataclass
class QueryRequest:
    """Everything a backend may need for one single-query count.

    Geometric backends read ``xs/ys`` + ``scene`` (+ ``index``); the
    geometry-free brute backend reads ``users/facilities/q_pt/exclude``
    and puts them on ``device``.
    """

    xs: torch.Tensor | None  # [N] f32 user x on the engine's device
    ys: torch.Tensor | None  # [N] f32 user y
    k: int
    device: torch.device
    scene: Scene | None = None
    index: Any = None
    users: np.ndarray | None = None  # [N, 2] f64
    facilities: np.ndarray | None = None  # [M, 2] f64
    q_pt: np.ndarray | None = None  # [2]
    exclude: int | None = None


@dataclasses.dataclass
class BatchRequest:
    """One batched multi-query count over a shared user set.

    ``mp`` is the static triangle pad target for stacked dense scenes
    (power-of-two bucketed by the engine so repeat workloads reuse one
    stacked shape).
    """

    xs: torch.Tensor | None  # [N] f32
    ys: torch.Tensor | None  # [N] f32
    k: int
    device: torch.device
    rect: Rect | None = None
    scenes: list[Scene] | None = None
    indexes: list | None = None
    users: np.ndarray | None = None
    facilities: np.ndarray | None = None
    q_pts: np.ndarray | None = None  # [Q, 2]
    excludes: list[int | None] | None = None
    mp: int | None = None


class Backend:
    """Protocol + default implementations for a verification backend."""

    name: ClassVar[str]
    #: False for geometry-free backends (no scene construction at all);
    #: the engine skips the whole filter phase for them.
    uses_scene: ClassVar[bool] = True

    # ---- filter phase (host) --------------------------------------------
    def build_index(self, scene: Scene, *, memo: dict | None = None):
        """Host-side per-scene index build; ``None`` if unused.

        ``memo`` is the engine snapshot's per-scene index store (a plain
        dict scoped to ``scene``).
        """
        return None

    def prepare_batch(self, req: BatchRequest):
        """Host-side batch stacking; the returned object is what
        :meth:`count_batch` dispatches.  Runs inside ``t_filter_s``."""
        return None

    # ---- verify phase (device) ------------------------------------------
    def count(self, req: QueryRequest) -> np.ndarray:
        """``[N]`` int32 hit counts for one query."""
        raise NotImplementedError

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        """``[Q, N]`` int32 hit counts in one batched device dispatch."""
        raise NotImplementedError


_REGISTRY: dict[str, Backend] = {}


def register_backend(cls: type[Backend]) -> type[Backend]:
    """Class decorator: instantiate and register under ``cls.name``.

    Later registrations override earlier ones (so tests / downstream code
    can shadow a built-in with an instrumented variant).
    """
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"backend must be one of {available_backends()}, got {name!r}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


# --------------------------------------------------------------------------
# Dense (stacked edge functions, no index)
# --------------------------------------------------------------------------


@register_backend
class DenseBackend(Backend):
    """The CUDA ray-cast kernel over the full padded scene."""

    name = "dense"
    kernel_backend = "cuda"

    def count(self, req: QueryRequest) -> np.ndarray:
        coeffs = torch.from_numpy(req.scene.coeffs).to(req.device)
        return _ops.raycast_count(
            req.xs, req.ys, coeffs, backend=self.kernel_backend
        ).cpu().numpy()

    def prepare_batch(self, req: BatchRequest) -> torch.Tensor:
        scenes = req.scenes
        # size the stacked pad from the REAL triangle counts: scenes arrive
        # pre-padded (possibly to a much larger sticky bucket), and sizing
        # from tris.shape[0] over-pads the whole [Q, Mp, 3, 3] stack on the
        # one-shot shim path (req.mp None)
        mp = (
            req.mp
            if req.mp is not None
            else _next_pad(max(s.n_tris for s in scenes))
        )
        stacked = np.stack(
            [
                pad_scene_arrays(
                    s.tris[: s.n_tris], s.coeffs[: s.n_tris], s.owner[: s.n_tris], mp
                )[1]
                for s in scenes
            ]
        ).astype(np.float32)  # [Q, Mp, 3, 3]
        # the upload belongs to the filter phase, and the batch LRU then
        # keeps the stack resident on the device
        return torch.from_numpy(stacked).to(req.device)

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        return _ops.raycast_count_batch(
            req.xs, req.ys, prepared, backend=self.kernel_backend
        ).cpu().numpy()


@register_backend
class DenseRefBackend(DenseBackend):
    """The plain PyTorch version of the dense count, on the same device."""

    name = "dense-ref"
    kernel_backend = "ref"


# --------------------------------------------------------------------------
# Brute (exact distance-rank counting; no geometry at all)
# --------------------------------------------------------------------------


@register_backend
class BruteBackend(Backend):
    name = "brute"
    uses_scene = False

    def count(self, req: QueryRequest) -> np.ndarray:
        return _ops.rank_count(
            _on(req.users, req.device),
            _on(req.facilities, req.device),
            _on(req.q_pt, req.device),
            exclude=req.exclude,
            backend="ref",
        ).cpu().numpy()

    def count_batch(self, req: BatchRequest, prepared) -> np.ndarray:
        return _ops.rank_count_batch(
            _on(req.users, req.device),
            _on(req.facilities, req.device),
            _on(req.q_pts, req.device),
            exclude=req.excludes,
        ).cpu().numpy()


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as float32 on ``device`` (cast on the host, so the
    rounding is numpy's round-to-nearest on every device)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
