"""RkNN serving — deprecated alias over the stateful engine (``repro.launch.serve``).

The serving pipeline (users uploaded once, per-query scenes built on the
host and double-buffered against the device count, batches optionally
sharded over a mesh) lives in :class:`repro_torch.core.engine.RkNNEngine`.
:class:`RkNNServer` is kept as a thin compatibility wrapper so existing
callers keep working; new code should construct an engine directly:

    eng = RkNNEngine(F, U, RkNNConfig(scene_cache=256), mesh=user_mesh(1))
    for batch, masks in eng.stream(batches, k=10):
        ...

The JAX package's ``lower_rknn_serve`` (a dry-run lowering to XLA HLO on a
production mesh) has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.kernels import ops

__all__ = ["RkNNServer", "ServeStats", "batched_raycast_counts"]


def batched_raycast_counts(xs, ys, coeffs, *, backend: str = "cuda"):
    """``counts[q, u]`` for stacked scenes.  ``xs/ys``: ``[N]``;
    ``coeffs``: ``[Q, M, 3, 3]``.

    :func:`repro_torch.kernels.ops.raycast_count_batch`, the count every
    dense dispatch in the engine runs (the kernel on CUDA tensors), so the
    serving path and the query engine cannot drift apart."""
    return ops.raycast_count_batch(xs, ys, coeffs, backend=backend)


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0
    t_scene_s: float = 0.0
    t_device_s: float = 0.0
    m_max: int = 0


_deprecation_warned = False


def _warn_deprecated_once() -> None:
    """One ``DeprecationWarning`` per process — a serving loop constructs
    servers in bulk and must not flood its logs."""
    global _deprecation_warned
    if _deprecation_warned:
        return
    _deprecation_warned = True
    import warnings

    warnings.warn(
        "RkNNServer is deprecated: construct repro_torch.core.engine.RkNNEngine "
        "(or repro_torch.dynamic.DynamicEngine for mutable snapshots) directly.",
        DeprecationWarning,
        stacklevel=3,
    )


class RkNNServer:
    """DEPRECATED: thin alias over :class:`RkNNEngine` with its default
    backend (``dense``: the ray-cast kernel on the card).

    Preserved surface: ``query_batch(q_indices, k) -> masks [Q, N]``,
    ``serve_stream(batches, k)`` (double-buffered generator), and
    ``stats``.  All state and scheduling live in the engine — including
    the versioned dynamic entry points (``repro_torch.dynamic``), which
    this alias deliberately does not grow.  ``device`` is the engine's
    (``None``: ``"cuda"``).
    """

    def __init__(
        self,
        facilities: np.ndarray,
        users: np.ndarray,
        *,
        mesh=None,
        pad_scene_to: int = 128,
        strategy: str = "infzone",
        scene_cache: int = 0,
        device=None,
    ):
        _warn_deprecated_once()
        self.engine = RkNNEngine(
            facilities,
            users,
            RkNNConfig(
                strategy=strategy,
                scene_cache=scene_cache,
                pad_scene_to=pad_scene_to,
            ),
            mesh=mesh,
            device=device,
        )

    # engine state passthroughs (legacy attribute surface)
    @property
    def facilities(self) -> np.ndarray:
        return self.engine.facilities

    @property
    def users(self) -> np.ndarray:
        return self.engine.users

    @property
    def rect(self):
        return self.engine.rect

    @property
    def mesh(self):
        return self.engine.mesh

    @property
    def strategy(self) -> str:
        return self.engine.config.strategy

    @property
    def pad(self) -> int:
        return self.engine._pad_bucket

    @property
    def stats(self) -> ServeStats:
        s = self.engine.stats
        return ServeStats(
            n_queries=s.n_queries,
            t_scene_s=s.t_filter_s,
            t_device_s=s.t_verify_s,
            m_max=s.m_max,
        )

    def query_batch(self, q_indices, k: int) -> np.ndarray:
        """Masks [Q, N] for a batch of facility-index queries."""
        return self.engine.query_batch([int(q) for q in q_indices], k).masks

    def serve_stream(self, batches, k: int):
        """Double-buffered stream: scene build for batch i+1 overlaps the
        device count of batch i (generator of ``(batch, masks [Q, N])``).
        Producer exceptions re-raise in the consumer."""
        return self.engine.stream(batches, k)
