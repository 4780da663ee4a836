"""Result containers for the RkNN query surface.

Kept in a leaf module (no intra-``core`` imports) so the engine, the
backend registry, the hybrid dispatcher, and the legacy free functions can
all share them without import cycles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scene import Scene

__all__ = ["RkNNResult", "RkNNBatchResult"]


@dataclasses.dataclass
class RkNNResult:
    """Query result + phase timings (paper's filtering/verification split).

    Following §4.1 we report the two-stage convention of [62]: *filtering*
    = scene construction (pruning + occluders + grid/BVH index build),
    *verification* = the ray-cast / count stage only.

    ``counts`` convention: for bichromatic queries these are raw occluder
    hit counts (saturated at ``k`` for the bvh early-exit backend).  For
    monochromatic queries they are self-hit corrected — ``counts[p]`` is
    the number of *other* points strictly closer to ``p`` than ``q`` is,
    so ``mask == counts < k`` holds in both cases.

    ``version`` is the engine snapshot version the result was served
    from (0 for static engines and one-shot shims) — under concurrent
    updates it identifies exactly which ``(facilities, users)`` state the
    masks are bit-identical to.
    """

    mask: np.ndarray  # [N] bool — u ∈ RkNN(q)
    counts: np.ndarray  # [N] int32 hit counts (saturated for bvh early-exit)
    scene: Scene | None
    t_filter_s: float
    t_verify_s: float
    backend: str
    version: int = 0

    @property
    def result_indices(self) -> np.ndarray:
        return np.flatnonzero(self.mask)


@dataclasses.dataclass
class RkNNBatchResult:
    """Batched multi-query result: per-query masks + amortized timings.

    ``t_filter_s`` covers the whole batch's host work (scene builds,
    padding/stacking, index builds — or a scene-cache lookup when the
    engine has seen the workload before); ``t_verify_s`` is the single
    batched device dispatch.  Per-query attribution is therefore the mean:
    ``t_filter_s / len(qs)`` etc.

    ``scenes`` is ``None`` for the geometry-free brute backend and a
    (possibly empty) list for every geometric backend.
    """

    masks: np.ndarray  # [Q, N] bool — u ∈ RkNN(q_i)
    counts: np.ndarray  # [Q, N] int32 (saturated at k for bvh early-exit)
    scenes: list[Scene] | None  # None for the brute backend
    t_filter_s: float
    t_verify_s: float
    backend: str
    k: int
    #: Engine snapshot version served (see :class:`RkNNResult.version`).
    version: int = 0

    @property
    def n_queries(self) -> int:
        return len(self.masks)

    def result_indices(self, i: int) -> np.ndarray:
        return np.flatnonzero(self.masks[i])

    def per_query(self, i: int) -> RkNNResult:
        """View of query ``i`` with mean-amortized timings."""
        q_n = max(self.n_queries, 1)
        return RkNNResult(
            mask=self.masks[i],
            counts=self.counts[i],
            scene=None if self.scenes is None else self.scenes[i],
            t_filter_s=self.t_filter_s / q_n,
            t_verify_s=self.t_verify_s / q_n,
            backend=self.backend,
            version=self.version,
        )
