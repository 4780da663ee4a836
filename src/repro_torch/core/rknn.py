"""Free-function RkNN API — one-shot shims over :class:`RkNNEngine`.

The stateful engine (:mod:`repro_torch.core.engine`) is the primary query
surface: it owns the shared domain rect, the scene cache, per-backend
prebuilt state, and sticky scene pads, so repeated query waves
amortize everything the paper says should be amortized.  These functions
construct a throwaway engine per call (caches disabled — a one-shot call
cannot amortize anything) and therefore keep their historical semantics
bit-for-bit: same masks, same counts, same two-stage timing convention.

Backend names resolve through the registry in
:mod:`repro_torch.core.backends` (``dense``, ``dense-ref``, ``grid``,
``grid-pallas``, ``grid-pallas-ref``, ``bvh`` and ``brute`` built in, and
the ``auto`` planner, which routes to them).
Every shim takes ``device=None``, which means ``"cuda"`` and raises
without a card; ``device="cpu"`` runs the plain PyTorch versions.

Timing semantics (§4.1 / [62] two-stage convention): *filtering*
(``t_filter_s``) covers everything on the host that prepares the query —
pruning, occluder construction, padding, AND the grid/BVH index build;
*verification* (``t_verify_s``) is only the device count dispatch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.backends import concrete_backends
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.results import RkNNBatchResult, RkNNResult

__all__ = [
    "RkNNResult",
    "RkNNBatchResult",
    "rt_rknn_query",
    "rt_rknn_query_batch",
    "rknn_mono_query",
    "BACKENDS",
]

#: Registered *concrete* backend names, in registration order (the registry
#: is the source of truth and late registrations won't be reflected here).
#: The ``auto`` planner is a meta backend and is excluded — it routes to
#: these.
BACKENDS = concrete_backends()


def _one_shot_engine(
    facilities,
    users,
    *,
    backend: str,
    strategy: str = "infzone",
    grid_g: int = 64,
    prune_grid: int | None = None,
    rect: Rect | None = None,
    pad_to: int | None = None,
    scene_workers: int = 0,
    device=None,
) -> RkNNEngine:
    return RkNNEngine(
        facilities,
        users,
        RkNNConfig(
            backend=backend,
            strategy=strategy,
            grid_g=grid_g,
            prune_grid=prune_grid,
            pad_to=pad_to,
            scene_workers=scene_workers,
            scene_cache=0,  # one-shot: nothing to amortize
            batch_cache=0,
        ),
        rect=rect,
        device=device,
    )


def rt_rknn_query(
    facilities: np.ndarray,
    users: np.ndarray,
    q: int | np.ndarray,
    k: int,
    *,
    backend: str = "dense",
    strategy: str = "infzone",
    grid_g: int = 64,
    prune_grid: int | None = None,
    rect: Rect | None = None,
    pad_to: int | None = None,
    device=None,
) -> RkNNResult:
    """Bichromatic RkNN of facility ``q`` (index into ``facilities`` or a
    ``[2]`` point).  Returns membership mask over ``users``.

    One-shot shim; for repeated queries build an :class:`RkNNEngine` once
    and call :meth:`RkNNEngine.query`.
    """
    eng = _one_shot_engine(
        facilities,
        users,
        backend=backend,
        strategy=strategy,
        grid_g=grid_g,
        prune_grid=prune_grid,
        rect=rect,
        pad_to=pad_to,
        device=device,
    )
    return eng.query(q, k)


def rt_rknn_query_batch(
    facilities: np.ndarray,
    users: np.ndarray,
    qs,
    k: int,
    *,
    backend: str = "dense",
    strategy: str = "infzone",
    grid_g: int = 64,
    prune_grid: int | None = None,
    rect: Rect | None = None,
    pad_to: int | None = None,
    scene_workers: int = 0,
    device=None,
) -> RkNNBatchResult:
    """Batched bichromatic RkNN: all of ``qs`` against one shared user set.

    ``qs`` is a sequence of facility indices and/or ``[2]`` points.  All
    per-query scenes are built on the host (with ``scene_workers`` threads
    when > 0), padded to one static ``Mp``, and counted in a **single**
    batched device dispatch.  Masks are bit-identical to looping
    :func:`rt_rknn_query` per query (equivalence-tested across all
    backends).

    One-shot shim; for repeated workloads build an :class:`RkNNEngine`
    once — its scene cache and prepared-batch LRU then amortize the host
    filter phase across calls.
    """
    eng = _one_shot_engine(
        facilities,
        users,
        backend=backend,
        strategy=strategy,
        grid_g=grid_g,
        prune_grid=prune_grid,
        rect=rect,
        pad_to=pad_to,
        scene_workers=scene_workers,
        device=device,
    )
    return eng.query_batch(qs, k)


def rknn_mono_query(
    points: np.ndarray,
    q_idx: int,
    k: int,
    *,
    backend: str = "dense",
    strategy: str = "infzone",
    rect: Rect | None = None,
    device=None,
) -> RkNNResult:
    """Monochromatic RkNN (paper §2.1 / §4.5 discussion).

    Reduces exactly to the bichromatic machinery with ``F = U = P`` at
    threshold ``k + 1``: every point's ray hits its *own* occluder (a point
    is trivially closer to itself than to ``q``), so

        p ∈ RkNN_mono(q)  ⟺  #others-closer(p) < k
                           ⟺  hit-count(p) − 1 < k
                           ⟺  hit-count(p) < k + 1.

    Running scene pruning at ``k + 1`` keeps the influence-zone exactness
    argument aligned with the shifted threshold (a pruned own-occluder would
    already certify ``k + 1`` hits).  Validated against the mono brute
    oracle in the JAX package's ``tests/test_core_rknn.py``.

    The returned ``counts`` are **self-hit corrected**: raw hit counts
    include each point's own occluder, so one hit is subtracted for every
    point except ``q`` itself (whose occluder is excluded from the scene).
    ``counts[p]`` is therefore the number of *other* points strictly closer
    to ``p`` than ``q``, and ``mask == counts < k`` (with row ``q_idx``
    forced False).  For mask-True points this equals the mono brute rank
    exactly; for pruned-out points the count is a saturated lower bound
    ``>= k``.
    """
    points = np.asarray(points, dtype=np.float64)
    eng = _one_shot_engine(
        points, points, backend=backend, strategy=strategy, rect=rect, device=device
    )
    return eng.query_mono(q_idx, k)
