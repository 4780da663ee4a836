"""InfZone baseline [Cheema et al., ICDE'11] — influence-zone containment.

InfZone computes the *influence zone* ``Z_k(q)`` — the region where a user
is an RkNN of ``q`` iff it lies inside — by intersecting facility
half-planes and discarding facilities whose bisector provably cannot touch
the (shrinking) zone, using the star-shaped-zone vertex criterion plus the
two cheap distance filters (paper Eqs. (1)/(2)).

Our zone bookkeeping is the sound conservative coverage grid shared with
the RT-RkNN scene constructor (``repro_torch.core.pruning``): a facility is
discarded only when its half-plane misses every possibly-zone cell, which
implies it misses the true zone.  As proved there, the surviving facility
set determines the zone *exactly*:  ``u ∈ Z  ⟺  #{kept a : dist(u,a) <
dist(u,q)} < k``.  Verification is therefore the paper's single
containment check (no false positives, no candidate refinement), here in
its algebraic form — a vectorized half-plane membership count over the
kept facilities only.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.geometry import Rect, bisector
from repro_torch.core.pruning import prune_facilities

__all__ = ["infzone_rknn"]


def infzone_rknn(
    facilities: np.ndarray,
    users: np.ndarray,
    q_idx: int,
    k: int,
    rect: Rect | None = None,
    grid: int | None = None,
) -> tuple[np.ndarray, dict]:
    facilities = np.asarray(facilities, dtype=np.float64)
    users = np.asarray(users, dtype=np.float64)
    q = facilities[q_idx]
    if rect is None:
        rect = Rect.from_points(facilities, users)

    t0 = time.perf_counter()
    keep, stats = prune_facilities(
        facilities, q, k, rect, strategy="infzone", grid=grid, exclude=q_idx
    )
    kept = facilities[keep]
    n, c = bisector(kept, q) if len(kept) else (np.zeros((0, 2)), np.zeros((0,)))
    t1 = time.perf_counter()

    # containment check: u inside zone <=> kept-half-plane depth < k
    if len(kept):
        depth = (users @ n.T < c[None, :]).sum(axis=1)
    else:
        depth = np.zeros(len(users), dtype=int)
    mask = depth < k
    t2 = time.perf_counter()
    info = dict(
        t_filter_s=t1 - t0,
        t_verify_s=t2 - t1,
        n_kept=int(keep.sum()),
        stats=stats,
    )
    return mask, info
