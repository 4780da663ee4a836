"""SIX baseline [Stanoi et al., 2000] — six 60° regions-based pruning.

Filtering (paper Fig. 1a): the plane around ``q`` is divided into six 60°
sectors.  In each sector, the distance from ``q`` to its k-th nearest
facility *in that sector* is a pruning threshold: any user in the sector
strictly farther than the threshold has ``k`` same-sector facilities that
are provably at least as close to it as ``q`` (the 60°-sector lemma), so it
cannot be an RkNN.  Verification: a circular range count around each
surviving candidate (strictly-closer facilities < k), executed on the
shared facility R-tree — the per-candidate range query whose cost the
paper calls out as SIX's bottleneck.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.baselines.rtree import STRTree

__all__ = ["six_rknn"]


def six_rknn(
    facilities: np.ndarray,
    users: np.ndarray,
    q_idx: int,
    k: int,
    tree: STRTree | None = None,
) -> tuple[np.ndarray, dict]:
    """Returns ``(mask [N] bool, info)`` with phase timings and candidates."""
    facilities = np.asarray(facilities, dtype=np.float64)
    users = np.asarray(users, dtype=np.float64)
    q = facilities[q_idx]
    if tree is None:
        tree = STRTree(facilities)

    t0 = time.perf_counter()
    # ---- filtering -------------------------------------------------------
    fvec = facilities - q
    fdist = np.linalg.norm(fvec, axis=1)
    fang = np.arctan2(fvec[:, 1], fvec[:, 0])  # [-pi, pi)
    fsector = np.floor((fang + np.pi) / (np.pi / 3.0)).astype(int) % 6
    thresholds = np.full(6, np.inf)
    for s in range(6):
        m = (fsector == s) & (np.arange(len(facilities)) != q_idx)
        ds = np.sort(fdist[m])
        if len(ds) >= k:
            thresholds[s] = ds[k - 1]

    uvec = users - q
    udist = np.linalg.norm(uvec, axis=1)
    uang = np.arctan2(uvec[:, 1], uvec[:, 0])
    usector = np.floor((uang + np.pi) / (np.pi / 3.0)).astype(int) % 6
    candidates = udist <= thresholds[usector]
    t1 = time.perf_counter()

    # ---- verification (range query per candidate) ------------------------
    mask = np.zeros(len(users), dtype=bool)
    for u in np.flatnonzero(candidates):
        r = udist[u]
        # strictly-closer competitors (excluding q itself)
        c = tree.count_within_strict(users[u], float(np.linalg.norm(users[u] - q)), exclude=q_idx)
        mask[u] = c < k
        del r
    t2 = time.perf_counter()
    info = dict(
        t_filter_s=t1 - t0,
        t_verify_s=t2 - t1,
        n_candidates=int(candidates.sum()),
        thresholds=thresholds,
    )
    return mask, info
