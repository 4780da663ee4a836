"""TPL baseline [Tao, Papadias, Lian, VLDB'04] — half-space pruning.

Filtering (paper Fig. 1b): facilities are visited in increasing distance
from ``q`` via the R-tree's incremental nearest iterator.  Every *unpruned*
visited facility ``a`` contributes the half-plane ``H_{a:q}`` (its
bisector's invalid side); a facility or user lying in ``>= k`` contributed
half-planes is pruned.  Facilities that are themselves pruned contribute no
bisector (facility ``d`` in the paper's figure).  Refinement: surviving
candidate users are verified exactly (strictly-closer count ``< k``).

Fidelity note: full TPL also trims R-tree MBRs against the half-planes to
prune whole subtrees during the traversal; the pruning *logic* (which is
what defines TPL and what the paper's comparison exercises) is the
half-space membership count implemented here, with the R-tree supplying the
distance-ordered access pattern.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.baselines.rtree import STRTree
from repro_torch.core.geometry import bisector

__all__ = ["tpl_rknn"]


def tpl_rknn(
    facilities: np.ndarray,
    users: np.ndarray,
    q_idx: int,
    k: int,
    tree: STRTree | None = None,
) -> tuple[np.ndarray, dict]:
    facilities = np.asarray(facilities, dtype=np.float64)
    users = np.asarray(users, dtype=np.float64)
    q = facilities[q_idx]
    if tree is None:
        tree = STRTree(facilities)

    t0 = time.perf_counter()
    # ---- filtering: distance-ordered half-space accumulation -------------
    normals: list[np.ndarray] = []
    offsets: list[float] = []
    contributors: list[int] = []
    for _, fi in tree.nearest_iter(q):
        if fi == q_idx:
            continue
        f = facilities[fi]
        if normals:
            N = np.asarray(normals)
            C = np.asarray(offsets)
            depth = int(np.sum(f @ N.T < C))
            if depth >= k:
                continue  # facility itself pruned -> no bisector (paper: d)
        n, c = bisector(f, q)
        normals.append(n)
        offsets.append(float(c))
        contributors.append(int(fi))
    N = np.asarray(normals) if normals else np.zeros((0, 2))
    C = np.asarray(offsets) if offsets else np.zeros((0,))

    if len(N):
        depth_u = (users @ N.T < C[None, :]).sum(axis=1)
    else:
        depth_u = np.zeros(len(users), dtype=int)
    candidates = depth_u < k
    t1 = time.perf_counter()

    # ---- refinement: exact verification of candidates --------------------
    mask = np.zeros(len(users), dtype=bool)
    cand_idx = np.flatnonzero(candidates)
    if len(cand_idx):
        cu = users[cand_idx]
        d2q = np.sum((cu - q) ** 2, axis=1)
        # exact strict-closer count against all facilities (vectorized)
        d2 = (
            np.sum(cu**2, axis=1)[:, None]
            - 2.0 * cu @ facilities.T
            + np.sum(facilities**2, axis=1)[None, :]
        )
        d2[:, q_idx] = np.inf
        mask[cand_idx] = np.sum(d2 < d2q[:, None], axis=1) < k
    t2 = time.perf_counter()
    info = dict(
        t_filter_s=t1 - t0,
        t_verify_s=t2 - t1,
        n_candidates=int(candidates.sum()),
        n_bisectors=len(N),
    )
    return mask, info
