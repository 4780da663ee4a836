"""SLICE baseline [Yang et al., ICDE'14] — 12-sector arc-based pruning.

Filtering (paper Fig. 1d): the plane around ``q`` is cut into 12 equal
sectors (the count SLICE determined to be optimal).  For each sector ``P``
and facility ``f``, the bisector ``B_{f:q}`` induces along every ray from
``q`` at angle ``θ`` a crossing distance ``t(θ) = (c − q·n) / (d̂(θ)·n)``
beyond which points are on ``f``'s invalid side (``∞`` when the ray never
crosses into it).  Over the sector:

* **upper arc** ``r^u = max_θ t(θ)`` — every sector point beyond ``r^u``
  is pruned by ``f``; the max is attained at a boundary ray (the paper's
  "intersection points with the two radial boundaries");
* **lower arc** ``r^l = min_θ t(θ)`` — no sector point below ``r^l`` is
  pruned by ``f``; the min is at the bisector-normal angle when that angle
  falls inside the sector, else at a boundary ray.

Per sector the k-th smallest upper arc is the *bounding arc* ``r^B``: users
beyond it are pruned by ≥ k facilities.  Verification walks each sector's
*significant list* (facilities with ``r^l < r^B``) — here as a vectorized
strict-closer count over exactly those facilities, which is exact because a
facility with ``r^l ≥ r^B`` cannot prune any candidate (all candidates sit
below its lower arc).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.geometry import bisector

__all__ = ["slice_rknn", "N_SECTORS"]

N_SECTORS = 12


def _arc_radii(facilities: np.ndarray, q: np.ndarray, q_idx: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper/lower arc radii per (sector, facility): two ``[12, M]`` arrays."""
    M = len(facilities)
    n, c = bisector(facilities, q)  # invalid side: p.n < c
    # ray from q at angle θ crosses into invalid side at t = (c - q.n)/(d̂.n)
    # (q is always on the valid side: q.n - c = |q-a|^2/2 * ... > 0 check):
    qn = q @ n.T  # [M]
    num = c - qn  # < 0 always (q strictly valid); crossing needs d̂.n < 0
    sector_edges = -np.pi + np.arange(N_SECTORS + 1) * (2 * np.pi / N_SECTORS)
    upper = np.full((N_SECTORS, M), np.inf)
    lower = np.full((N_SECTORS, M), np.inf)

    def t_at(theta: np.ndarray) -> np.ndarray:
        d = np.stack([np.cos(theta), np.sin(theta)], axis=-1)  # [..., 2]
        dn = d @ n.T  # [..., M]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num[None, :] / dn
        t = np.where((dn < 0) & (t > 0), t, np.inf)
        return t

    t_edges = t_at(sector_edges)  # [13, M]
    phi = np.arctan2(-n[:, 1], -n[:, 0])  # angle of steepest approach (-n dir)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_phi = -num / np.linalg.norm(n, axis=1)  # distance q→bisector (positive)
    t_phi = np.where(np.isfinite(t_phi), t_phi, np.inf)  # q's own zero bisector
    for s in range(N_SECTORS):
        th0, th1 = sector_edges[s], sector_edges[s + 1]
        t0, t1 = t_edges[s], t_edges[s + 1]
        upper[s] = np.maximum(t0, t1)  # inf-propagating: unbounded if either ray never crosses
        inside = ((phi - th0) % (2 * np.pi) < (th1 - th0))
        lower[s] = np.where(inside, t_phi, np.minimum(t0, t1))
    upper[:, q_idx] = np.inf
    lower[:, q_idx] = np.inf
    return upper, lower


def slice_rknn(
    facilities: np.ndarray,
    users: np.ndarray,
    q_idx: int,
    k: int,
) -> tuple[np.ndarray, dict]:
    facilities = np.asarray(facilities, dtype=np.float64)
    users = np.asarray(users, dtype=np.float64)
    q = facilities[q_idx]

    t0 = time.perf_counter()
    upper, lower = _arc_radii(facilities, q, q_idx)
    # bounding arc per sector = k-th smallest upper arc
    up_sorted = np.sort(upper, axis=1)
    rB = np.full(N_SECTORS, np.inf)
    if upper.shape[1] >= k:
        rB = up_sorted[:, k - 1]

    uvec = users - q
    udist = np.linalg.norm(uvec, axis=1)
    uang = np.arctan2(uvec[:, 1], uvec[:, 0])
    usector = np.floor((uang + np.pi) / (2 * np.pi / N_SECTORS)).astype(int) % N_SECTORS
    candidates = udist <= rB[usector]
    t1 = time.perf_counter()

    # ---- verification over per-sector significant lists -------------------
    mask = np.zeros(len(users), dtype=bool)
    d2_all_f = np.sum(facilities**2, axis=1)
    sig_sizes = []
    for s in range(N_SECTORS):
        urows = np.flatnonzero(candidates & (usector == s))
        if len(urows) == 0:
            sig_sizes.append(0)
            continue
        sig = np.flatnonzero(lower[s] < rB[s])
        sig = sig[sig != q_idx]
        sig_sizes.append(len(sig))
        cu = users[urows]
        d2q = np.sum((cu - q) ** 2, axis=1)
        if len(sig) == 0:
            mask[urows] = True  # nothing can prune them
            continue
        fs = facilities[sig]
        d2 = (
            np.sum(cu**2, axis=1)[:, None]
            - 2.0 * cu @ fs.T
            + d2_all_f[sig][None, :]
        )
        cnt = np.sum(d2 < d2q[:, None], axis=1)
        mask[urows] = cnt < k
    t2 = time.perf_counter()
    info = dict(
        t_filter_s=t1 - t0,
        t_verify_s=t2 - t1,
        n_candidates=int(candidates.sum()),
        sig_sizes=sig_sizes,
        bounding_arcs=rB,
    )
    return mask, info
