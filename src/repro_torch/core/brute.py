"""Exact RkNN oracles (ground truth for every other path in this repo).

``u`` is an RkNN of ``q`` iff fewer than ``k`` competing facilities are
*strictly* closer to ``u`` than ``q`` is (paper §2.1).  Ties (equal
distance) therefore do **not** count against ``u`` — matching the open
half-plane "invalid side" convention used by the occluders.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rank_counts_np", "rknn_brute_np", "rknn_mono_brute_np", "rank_counts_torch"]


def rank_counts_np(
    users: np.ndarray, facilities: np.ndarray, q: np.ndarray, exclude: int | None = None
) -> np.ndarray:
    """#competitors strictly closer than ``q`` per user — ``[N]`` int64."""
    users = np.asarray(users, dtype=np.float64)
    facilities = np.asarray(facilities, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    d2q = np.sum((users - q) ** 2, axis=1)
    counts = np.zeros(len(users), dtype=np.int64)
    # chunked to bound the [N, M] intermediate
    chunk = max(1, int(2**24 // max(len(facilities), 1)))
    mask_f = np.ones(len(facilities), dtype=bool)
    if exclude is not None:
        mask_f[exclude] = False
    fac = facilities[mask_f]
    for s in range(0, len(users), chunk):
        e = min(s + chunk, len(users))
        d2 = (
            np.sum(users[s:e] ** 2, axis=1)[:, None]
            - 2.0 * users[s:e] @ fac.T
            + np.sum(fac**2, axis=1)[None, :]
        )
        counts[s:e] = np.sum(d2 < d2q[s:e, None], axis=1)
    return counts


def rknn_brute_np(
    users: np.ndarray,
    facilities: np.ndarray,
    q: np.ndarray | int,
    k: int,
) -> np.ndarray:
    """Bichromatic RkNN membership mask ``[N]`` bool (exact)."""
    if isinstance(q, (int, np.integer)):
        q_pt = np.asarray(facilities, dtype=np.float64)[int(q)]
        exclude: int | None = int(q)
    else:
        q_pt = np.asarray(q, dtype=np.float64)
        exclude = None
    return rank_counts_np(users, facilities, q_pt, exclude=exclude) < k


def rknn_mono_brute_np(points: np.ndarray, q_idx: int, k: int) -> np.ndarray:
    """Monochromatic RkNN over one point set ``P`` (paper §2.1).

    ``p ∈ RkNN(q)`` iff fewer than ``k`` points of ``P \\ {p, q}`` are
    strictly closer to ``p`` than ``q`` is.  Row ``q_idx`` itself is False.
    """
    points = np.asarray(points, dtype=np.float64)
    q = points[q_idx]
    d2q = np.sum((points - q) ** 2, axis=1)
    d2 = (
        np.sum(points**2, axis=1)[:, None]
        - 2.0 * points @ points.T
        + np.sum(points**2, axis=1)[None, :]
    )
    closer = d2 < d2q[:, None]
    np.fill_diagonal(closer, False)  # a != p
    closer[:, q_idx] = False  # a != q
    counts = closer.sum(axis=1)
    out = counts < k
    out[q_idx] = False
    return out


def rank_counts_torch(users: torch.Tensor, facilities: torch.Tensor, q: torch.Tensor):
    """torch mirror of :func:`rank_counts_np` on tensors of any one device
    (``users [N, 2]``, ``facilities [M, 2]``, ``q [2]``) — ``[N]`` int64."""
    d2q = torch.sum((users - q) ** 2, dim=1)
    d2 = (
        torch.sum(users**2, dim=1)[:, None]
        - 2.0 * users @ facilities.T
        + torch.sum(facilities**2, dim=1)[None, :]
    )
    return torch.sum(d2 < d2q[:, None], dim=1)
