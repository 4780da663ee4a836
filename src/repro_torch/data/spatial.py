"""Spatial dataset generators for the RkNN benchmarks.

The paper evaluates on six DIMACS road networks (NY ... USA, Fig. 6) —
offline here, so we generate *road-network-like* point sets: a random
planar polyline graph whose edges are densely sampled with jitter, which
reproduces the clustered-linear structure of road vertices, plus uniform
and Gaussian-cluster alternatives for ablations.  Deterministic by seed;
paper cardinalities are reproduced (scaled by ``--scale`` in benchmarks).
"""

from __future__ import annotations

import numpy as np

__all__ = ["road_network_points", "uniform_points", "clustered_points", "PAPER_DATASETS"]

# paper Table 1 cardinalities
PAPER_DATASETS = {
    "NY": 264_346,
    "FLA": 1_070_376,
    "CAL": 1_890_815,
    "E": 3_598_623,
    "CTR": 14_081_816,
    "USA": 23_947_347,
}


def road_network_points(n: int, seed: int = 0, n_hubs: int | None = None) -> np.ndarray:
    """~n points along the edges of a random planar hub graph."""
    rng = np.random.default_rng(seed)
    n_hubs = n_hubs or max(16, int(np.sqrt(n) / 4))
    hubs = rng.random((n_hubs, 2))
    # connect each hub to its 3 nearest -> polyline "roads"
    d2 = np.sum((hubs[:, None] - hubs[None, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    edges = []
    for i in range(n_hubs):
        for j in np.argsort(d2[i])[:3]:
            if i < j:
                edges.append((i, int(j)))
    edges = np.asarray(edges)
    lengths = np.linalg.norm(hubs[edges[:, 0]] - hubs[edges[:, 1]], axis=1)
    probs = lengths / lengths.sum()
    counts = rng.multinomial(n, probs)
    pts = []
    for (a, b), c in zip(edges, counts):
        if c == 0:
            continue
        t = rng.random(c)[:, None]
        p = hubs[a][None] * (1 - t) + hubs[b][None] * t
        p = p + rng.normal(0.0, 0.002, p.shape)  # GPS-ish jitter
        pts.append(p)
    out = np.concatenate(pts) if pts else np.zeros((0, 2))
    if len(out) < n:  # multinomial rounding
        out = np.concatenate([out, rng.random((n - len(out), 2))])
    return np.clip(out[:n], 0.0, 1.0)


def uniform_points(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((n, 2))


def clustered_points(n: int, seed: int = 0, n_clusters: int = 32, spread: float = 0.02) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.random((n_clusters, 2))
    assign = rng.integers(0, n_clusters, n)
    pts = centers[assign] + rng.normal(0, spread, (n, 2))
    return np.clip(pts, 0.0, 1.0)


def facility_user_split(points: np.ndarray, n_facilities: int, seed: int = 0):
    """Paper protocol: |F| random points are facilities, the rest users."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(points))
    f = points[idx[:n_facilities]]
    u = points[idx[n_facilities:]]
    return f, u
