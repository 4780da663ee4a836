"""STR-packed R*-tree stand-in shared by all CPU baselines (paper §4.1).

The paper gives every baseline an R*-tree over facilities (and users); we
bulk-load with Sort-Tile-Recursive packing, which matches or beats R*-tree
query quality for static point sets and is the standard choice for
preprocessing-free experiments.  Provides the three operations the
baselines need:

* ``nearest_iter(p)`` — incremental best-first nearest-facility iteration,
* ``knn(p, k)`` — k nearest entries,
* ``count_within(p, r)`` / ``count_within_strict`` — circle range counts,

plus ``build_time`` so Table 2 (amortized indexing cost) can be reproduced.
"""

from __future__ import annotations

import heapq
import time

import numpy as np

__all__ = ["STRTree"]


class STRTree:
    """STR bulk-loaded R-tree over ``[N, 2]`` points."""

    def __init__(self, points: np.ndarray, leaf_capacity: int = 32, fanout: int = 16):
        t0 = time.perf_counter()
        self.points = np.asarray(points, dtype=np.float64)
        n = len(self.points)
        self.leaf_capacity = leaf_capacity
        # ---- leaf level: STR packing ------------------------------------
        idx = np.arange(n)
        if n == 0:
            self.levels: list[dict] = []
            self.build_time = 0.0
            return
        n_leaves = max(1, int(np.ceil(n / leaf_capacity)))
        n_strips = max(1, int(np.ceil(np.sqrt(n_leaves))))
        per_strip = int(np.ceil(n / n_strips))
        order_x = idx[np.argsort(self.points[:, 0], kind="stable")]
        leaves: list[np.ndarray] = []
        for s in range(0, n, per_strip):
            strip = order_x[s : s + per_strip]
            strip = strip[np.argsort(self.points[strip, 1], kind="stable")]
            for l in range(0, len(strip), leaf_capacity):
                leaves.append(strip[l : l + leaf_capacity])
        # ---- internal levels --------------------------------------------
        # each level: dict(bbox [M,4], children: list of index arrays into
        # the level below, leaf: bool)
        def bbox_of(ids_points: np.ndarray) -> np.ndarray:
            return np.concatenate(
                [ids_points.min(axis=0), ids_points.max(axis=0)]
            )

        leaf_bbox = np.stack([bbox_of(self.points[l]) for l in leaves])
        self.levels = [dict(bbox=leaf_bbox, children=leaves, leaf=True)]
        cur_bbox = leaf_bbox
        while len(cur_bbox) > 1:
            m = len(cur_bbox)
            cent = (cur_bbox[:, :2] + cur_bbox[:, 2:]) / 2.0
            n_nodes = max(1, int(np.ceil(m / fanout)))
            n_strips = max(1, int(np.ceil(np.sqrt(n_nodes))))
            per_strip = int(np.ceil(m / n_strips))
            order_x = np.argsort(cent[:, 0], kind="stable")
            groups: list[np.ndarray] = []
            for s in range(0, m, per_strip):
                strip = order_x[s : s + per_strip]
                strip = strip[np.argsort(cent[strip, 1], kind="stable")]
                for l in range(0, len(strip), fanout):
                    groups.append(strip[l : l + fanout])
            up_bbox = np.stack(
                [
                    np.concatenate(
                        [cur_bbox[g, :2].min(axis=0), cur_bbox[g, 2:].max(axis=0)]
                    )
                    for g in groups
                ]
            )
            self.levels.append(dict(bbox=up_bbox, children=groups, leaf=False))
            cur_bbox = up_bbox
        self.build_time = time.perf_counter() - t0

    # ---- distance helpers ------------------------------------------------
    @staticmethod
    def _mindist2(p: np.ndarray, bbox: np.ndarray) -> np.ndarray:
        dx = np.maximum(np.maximum(bbox[..., 0] - p[0], p[0] - bbox[..., 2]), 0.0)
        dy = np.maximum(np.maximum(bbox[..., 1] - p[1], p[1] - bbox[..., 3]), 0.0)
        return dx * dx + dy * dy

    @staticmethod
    def _maxdist2(p: np.ndarray, bbox: np.ndarray) -> np.ndarray:
        dx = np.maximum(np.abs(p[0] - bbox[..., 0]), np.abs(p[0] - bbox[..., 2]))
        dy = np.maximum(np.abs(p[1] - bbox[..., 1]), np.abs(p[1] - bbox[..., 3]))
        return dx * dx + dy * dy

    # ---- queries -----------------------------------------------------------
    def nearest_iter(self, p: np.ndarray):
        """Yield ``(dist, point_index)`` in nondecreasing distance order."""
        if not self.levels:
            return
        p = np.asarray(p, dtype=np.float64)
        top = len(self.levels) - 1
        heap: list[tuple[float, int, int, int]] = []
        # entries: (mindist2, kind, level, node) kind 0 = node, 1 = point
        root_d = float(self._mindist2(p, self.levels[top]["bbox"][0]))
        heapq.heappush(heap, (root_d, 0, top, 0))
        counter = 0
        while heap:
            d, kind, level, node = heapq.heappop(heap)
            if kind == 1:
                yield np.sqrt(d), node
                continue
            lvl = self.levels[level]
            children = lvl["children"][node]
            if lvl["leaf"]:
                pts = self.points[children]
                d2 = np.sum((pts - p) ** 2, axis=1)
                for dd, ci in zip(d2, children):
                    counter += 1
                    heapq.heappush(heap, (float(dd), 1, -counter, int(ci)))
            else:
                below = self.levels[level - 1]["bbox"][children]
                d2 = self._mindist2(p, below)
                for dd, ci in zip(d2, children):
                    counter += 1
                    heapq.heappush(heap, (float(dd), 0, level - 1, int(ci)))

    def knn(self, p: np.ndarray, k: int, exclude: int | None = None):
        out: list[tuple[float, int]] = []
        for d, i in self.nearest_iter(p):
            if exclude is not None and i == exclude:
                continue
            out.append((d, i))
            if len(out) == k:
                break
        return out

    def count_within_strict(self, p: np.ndarray, r: float, exclude: int | None = None) -> int:
        """#points with ``dist(point, p) < r`` (strict), exact."""
        if not self.levels:
            return 0
        p = np.asarray(p, dtype=np.float64)
        r2 = r * r
        top = len(self.levels) - 1
        stack = [(top, 0)]
        count = 0
        while stack:
            level, node = stack.pop()
            lvl = self.levels[level]
            children = lvl["children"][node]
            if lvl["leaf"]:
                pts = self.points[children]
                d2 = np.sum((pts - p) ** 2, axis=1)
                inside = d2 < r2
                if exclude is not None:
                    inside &= children != exclude
                count += int(inside.sum())
            else:
                below = self.levels[level - 1]["bbox"][children]
                mind = self._mindist2(p, below)
                maxd = self._maxdist2(p, below)
                for j, ci in enumerate(children):
                    if mind[j] >= r2:
                        continue
                    if maxd[j] < r2 and exclude is None:
                        count += self._subtree_size(level - 1, int(ci))
                    else:
                        stack.append((level - 1, int(ci)))
        return count

    def _subtree_size(self, level: int, node: int) -> int:
        lvl = self.levels[level]
        children = lvl["children"][node]
        if lvl["leaf"]:
            return len(children)
        return sum(self._subtree_size(level - 1, int(c)) for c in children)
