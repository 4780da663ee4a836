"""Scene cache (paper Conclusions §5, direction 2), from ``repro.core.hybrid``.

Per-(facility-set, q, k, rect) LRU of built scenes: a repeated query
skips InfZone pruning and occluder construction entirely.  The long-lived
owner of a cache is :class:`repro_torch.core.engine.RkNNEngine`, which
wires it into the single, batched and streaming paths.  The hybrid
RT-versus-SLICE dispatcher of the JAX module needs the query planner and
is not part of this package yet.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from repro_torch.core.scene import Scene, build_scene

__all__ = ["SceneCache"]


def _q_key(q):
    """Hashable cache key component for a query (index or [2] point)."""
    if np.isscalar(q) or isinstance(q, (int, np.integer)):
        return int(q)
    return tuple(np.asarray(q, np.float64).reshape(-1).tolist())


class SceneCache:
    """LRU of built scenes keyed by (facility-set fingerprint, q, k, rect).

    ``rect`` participates in the key because occluder triangles are clipped
    against the domain rectangle — the same query under a different rect is
    a different scene (the batched grid path additionally requires every
    stacked scene to share one rect).  Long-lived callers (the engine) pass
    a precomputed ``fp`` so the facility array is fingerprinted once, not
    per query.

    The *read* path (a ``get_or_build`` hit) is lock-free:
    a plain GIL-atomic dict read, no recency update — so concurrent
    readers of one engine snapshot never block each other.  Insertions
    take the internal lock for eviction safety, which makes eviction
    insertion-ordered (FIFO) rather than strict LRU.  The hit/miss
    counters are racy-increment statistics by design.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._store: "collections.OrderedDict[tuple, Scene]" = collections.OrderedDict()
        self._lock = threading.Lock()  # engine may build scenes from a pool
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    @staticmethod
    def fingerprint(facilities: np.ndarray) -> int:
        f = np.ascontiguousarray(facilities, dtype=np.float64)
        return hash((f.shape, f.tobytes()[:4096], float(f.sum())))

    def get_or_build(
        self, facilities, q, k, rect=None, *, fp: int | None = None, **kw
    ) -> tuple[Scene, bool]:
        if fp is None:
            fp = self.fingerprint(facilities)
        key = (fp, _q_key(q), k, rect)
        scene = self._store.get(key)  # lock-free hit path
        if scene is not None:
            self.hits += 1
            return scene, True
        scene = build_scene(facilities, q, k, rect, **kw)
        with self._lock:
            self._store[key] = scene
            if len(self._store) > self.capacity:
                self._store.popitem(last=False)
            self.misses += 1
        return scene, False
