"""Ownership of all per-dataset derived state (``repro.core.snapshot``).

:class:`EngineSnapshot` owns the ``(facilities, users)`` arrays and every
piece of derived state the query paths amortize against them: the domain
rect and hull, the facility fingerprint, the user coordinates as float32
tensors on the engine's device (uploaded once), the
:class:`~repro_torch.core.hybrid.SceneCache`, the per-scene index memo,
the kernel memo (the grid backends' user-to-cell bucketing) and the
prepared-batch LRU.

The read path takes no lock: the caches expose GIL-atomic lock-free
``get`` and lock only on insertion (eviction safety).  Lazy fields are
computed idempotently from immutable inputs; a racing first touch may
compute a value twice, both results are equal, and the last assignment
wins.  Versioned updates (the JAX package's MVCC writer) are not part of
this package yet, so every snapshot here is version 0.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.geometry import Rect

__all__ = ["LruCache", "IndexMemo", "EngineSnapshot"]


class LruCache:
    """Capacity-bounded mapping with a lock-free read path.

    ``get`` is a plain (GIL-atomic) dict read — no lock, no recency
    update, so concurrent readers never block; eviction is therefore
    insertion-ordered (FIFO) rather than strict LRU, which is
    indistinguishable at the small capacities the engine uses.  ``put``
    takes the internal lock only to keep eviction consistent under
    concurrent inserts.
    """

    __slots__ = ("capacity", "_store", "_lock")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._store: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key, default=None):
        return self._store.get(key, default)

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._store[key] = value
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)


class IndexMemo:
    """Per-scene index store: ``id(scene) -> (scene, {key: index})``.

    Entries hold a *strong* reference to the scene, which both keeps the
    ``id()`` key valid for the entry's lifetime and bounds memory via the
    capacity (scenes evicted here simply rebuild their index on next
    use).  Reads of an existing per-scene store are lock-free; creating
    an entry locks for eviction safety.
    """

    __slots__ = ("capacity", "_store", "_lock")

    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._store: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def store_for(self, scene) -> dict:
        """The scene's index store, created (and capacity-evicted) if new."""
        key = id(scene)
        hit = self._store.get(key)
        if hit is not None and hit[0] is scene:
            return hit[1]
        with self._lock:
            hit = self._store.get(key)
            if hit is not None and hit[0] is scene:
                return hit[1]
            store: dict = {}
            self._store[key] = (scene, store)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
            return store


class EngineSnapshot:
    """One version of the engine's dataset + derived state.

    Treated as frozen except for the *lazy* fields (idempotent
    computations from immutable inputs — see module docstring) and the
    caches, which are append-only memos its readers share.
    """

    __slots__ = (
        "version",
        "facilities",
        "users",
        "device",
        "explicit_rect",
        "scene_cache",
        "index_memo",
        "kernel_memo",
        "batch_cache",
        "_rect",
        "_hull",
        "_fp",
        "_xs",
        "_ys",
        "_mono",
        "_is_mono",
    )

    def __init__(
        self,
        version: int,
        facilities: np.ndarray,
        users: np.ndarray,
        device: torch.device,
        *,
        rect: Rect | None = None,
        explicit_rect: bool = False,
        scene_cache=None,
        index_capacity: int = 256,
        batch_capacity: int = 8,
    ):
        self.version = int(version)
        self.facilities = facilities
        self.users = users
        self.device = device
        self.explicit_rect = bool(explicit_rect)
        self.scene_cache = scene_cache
        self.index_memo = IndexMemo(index_capacity)
        #: Per-user-set kernel state (the grid-pallas cell bucketing, kept
        #: on the device), owned by this snapshot and not by the backend.
        self.kernel_memo = LruCache(4)
        self.batch_cache = LruCache(batch_capacity)
        self._rect = rect
        self._hull: tuple[np.ndarray, np.ndarray] | None = None
        self._fp: int | None = None
        self._xs = self._ys = None
        self._mono = None
        self._is_mono: bool | None = None

    @property
    def rect(self) -> Rect:
        if self._rect is None:
            self._rect = Rect.from_bounds(*self.hull_bounds())
        return self._rect

    def hull_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Unpadded min/max of facilities ∪ users (lazy, cached)."""
        if self._hull is None:
            pts = np.concatenate([self.facilities, self.users])
            self._hull = (pts.min(axis=0), pts.max(axis=0))
        return self._hull

    def fingerprint(self) -> int:
        if self._fp is None:
            from repro_torch.core.hybrid import SceneCache

            self._fp = SceneCache.fingerprint(self.facilities)
        return self._fp

    @property
    def xs(self) -> torch.Tensor:
        """``[N]`` float32 user x on the engine's device (uploaded once)."""
        if self._xs is None:
            # assign ys first: a racing reader that observes _xs non-None
            # must be able to read _ys without a second upload
            ys = _device_f32(self.users[:, 1], self.device)
            xs = _device_f32(self.users[:, 0], self.device)
            self._ys = ys
            self._xs = xs
        return self._xs

    @property
    def ys(self) -> torch.Tensor:
        self.xs  # noqa: B018 — materializes both
        return self._ys


def _device_f32(col: np.ndarray, device: torch.device) -> torch.Tensor:
    """One float64 coordinate column as a contiguous float32 tensor; the
    cast rounds to nearest on the host, as ``jnp.asarray(.., float32)``."""
    return torch.from_numpy(np.ascontiguousarray(col, dtype=np.float32)).to(device)
