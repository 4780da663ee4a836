"""Ownership of all per-dataset derived state (``repro.core.snapshot``).

:class:`EngineSnapshot` owns the ``(facilities, users)`` arrays and every
piece of derived state the query paths amortize against them: the domain
rect and hull, the facility fingerprint, the user coordinates as float32
tensors on the engine's device (uploaded once), the
:class:`~repro_torch.core.hybrid.SceneCache`, the per-scene index memo,
the kernel memo (the grid backends' user-to-cell bucketing), the
prepared-batch LRU and the planner's pad-waste memo.

The read path takes no lock: the caches expose GIL-atomic lock-free
``get`` and lock only on insertion (eviction safety).  Lazy fields are
computed idempotently from immutable inputs; a racing first touch may
compute a value twice, both results are equal, and the last assignment
wins.  A plain :class:`~repro_torch.core.engine.RkNNEngine` serves
version 0 for its whole life; :class:`~repro_torch.dynamic.DynamicEngine`
builds version N+1 copy-on-write beside version N (sharing what the
update left valid: the device user tensors, the scene cache, the
per-scene indexes, prepared batches) and publishes it with one reference
swap, so a reader holding version N keeps serving it unchanged.
"""

from __future__ import annotations

import collections
import dataclasses
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

    def items(self) -> list:
        with self._lock:
            return list(self._store.items())


class IndexMemo:
    """Per-scene index store: ``id(scene) -> (scene, {key: index})``.

    Entries hold a *strong* reference to the scene, which both keeps the
    ``id()`` key valid for the entry's lifetime and bounds memory via the
    capacity (scenes evicted here simply rebuild their index on next
    use).  Reads of an existing per-scene store are lock-free; creating
    or adopting an entry locks for eviction safety.
    """

    __slots__ = ("capacity", "_store", "_lock")

    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._store: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def peek(self, scene) -> dict | None:
        """The scene's index store, or ``None`` — never creates."""
        hit = self._store.get(id(scene))
        if hit is not None and hit[0] is scene:
            return hit[1]
        return None

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

    def adopt(self, scene, store: dict | None) -> None:
        """Install ``store`` as the scene's index store (the copy-on-write
        carry: the update path moves a surviving scene's indexes into the
        next snapshot's memo without touching the old snapshot's)."""
        if store is None:
            return
        with self._lock:
            self._store[id(scene)] = (scene, store)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def scenes(self) -> list:
        with self._lock:
            return [scene for scene, _store in self._store.values()]

    def clone(self) -> "IndexMemo":
        """Shallow copy: each per-scene store is copied (``dict(store)``), so
        the two versions stop sharing mutable dicts, while the indexes
        themselves are shared by reference (structural sharing)."""
        new = IndexMemo(self.capacity)
        with self._lock:
            for key, (scene, store) in self._store.items():
                new._store[key] = (scene, dict(store))
        return new


class EngineSnapshot:
    """One immutable version of the engine's dataset + derived state.

    Treated as frozen after publication except for the *lazy* fields
    (idempotent computations from immutable inputs — see module
    docstring) and the caches, which are append-only memos its readers
    share.
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
        "mesh_xs",
        "mesh_ys",
        "mesh_n",
        "mesh_memos",
        "shard_state",
        "_rect",
        "_hull",
        "_fp",
        "_xs",
        "_ys",
        "_mono",
        "_is_mono",
        "_pad_waste",
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
        #: The engine's ``mesh=`` path: this version's users cut in row
        #: order into one contiguous slab per mesh device (tuples of
        #: float32 tensors), ``mesh_n`` users in all, and one kernel memo
        #: per slab (the users' order of each slab).
        self.mesh_xs = self.mesh_ys = self.mesh_memos = None
        self.mesh_n = 0
        #: Per-shard replica views of this version's users (built lazily by
        #: ShardedEngine, swapped in as ONE object so a reader never sees a
        #: mixed-version shard set — the version-lockstep rule).
        self.shard_state = None
        self._rect = rect
        self._hull: tuple[np.ndarray, np.ndarray] | None = None
        self._fp: int | None = None
        self._xs = self._ys = None
        self._mono = None
        self._is_mono: bool | None = None
        self._pad_waste: dict = {}

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

    def pad_waste(self, rect: Rect, grid_g: int) -> float:
        """Measured cell-bucketing pad-waste ratio of this user set
        (``padded rows / n_users``, ≥ 1) at the engine's grid resolution —
        the planner's occupancy feature for the grid-pallas family
        (memoized per (rect, G); see
        :func:`repro_torch.kernels.grid_raycast.measured_pad_waste`)."""
        key = (rect, int(grid_g))
        hit = self._pad_waste.get(key)
        if hit is None:
            from repro_torch.kernels.grid_raycast import measured_pad_waste

            hit = measured_pad_waste(
                self.users[:, 0], self.users[:, 1], rect, int(grid_g)
            )
            self._pad_waste[key] = hit
        return hit

    def device_bytes(self) -> dict[str, int]:
        """Live array bytes owned by this snapshot version, by category.

        Walks the snapshot's caches and memos and sums ``nbytes`` of every
        reachable ``torch.Tensor`` and ``np.ndarray`` exactly once (an
        id-based seen set is shared across categories, so structurally
        shared tensors — carries across versions, replicated planes — are
        charged to the first category that reaches them and the total
        never double counts).  Read-only over lock-free accessors; an
        update publishing mid-walk at worst skews one scrape, never tears
        it.  The categories and their order are the JAX package's.
        """
        seen: set[int] = set()
        # order matters for attribution (not for the total): scenes walk
        # before the index memo so packed occluder geometry lands under
        # "scenes" and the memo contributes only the index-side arrays.
        # Every root is held until the walk ends: the seen set holds ids,
        # and a root list freed after its category would hand its id to
        # the next category's fresh list, which would then read as seen.
        roots = {
            "users": (self.users, self.facilities, self._xs, self._ys,
                      self.mesh_xs, self.mesh_ys),
            "shards": self.shard_state,
            "scenes": self.scene_cache.scenes() if self.scene_cache is not None else None,
            "indexes": list(self.index_memo._store.values()),
            "kernel": (self.kernel_memo.items(),
                       [m.items() for m in self.mesh_memos or ()]),
            "batches": self.batch_cache.items(),
        }
        out = {cat: _nbytes_walk(root, seen) for cat, root in roots.items()}
        out["total"] = sum(out.values())
        return out


_ATOMS = (str, bytes, int, float, bool, type(None))


def _nbytes_walk(obj, seen: set[int]) -> int:
    """Sum of ``nbytes`` over every tensor and array reachable from ``obj``
    through dicts, sequences (NamedTuples included), dataclasses and
    ``__slots__`` objects, deduplicated by identity."""
    if isinstance(obj, _ATOMS):
        return 0
    oid = id(obj)
    if oid in seen:
        return 0
    seen.add(oid)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_nbytes_walk(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_nbytes_walk(v, seen) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(
            _nbytes_walk(getattr(obj, f.name, None), seen)
            for f in dataclasses.fields(obj)
        )
    slots = getattr(type(obj), "__slots__", None)
    if slots:
        return sum(_nbytes_walk(getattr(obj, s, None), seen) for s in slots)
    return 0


def _device_f32(col: np.ndarray, device: torch.device) -> torch.Tensor:
    """One float64 coordinate column as a contiguous float32 tensor; the
    cast rounds to nearest on the host, as ``jnp.asarray(.., float32)``."""
    return torch.from_numpy(np.ascontiguousarray(col, dtype=np.float32)).to(device)
