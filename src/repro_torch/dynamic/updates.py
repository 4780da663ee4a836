"""Update deltas for the dynamic subsystem (``repro.dynamic.updates``).

An :class:`UpdateBatch` is one atomic delta against a ``(facilities,
users)`` snapshot: facility inserts/deletes/moves and user
inserts/deletes/moves, all expressed against **pre-update row ids**.
:func:`apply_to_points` materializes the post-update array together with
an old→new index map, with deterministic layout rules so a cold engine
built from the final snapshot sees exactly the arrays the dynamic engine
maintains:

* moved rows are updated in place,
* deleted rows are removed with relative order preserved,
* inserted rows are appended in the order given.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "UpdateBatch",
    "apply_to_points",
    "changed_positions",
]


def _ids(a) -> np.ndarray:
    if a is None:
        return np.zeros(0, np.int64)
    out = np.asarray(a, dtype=np.int64).reshape(-1)
    return out


def _pts(a) -> np.ndarray:
    if a is None:
        return np.zeros((0, 2), np.float64)
    return np.asarray(a, dtype=np.float64).reshape(-1, 2)


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """One atomic snapshot delta (all ids are pre-update row indices).

    ``*_move`` is a pair ``(ids, new_points)``; a row may appear in at
    most one of move/delete per side.  Empty/omitted components are fine —
    ``UpdateBatch(user_move=(ids, pts))`` expresses a pure drift step.
    """

    facility_insert: np.ndarray | None = None  # [A, 2]
    facility_delete: np.ndarray | None = None  # [B] ids
    facility_move: tuple[np.ndarray, np.ndarray] | None = None  # ([C], [C, 2])
    user_insert: np.ndarray | None = None
    user_delete: np.ndarray | None = None
    user_move: tuple[np.ndarray, np.ndarray] | None = None

    def __post_init__(self):
        object.__setattr__(self, "facility_insert", _pts(self.facility_insert))
        object.__setattr__(self, "facility_delete", _ids(self.facility_delete))
        object.__setattr__(self, "user_insert", _pts(self.user_insert))
        object.__setattr__(self, "user_delete", _ids(self.user_delete))
        for name in ("facility_move", "user_move"):
            mv = getattr(self, name)
            ids, pts = (mv[0], mv[1]) if mv is not None else (None, None)
            ids, pts = _ids(ids), _pts(pts)
            if len(ids) != len(pts):
                raise ValueError(f"{name}: {len(ids)} ids but {len(pts)} points")
            object.__setattr__(self, name, (ids, pts))

    # ------------------------------------------------------------------
    @property
    def touches_facilities(self) -> bool:
        return bool(
            len(self.facility_insert)
            or len(self.facility_delete)
            or len(self.facility_move[0])
        )

    @property
    def touches_users(self) -> bool:
        return bool(
            len(self.user_insert) or len(self.user_delete) or len(self.user_move[0])
        )

    @property
    def is_empty(self) -> bool:
        return not (self.touches_facilities or self.touches_users)

    def validate(self, n_facilities: int, n_users: int) -> None:
        """Bounds- and overlap-check all ids against the current snapshot."""
        for name, ids, mv, n in (
            ("facility", self.facility_delete, self.facility_move[0], n_facilities),
            ("user", self.user_delete, self.user_move[0], n_users),
        ):
            for what, arr in (("delete", ids), ("move", mv)):
                if len(arr) and (arr.min() < 0 or arr.max() >= n):
                    raise IndexError(
                        f"{name}_{what} id out of range for {n} rows: {arr}"
                    )
                if len(np.unique(arr)) != len(arr):
                    raise ValueError(f"duplicate ids in {name}_{what}")
            if len(np.intersect1d(ids, mv)):
                raise ValueError(f"{name} rows appear in both delete and move")


def apply_to_points(
    points: np.ndarray,
    insert: np.ndarray,
    delete: np.ndarray,
    move: tuple[np.ndarray, np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Apply one side's delta.  Returns ``(new_points, index_map)`` where
    ``index_map[old_row]`` is the post-update row (``-1`` for deleted)."""
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    out = points.copy()
    mv_ids, mv_pts = move
    if len(mv_ids):
        out[mv_ids] = mv_pts
    alive = np.ones(n, dtype=bool)
    alive[delete] = False
    index_map = np.cumsum(alive) - 1
    index_map[~alive] = -1
    out = out[alive]
    if len(insert):
        out = np.concatenate([out, insert])
    return out, index_map.astype(np.int64)


def changed_positions(batch: UpdateBatch, facilities: np.ndarray) -> np.ndarray:
    """Every facility position an update touches — deleted rows, both
    endpoints of moves, and inserts — i.e. the dirty point set the scene
    survival test measures distances against.  ``[K, 2]`` float64."""
    facilities = np.asarray(facilities, dtype=np.float64)
    mv_ids, mv_pts = batch.facility_move
    parts = [
        facilities[batch.facility_delete],
        facilities[mv_ids],
        mv_pts,
        batch.facility_insert,
    ]
    return np.concatenate([p.reshape(-1, 2) for p in parts])
