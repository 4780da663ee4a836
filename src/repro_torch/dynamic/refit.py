"""Scene survival, remapping, and refit under snapshot deltas
(``repro.dynamic.refit``, host numpy over the port's filter phase).

Three levels of reuse, cheapest first, all provably bit-identical to a
cold rebuild from the post-update snapshot:

1. **Survive** (:func:`scene_update_safe`): every touched facility
   position is strictly farther from the scene's query point than the
   pruning pass's :attr:`~repro_torch.core.pruning.PruneStats.safe_radius`
   certificate — a cold re-prune would examine the identical chunked
   prefix and reject the rest, so the scene (triangles, coefficients,
   kept set) is unchanged.  Only row *ids* may have shifted (deletions
   compact the array); :func:`remap_scene` rewrites ``keep``/``owner``,
   and the caller adopts the memoized per-backend indexes into the next
   snapshot's index memo untouched.

2. **Refit** (:func:`refit_scene`): the update lands inside the
   certificate, but a re-prune confirms the kept facility set is
   unchanged and only some kept facilities *moved*.  Occluder fans are
   recomputed for the moved facilities only and spliced over the old
   triangle slots — the per-triangle construction is deterministic, so
   untouched slots stay bit-identical and the patched arrays equal a
   cold build's.  The caller then refits (or rebuilds, per backend
   quality gates) the memoized indexes via ``Backend.refit_index``.

3. **Rebuild**: anything else drops out of the cache and is rebuilt
   lazily by the next query that needs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.geometry import Rect, edge_coeffs
from repro_torch.core.occluders import occluder_triangles
from repro_torch.core.pruning import prune_facilities
from repro_torch.core.scene import Scene

__all__ = ["scene_update_safe", "remap_scene", "refit_scene"]


def scene_update_safe(scene: Scene, changed_pos: np.ndarray) -> bool:
    """True when every changed facility position is strictly beyond the
    scene's pruning certificate — the update provably cannot alter it."""
    if not len(changed_pos):
        return True
    safe = scene.stats.safe_radius
    if not np.isfinite(safe):
        return False
    d = np.linalg.norm(np.asarray(changed_pos, np.float64) - scene.q, axis=1)
    return bool(np.all(d > safe))


def remap_scene(scene: Scene, index_map: np.ndarray, n_new: int) -> Scene:
    """Rewrite ``keep``/``owner`` row ids through ``index_map`` for a scene
    whose geometry survives an update unchanged.  Triangle arrays are
    shared, not copied; the memoized grid/BVH indexes are adopted into the
    new snapshot's :class:`~repro_torch.core.snapshot.IndexMemo` by the caller.

    Every kept facility must survive the update — the survival test
    guarantees it (a deleted kept facility is within the certificate).
    """
    old_kept = np.flatnonzero(scene.keep)
    new_rows = index_map[old_kept]
    if len(new_rows) and new_rows.min() < 0:
        raise ValueError("remap_scene: a kept facility was deleted")
    keep = np.zeros(n_new, dtype=bool)
    keep[new_rows] = True
    owner = scene.owner.copy()
    real = owner >= 0
    owner[real] = index_map[owner[real]].astype(owner.dtype)
    new = Scene(
        tris=scene.tris,
        coeffs=scene.coeffs,
        owner=owner,
        n_tris=scene.n_tris,
        n_occluders=scene.n_occluders,
        keep=keep,
        q=scene.q,
        rect=scene.rect,
        heights=scene.heights,
        stats=dataclasses.replace(scene.stats, n_facilities=n_new),
    )
    return new


def refit_scene(
    scene: Scene,
    index_map: np.ndarray,
    facilities_new: np.ndarray,
    q_build: int | np.ndarray,
    k: int,
    rect: Rect,
    moved_new_ids: np.ndarray,
    *,
    strategy: str = "infzone",
    grid: int | None = None,
) -> tuple[Scene, np.ndarray] | None:
    """Patch a dirtied scene in place of a full rebuild, when sound.

    Re-runs pruning on the new facility set; bails (``None``) unless the
    kept set is exactly the old one carried through ``index_map`` — then
    recomputes occluder fans only for kept facilities in ``moved_new_ids``
    (post-update ids) and splices them over their old triangle slots.
    Bails as well when a moved facility's fan changes triangle count (its
    occluder case flipped — the splice would shift every later slot).

    Returns ``(new_scene, changed_tri_ids)``; the new scene equals what
    ``build_scene`` would produce from the new snapshot, while sharing no
    mutated state with the input.  The caller still owns index refit.
    """
    facilities_new = np.asarray(facilities_new, dtype=np.float64)
    if isinstance(q_build, (int, np.integer)):
        exclude: int | None = int(q_build)
        q_pt = facilities_new[exclude]
    else:
        exclude = None
        q_pt = np.asarray(q_build, np.float64)
    if not np.array_equal(q_pt, scene.q):
        return None  # the query point itself moved: every occluder changes
    keep_new, stats = prune_facilities(
        facilities_new, q_pt, k, rect, strategy=strategy, grid=grid, exclude=exclude
    )
    expected = np.zeros(len(facilities_new), dtype=bool)
    old_kept = np.flatnonzero(scene.keep)
    mapped = index_map[old_kept]
    if len(mapped) and mapped.min() < 0:
        return None  # a kept facility was deleted: geometry must change
    expected[mapped] = True
    if not np.array_equal(keep_new, expected):
        return None

    n = scene.n_tris
    owner = scene.owner.copy()
    real = owner >= 0
    owner[real] = index_map[owner[real]].astype(owner.dtype)
    tris = scene.tris.copy()
    coeffs = scene.coeffs.copy()
    changed: list[int] = []
    for fid in np.asarray(moved_new_ids, np.int64):
        if fid < 0 or not keep_new[fid]:
            continue
        slots = np.flatnonzero(owner[:n] == fid)
        t_new = occluder_triangles(facilities_new[fid], q_pt, rect)
        if len(t_new) != len(slots):
            return None  # occluder case flipped (1 vs 2 triangles)
        if len(slots):
            tris[slots] = t_new.astype(np.float32)
            coeffs[slots] = edge_coeffs(t_new).astype(np.float32)
            changed.extend(int(s) for s in slots)

    new = Scene(
        tris=tris,
        coeffs=coeffs,
        owner=owner,
        n_tris=n,
        n_occluders=int(keep_new.sum()),
        keep=keep_new,
        q=q_pt,
        rect=rect,
        heights=scene.heights,
        stats=stats,
    )
    return new, np.asarray(changed, np.int64)
