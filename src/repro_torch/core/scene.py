"""Scene construction (Algorithm 1, lines 1–8) and static-shape packing.

A ``Scene`` is the device-ready encoding of all occluders for one query
facility: triangles in edge-function form, padded to a static size so the
jitted/pjitted ray-cast step never re-traces across queries.  Padding uses
``DEGENERATE_EDGE`` rows (never satisfied), so padded slots contribute zero
hits by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import occluders as occ
from repro_torch.core.geometry import DEGENERATE_EDGE, Rect
from repro_torch.core.pruning import PruneStats, prune_facilities

__all__ = ["Scene", "build_scene", "pad_scene_arrays", "scene_from_arrays"]


def _next_pad(n: int, multiple: int = 128, minimum: int = 128) -> int:
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)


@dataclasses.dataclass
class Scene:
    """Packed per-query occluder scene.

    Attributes:
      tris:    ``[Mp, 3, 2]`` float32 triangle vertices (padded, CCW).
      coeffs:  ``[Mp, 3, 3]`` float32 edge functions (padded degenerate).
      owner:   ``[Mp]`` int32 facility row per triangle, ``-1`` for padding.
      n_tris:  number of real triangles (<= Mp).
      n_occluders: number of kept facilities (paper's ``m``).
      keep:    ``[|F|]`` bool mask of kept facilities.
      q:       ``[2]`` query point.
      rect:    the domain rectangle.
      heights: ``[Mp]`` float32 paper-faithful layer heights ``z`` (metadata;
               the 2-D formulation never reads them — DESIGN.md §2).
      stats:   pruning statistics.
    """

    tris: np.ndarray
    coeffs: np.ndarray
    owner: np.ndarray
    n_tris: int
    n_occluders: int
    keep: np.ndarray
    q: np.ndarray
    rect: Rect
    heights: np.ndarray
    stats: PruneStats

    @property
    def m(self) -> int:  # paper notation
        return self.n_occluders


def pad_scene_arrays(
    tris: np.ndarray, coeffs: np.ndarray, owner: np.ndarray, pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad triangle arrays to a static, lane-aligned size."""
    n = len(tris)
    mp = pad_to if pad_to is not None else _next_pad(n)
    if mp < n:
        raise ValueError(f"pad_to={mp} smaller than triangle count {n}")
    tris_p = np.zeros((mp, 3, 2), dtype=np.float32)
    coeffs_p = np.tile(
        np.asarray(DEGENERATE_EDGE, dtype=np.float32)[None], (mp, 1, 1)
    )
    owner_p = np.full((mp,), -1, dtype=np.int32)
    if n:
        tris_p[:n] = tris.astype(np.float32)
        coeffs_p[:n] = coeffs.astype(np.float32)
        owner_p[:n] = owner
    return tris_p, coeffs_p, owner_p, n


def build_scene(
    facilities: np.ndarray,
    q: np.ndarray | int,
    k: int,
    rect: Rect | None = None,
    *,
    strategy: str = "infzone",
    grid: int | None = None,
    pad_to: int | None = None,
    users_hint: np.ndarray | None = None,
) -> Scene:
    """Construct the occluder scene for query facility ``q``.

    ``q`` may be an index into ``facilities`` (the common case — the query
    is one of the facilities and is excluded from competitors) or an
    explicit ``[2]`` point.  ``users_hint`` optionally extends the domain
    rectangle so every user is interior.
    """
    facilities = np.asarray(facilities, dtype=np.float64)
    if isinstance(q, (int, np.integer)):
        q_idx: int | None = int(q)
        q_pt = facilities[q_idx]
    else:
        q_idx = None
        q_pt = np.asarray(q, dtype=np.float64)
    if rect is None:
        sets = [facilities, q_pt[None]]
        if users_hint is not None:
            sets.append(np.asarray(users_hint, dtype=np.float64))
        rect = Rect.from_points(*sets)

    keep, stats = prune_facilities(
        facilities, q_pt, k, rect, strategy=strategy, grid=grid, exclude=q_idx
    )
    tris, coeffs, owner = occ.occluders_for_facilities(facilities, q_pt, rect, keep)
    tris_p, coeffs_p, owner_p, n = pad_scene_arrays(tris, coeffs, owner, pad_to)
    # paper-faithful distinct layer heights z = 1..T for the kept triangles
    heights = np.zeros((len(tris_p),), dtype=np.float32)
    heights[:n] = np.arange(1, n + 1, dtype=np.float32)
    return Scene(
        tris=tris_p,
        coeffs=coeffs_p,
        owner=owner_p,
        n_tris=n,
        n_occluders=int(keep.sum()),
        keep=keep,
        q=q_pt,
        rect=rect,
        heights=heights,
        stats=stats,
    )


def scene_from_arrays(ref) -> Scene:
    """A :class:`Scene` of this package holding the fields of ``ref``.

    ``ref`` is any object with the attributes of a ``Scene`` (typically
    one built by the reference JAX package); its numpy arrays are copied
    and its ``rect`` and ``stats`` re-created as this package's types, so
    both packages' verify phases can be fed one identical scene.  A
    scene is the whole per-query state of this system: there are no
    weights, only the occluder geometry and the user set.
    """
    r, s = ref.rect, ref.stats
    return Scene(
        tris=np.array(ref.tris, dtype=np.float32),
        coeffs=np.array(ref.coeffs, dtype=np.float32),
        owner=np.array(ref.owner, dtype=np.int32),
        n_tris=int(ref.n_tris),
        n_occluders=int(ref.n_occluders),
        keep=np.array(ref.keep, dtype=bool),
        q=np.array(ref.q, dtype=np.float64),
        rect=Rect(float(r.xmin), float(r.ymin), float(r.xmax), float(r.ymax)),
        heights=np.array(ref.heights, dtype=np.float32),
        stats=PruneStats(
            int(s.n_facilities),
            int(s.n_kept),
            int(s.n_eq1_rejected),
            int(s.n_cover_rejected),
            str(s.strategy),
            float(s.safe_radius),
        ),
    )
