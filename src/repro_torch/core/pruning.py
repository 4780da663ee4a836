"""Scene-construction pruning — the paper's InfZone-style facility filter.

Algorithm 1 line 2: a facility's occluder is discarded when it is *fully
covered* by ``k`` previously-kept occluders — no ray can then change its
verdict by hitting it (any user inside it already counts >= k hits).  The
paper drives this with InfZone's influence-zone machinery; we implement a
**sound conservative variant** on a coverage grid:

* the domain is divided into ``G x G`` cells; for every kept occluder
  (an invalid half-plane) we track which cells it *fully strictly* contains
  (all 4 cell corners strictly invalid ⇒ the whole convex cell is strictly
  invalid — linear functionals attain extrema at corners);
* a cell whose full-containment count is ``>= k`` provably contains no point
  of the influence zone (every point in it has >= k closer facilities);
* a new facility is discarded iff **every** possibly-zone cell lies entirely
  on its valid side (all 4 corners ``p.n >= c`` ⇒ no strictly-invalid point
  in the cell).  Discarding is therefore never wrong; coarse grids only keep
  extra occluders (performance, not correctness).

The cheap InfZone filters are kept verbatim:
* Eq. (1) bulk reject:  ``dist(f, q) > 2 * max_{v in Z} dist(v, q)`` — with
  the max taken over corners of possibly-zone cells (a superset of the zone,
  so the rejection stays sound);
* facilities are processed in increasing distance from ``q`` (as in both
  InfZone and TPL), which shrinks the zone fastest.

Three strategies from paper §4.8 are exposed: ``"infzone"``,
``"conservative"`` (full test for the first ``warmup`` facilities, Eq. (1)
only afterwards) and ``"none"``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.geometry import Rect, bisector
from repro_torch.core.grid import build_sleep, build_yield_ratio

__all__ = ["PruneStats", "prune_facilities", "STRATEGIES", "adaptive_grid"]

STRATEGIES = ("infzone", "conservative", "none")

#: Adaptive coverage-grid resolution: facility sets below the threshold
#: prune at the coarse resolution, denser ones at the fine one (measured:
#: G=256 halves kept occluders at |F|=10^4).  The dynamic subsystem's
#: cold-equivalence contract depends on detecting when an update crosses
#: the threshold — always read it from here.
ADAPTIVE_GRID_THRESHOLD = 2000
ADAPTIVE_GRID_COARSE = 128
ADAPTIVE_GRID_FINE = 256


def adaptive_grid(n_facilities: int) -> int:
    """The coverage-grid resolution ``prune_facilities`` picks for
    ``grid=None`` at this facility count."""
    return (
        ADAPTIVE_GRID_COARSE
        if n_facilities < ADAPTIVE_GRID_THRESHOLD
        else ADAPTIVE_GRID_FINE
    )


@dataclasses.dataclass
class PruneStats:
    """Bookkeeping for benchmarks (paper Table 3 / Fig 16).

    ``safe_radius`` is the *update-stability certificate* consumed by the
    dynamic subsystem (:mod:`repro_torch.dynamic`): any facility change (insert,
    delete, or either endpoint of a move) strictly farther than this from
    the query point provably leaves a cold re-prune — and therefore the
    whole scene — bit-identical.  It is ``max(2·radius_final, d_max)``
    where ``radius_final`` is the final influence-zone radius bound and
    ``d_max`` the farthest facility the chunked pass ever examined: a
    strictly-farther row sorts after every examined one (chunk boundaries
    are unchanged) and is Eq. (1)-rejected by the final radius before it
    can be processed.  ``inf`` means no change is provably safe (strategy
    ``"none"`` keeps everything; an empty kept set never bounded the zone).
    """

    n_facilities: int
    n_kept: int
    n_eq1_rejected: int
    n_cover_rejected: int
    strategy: str
    safe_radius: float = float("inf")


class _CoverageGrid:
    """Full-containment coverage counts over a G x G cell grid."""

    def __init__(self, rect: Rect, grid: int):
        self.rect = rect
        self.G = grid
        xs = np.linspace(rect.xmin, rect.xmax, grid + 1)
        ys = np.linspace(rect.ymin, rect.ymax, grid + 1)
        cx, cy = np.meshgrid(xs, ys, indexing="ij")  # corner lattice [G+1, G+1]
        self._corners = np.stack([cx, cy], axis=-1)
        self.counts = np.zeros((grid, grid), dtype=np.int32)

    def _corner_signed(self, n: np.ndarray, c: float) -> np.ndarray:
        return self._corners @ np.asarray(n, dtype=np.float64) - c

    def corner_signed_batch(self, n: np.ndarray, c: np.ndarray) -> np.ndarray:
        """[B, G+1, G+1] signed values for a batch of half-planes."""
        v = np.einsum("xyk,bk->bxy", self._corners, np.asarray(n, dtype=np.float64))
        return v - np.asarray(c, dtype=np.float64)[:, None, None]

    def _cell_all(self, corner_mask: np.ndarray) -> np.ndarray:
        """AND of the 4 corner flags per cell: ``[G, G]``."""
        return (
            corner_mask[:-1, :-1]
            & corner_mask[1:, :-1]
            & corner_mask[:-1, 1:]
            & corner_mask[1:, 1:]
        )

    def add_halfplane(self, n: np.ndarray, c: float) -> None:
        """Register a kept occluder's invalid half-plane ``p.n < c``."""
        strictly_invalid = self._corner_signed(n, c) < 0.0
        self.counts += self._cell_all(strictly_invalid).astype(np.int32)

    def possibly_zone(self, k: int) -> np.ndarray:
        """Cells that may still contain influence-zone points: ``[G, G]``."""
        return self.counts < k

    def fully_valid_for(self, n: np.ndarray, c: float) -> np.ndarray:
        """Cells with no strictly-invalid point for this bisector."""
        valid = self._corner_signed(n, c) >= 0.0
        return self._cell_all(valid)

    def zone_radius(self, k: int, q: np.ndarray) -> float:
        """max over possibly-zone cell corners of dist(corner, q).

        dist(., q) is convex so the per-cell max is attained at a corner;
        taking all corners of possibly-zone cells upper-bounds the zone's
        max distance (Eq. (1) soundness).
        """
        pz = self.possibly_zone(k)
        if not pz.any():
            return 0.0
        mask = np.zeros((self.G + 1, self.G + 1), dtype=bool)
        mask[:-1, :-1] |= pz
        mask[1:, :-1] |= pz
        mask[:-1, 1:] |= pz
        mask[1:, 1:] |= pz
        d = np.linalg.norm(self._corners - np.asarray(q, dtype=np.float64), axis=-1)
        return float(d[mask].max())


def prune_facilities(
    facilities: np.ndarray,
    q: np.ndarray,
    k: int,
    rect: Rect,
    *,
    strategy: str = "infzone",
    grid: int | None = None,
    warmup: int = 20,
    exclude: int | None = None,
) -> tuple[np.ndarray, PruneStats]:
    """Keep-mask over ``facilities`` for query point ``q``.

    ``exclude`` optionally names a facility row to skip entirely (the query
    itself for in-set queries).  Returns ``(keep_mask [M] bool, stats)``.
    ``grid=None`` picks the resolution adaptively: dense facility sets have
    tiny influence zones, so the coverage grid must be finer to certify
    coverage (measured: G=256 halves kept occluders at |F|=10^4).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown pruning strategy {strategy!r}")
    if grid is None:
        grid = adaptive_grid(len(facilities))
    facilities = np.asarray(facilities, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    M = len(facilities)
    keep = np.zeros(M, dtype=bool)
    alive = np.ones(M, dtype=bool)
    if exclude is not None:
        alive[exclude] = False
    # facilities coincident with q carry no bisector: drop them
    coincident = np.linalg.norm(facilities - q, axis=1) < 1e-12
    alive &= ~coincident

    if strategy == "none":
        keep = alive.copy()
        return keep, PruneStats(M, int(keep.sum()), 0, 0, strategy)

    dist_q = np.linalg.norm(facilities - q, axis=1)
    order = order_all = np.argsort(dist_q, kind="stable")
    order = order[alive[order]]
    cov = _CoverageGrid(rect, grid)
    n_eq1 = 0
    n_cover = 0
    radius = np.inf  # zone radius upper bound; tightened as occluders land
    processed = 0
    max_processed = 0.0  # farthest facility any chunk examined

    # Facilities are processed in distance order in CHUNKS: the discard test
    # for a chunk is evaluated against the current kept set only, and every
    # survivor of the chunk is kept at once.  Keeping an occluder that a
    # strictly sequential pass would have discarded is always SOUND (hit
    # counts only move toward the true closer-facility counts; see module
    # docstring) — the chunk width trades a few extra occluders for a ~64x
    # smaller host loop.  Near ``q`` pruning quality matters most (those
    # facilities define the zone), so chunks start small and grow.
    pos = 0
    # background maintenance threads (MVCC prewarm) run this loop
    # deprioritized: each iteration is a few ms of solid C-level work, so
    # yielding ratio x the iteration's own time keeps foreground readers
    # at well over the fair-scheduling half of a contended core
    while pos < len(order):
        yield_ratio = build_yield_ratio()  # per iteration: may be dynamic
        t_iter = time.perf_counter() if yield_ratio else 0.0
        chunk = 8 if keep.sum() < 4 * k + 8 else 64
        # ---- Eq. (1) bulk reject of everything beyond 2*radius ----------
        if radius < np.inf:
            cut = np.searchsorted(dist_q[order], 2.0 * radius, side="right")
            if cut <= pos:
                n_eq1 += len(order) - pos
                break
            if cut < len(order):
                n_eq1 += len(order) - cut
                order = order[:cut]
        batch = order[pos : pos + chunk]
        pos += len(batch)
        processed_batch = processed
        processed += len(batch)
        max_processed = max(max_processed, float(dist_q[batch[-1]]))
        n_b, c_b = bisector(facilities[batch], q)  # [B, 2], [B]
        full_test = strategy == "infzone" or processed_batch < warmup
        if full_test:
            pz = cov.possibly_zone(k)
            if not pz.any():
                n_cover += len(batch) + (len(order) - pos)
                break
            # vectorized: cell fully-valid per batch facility  [B, G, G]
            sgn = cov.corner_signed_batch(n_b, c_b) >= 0.0  # [B, G+1, G+1]
            fv = sgn[:, :-1, :-1] & sgn[:, 1:, :-1] & sgn[:, :-1, 1:] & sgn[:, 1:, 1:]
            covered = (~pz[None] | fv).all(axis=(1, 2))  # [B]
            survivors = batch[~covered]
            n_cover += int(covered.sum())
        else:
            survivors = batch
        if len(survivors):
            keep[survivors] = True
            ns, cs = bisector(facilities[survivors], q)
            inv = cov.corner_signed_batch(ns, cs) < 0.0
            full_inv = (
                inv[:, :-1, :-1] & inv[:, 1:, :-1] & inv[:, :-1, 1:] & inv[:, 1:, 1:]
            )
            cov.counts += full_inv.sum(axis=0).astype(np.int32)
            radius = cov.zone_radius(k, q)
        if yield_ratio:
            build_sleep((time.perf_counter() - t_iter) * yield_ratio)

    safe_radius = (
        max(2.0 * float(radius), max_processed) if np.isfinite(radius) else np.inf
    )
    stats = PruneStats(M, int(keep.sum()), n_eq1, n_cover, strategy, safe_radius)
    return keep, stats
