"""Uniform-grid occluder index (``repro.core.grid``), the BVH analogue.

A BVH walk is pointer-chasing with per-ray divergence; this index
replaces the hierarchy with a flat ``G x G`` raster of the domain and
splits every occluder's coverage of each cell into two classes:

* **full coverage** — the triangle contains the entire (closed) cell.
  These never need a per-user test: a per-cell ``base`` counter absorbs
  them.  A cell with ``base >= k`` is *saturated* — every user in it is
  pruned with zero intersection tests.
* **partial coverage** — the triangle's boundary crosses the cell.  Only
  these go into the per-cell candidate list, padded to the longest list.

Exactness: for any user ``u`` in cell ``c``,
``hits(u) == base[c] + #{t in list[c] : u inside t}``.

The index build, refit and stacking are the JAX package's numpy code,
carried over unchanged.  The counts over the index
(:func:`grid_hit_counts_torch`, :func:`grid_hit_counts_batch_torch`) are
plain PyTorch on the users' device: the ``grid`` backend's count, chunked
over users so the per-user ``[chunk, L, 3, 3]`` coefficient gather stays
bounded.  They evaluate edges in the port's one rounding order (see
:mod:`repro_torch.kernels.ref`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.geometry import Rect
from repro_torch.kernels import ref as _ref

__all__ = [
    "OccluderGrid",
    "build_grid",
    "refit_grid",
    "grid_hit_counts_torch",
    "grid_hit_counts_batch_torch",
    "grid_from_arrays",
    "shape_bucket",
    "stack_grids",
    "build_yield_ratio",
    "build_throttle",
    "build_sleep",
    "build_slept_s",
]

#: Element budget of one ``[chunk, L, 3, 3]`` coefficient gather of the
#: counts below (64 MB of float32).
_GATHER_ELEMS = 1 << 24


#: Per-thread cooperative deprioritization for heavy index builds.  A
#: background maintenance thread (the MVCC writer prewarming scenes) sets
#: a positive ratio; the classify chunk loop then sleeps ``ratio x`` the
#: time each chunk of C-level work took, handing the GIL to foreground
#: query threads.  Foreground builds leave it at 0 and pay nothing.
_build_priority = threading.local()


def build_yield_ratio() -> float:
    """Current thread's cooperative-yield ratio (0.0 = foreground).

    Re-sampled inside the hot loops (per chunk / per iteration), so a
    callable ratio can engage or release mid-build as contention changes.
    """
    v = getattr(_build_priority, "yield_ratio", 0.0)
    return float(v()) if callable(v) else v


@contextlib.contextmanager
def build_throttle(ratio):
    """Make grid builds on THIS thread yield ``ratio x`` their CPU time.

    ``ratio=2.0`` caps the building thread at ~1/3 of a contended core, so
    concurrent readers keep ~2/3 instead of the fair-scheduling half — the
    single-core analogue of running index maintenance at low priority.

    ``ratio`` may be a zero-arg callable returning the current ratio —
    the MVCC writer passes one that flips from 0 to 2.0 the moment a
    concurrent reader is observed, so an uncontended engine never sleeps.
    """
    prev = getattr(_build_priority, "yield_ratio", 0.0)
    _build_priority.yield_ratio = ratio if callable(ratio) else float(ratio)
    try:
        yield
    finally:
        _build_priority.yield_ratio = prev


def build_sleep(seconds: float) -> None:
    """Cooperative-yield sleep with duty-cycle accounting.

    Every deprioritization sleep (the classify chunk loop here, the
    pruning iteration loop, the prewarm backstop) routes through this so
    the MVCC writer can report its throttle duty cycle — slept wall time
    over total update time — as an obs gauge."""
    if seconds <= 0.0:
        return
    time.sleep(seconds)
    _build_priority.slept_total = (
        getattr(_build_priority, "slept_total", 0.0) + seconds
    )


def build_slept_s() -> float:
    """This thread's cumulative :func:`build_sleep` time (monotone —
    callers diff two readings around a throttled region)."""
    return getattr(_build_priority, "slept_total", 0.0)


@dataclasses.dataclass
class OccluderGrid:
    """Packed grid index (host arrays; move to device as needed).

    ``base``:  ``[G*G]`` int32 fully-covering triangle counts.
    ``lists``: ``[G*G, L]`` int32 partial-overlap triangle ids, -1 padded.
    ``coeffs``: ``[M, 3, 3]`` float32 edge functions of all triangles.
    """

    base: np.ndarray
    lists: np.ndarray
    coeffs: np.ndarray
    G: int
    rect: Rect

    @property
    def max_list(self) -> int:
        return self.lists.shape[1]

    def occupancy(self) -> float:
        """Mean real entries per cell list (diagnostics / bench_breakdown)."""
        return float((self.lists >= 0).sum() / max(len(self.lists), 1))


def _tri_cell_classify_many(
    tris: np.ndarray, coeffs: np.ndarray, rect: Rect, G: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized cell classification for ALL triangles in one pass.

    Expands each triangle's clamped-AABB cell range into flat
    (triangle, cell) candidate pairs and runs the SAT + full-containment
    tests over every pair at once — this is the index build's hot loop,
    and the per-triangle Python iteration it replaces dominated the
    dynamic writer's CPU share (scene prewarm rebuilds indexes inline).

    Separating axes = 2 box axes + 3 edge normals (closed-set test); full
    containment = all 4 cell corners pass all 3 inclusive edge tests.
    Cells are EXPANDED by a float-rounding guard when classifying: a user
    whose f32 cell assignment lands one ulp across a boundary must still
    see correct counts, so "fully covers the cell" is certified on the
    slightly larger box (near-boundary triangles demote to the partial
    list, where they are tested exactly).

    Returns ``(tri_idx [P], cell [P], full [P] bool, partial [P] bool)``.
    """
    M = len(tris)
    w = rect.width / G
    h = rect.height / G
    eps = 1e-5 * max(w, h)
    lo = tris.min(axis=1)  # [M, 2]
    hi = tris.max(axis=1)
    ix0 = np.clip(np.floor((lo[:, 0] - eps - rect.xmin) / w), 0, G - 1).astype(np.int64)
    ix1 = np.clip(np.floor((hi[:, 0] + eps - rect.xmin) / w - 1e-12), 0, G - 1).astype(np.int64)
    iy0 = np.clip(np.floor((lo[:, 1] - eps - rect.ymin) / h), 0, G - 1).astype(np.int64)
    iy1 = np.clip(np.floor((hi[:, 1] + eps - rect.ymin) / h - 1e-12), 0, G - 1).astype(np.int64)
    outside = (
        (hi[:, 0] < rect.xmin) | (lo[:, 0] > rect.xmax)
        | (hi[:, 1] < rect.ymin) | (lo[:, 1] > rect.ymax)
    )
    ny = iy1 - iy0 + 1
    counts = np.where(outside, 0, (ix1 - ix0 + 1) * ny)  # pairs per triangle
    tri_idx = np.repeat(np.arange(M), counts)  # [P]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    local = np.arange(int(counts.sum())) - np.repeat(starts, counts)
    ny_r = ny[tri_idx]
    gx = ix0[tri_idx] + local // ny_r
    gy = iy0[tri_idx] + local % ny_r

    # Each edge function e(x, y) = a*x + b*y + c is affine, so its extrema
    # over the expanded cell's corners are exactly
    #     e(center) -/+ (|a| * hw + |b| * hh)
    # (hw/hh = expanded half-extents): the full-containment test is
    # min >= 0 on every edge, the SAT edge test is max >= 0 on every edge.
    # This prices 3 evaluations per pair instead of 12 corner ones, and the
    # per-triangle spread term is hoisted out of the pair loop entirely.
    hw = w / 2 + eps
    hh = h / 2 + eps
    spread_t = np.abs(coeffs[:, :, 0]) * hw + np.abs(coeffs[:, :, 1]) * hh  # [M, 3]

    # Chunked evaluation: bisector-strip triangles have AABBs spanning
    # thousands of cells, so P can reach millions — one monolithic ufunc
    # over that holds the GIL for ~100ms, which is exactly the latency
    # spike an MVCC *reader* thread would see while the writer prewarms
    # scenes.  Small chunks keep every C-level op a few ms.
    P = len(tri_idx)
    full = np.empty(P, bool)
    partial = np.empty(P, bool)
    chunk = 1 << 18
    for s in range(0, max(P, 1), chunk):
        yield_ratio = build_yield_ratio()  # per chunk: ratio may be dynamic
        t_chunk = time.perf_counter() if yield_ratio else 0.0
        sl = slice(s, min(s + chunk, P))
        ti = tri_idx[sl]
        cx = rect.xmin + (gx[sl] + 0.5) * w  # cell centers  [C]
        cy = rect.ymin + (gy[sl] + 0.5) * h
        co = coeffs[ti]  # [C, 3, 3]
        e_c = co[:, :, 0] * cx[:, None] + co[:, :, 1] * cy[:, None] + co[:, :, 2]
        sp = spread_t[ti]
        f = np.all(e_c - sp >= 0.0, axis=-1)  # every corner inside every edge
        ov = np.all(e_c + sp >= 0.0, axis=-1)  # SAT: some corner not outside
        # box axes: triangle AABB vs expanded cell (already restricted to
        # the AABB range, but fringe cells may still miss on the exact AABB)
        ov &= (
            (cx + hw >= lo[ti, 0]) & (cx - hw <= hi[ti, 0])
            & (cy + hh >= lo[ti, 1]) & (cy - hh <= hi[ti, 1])
        )
        full[sl] = f
        # a cell whose every corner is inside but SAT failed cannot happen
        partial[sl] = ov & ~f
        if yield_ratio:
            build_sleep((time.perf_counter() - t_chunk) * yield_ratio)
    return tri_idx, gx * G + gy, full, partial


def _tri_cell_classify(
    tri: np.ndarray, coeff: np.ndarray, rect: Rect, G: int
) -> tuple[np.ndarray, np.ndarray]:
    """(full_cells, partial_cells) flat cell ids for one triangle — the
    single-triangle view of :func:`_tri_cell_classify_many` (the refit
    path classifies only the changed triangles)."""
    _, cell, full, partial = _tri_cell_classify_many(
        tri[None], coeff[None], rect, G
    )
    return cell[full], cell[partial]


def build_grid(
    tris: np.ndarray,
    coeffs: np.ndarray,
    rect: Rect,
    G: int = 64,
) -> OccluderGrid:
    """Build the grid index over real (unpadded) triangles."""
    tris = np.asarray(tris, dtype=np.float64).reshape(-1, 3, 2)
    coeffs64 = np.asarray(coeffs, dtype=np.float64).reshape(-1, 3, 3)
    tri_idx, cell, full, partial = _tri_cell_classify_many(
        tris, coeffs64, rect, G
    )
    base = np.bincount(cell[full], minlength=G * G).astype(np.int32)
    # group the partial pairs by cell (triangle ids ascending within each
    # cell, matching the order a per-triangle append loop would produce)
    pc, pt = cell[partial], tri_idx[partial]
    order = np.lexsort((pt, pc))
    pc, pt = pc[order], pt[order]
    cnts = np.bincount(pc, minlength=G * G)
    L = max(int(cnts.max()) if len(pc) else 0, 1)
    lists = np.full((G * G, L), -1, np.int32)
    if len(pc):
        starts = np.concatenate([[0], np.cumsum(cnts)])[:-1]
        rank = np.arange(len(pc)) - starts[pc]
        lists[pc, rank] = pt.astype(np.int32)
    return OccluderGrid(
        base=base,
        lists=lists,
        coeffs=np.asarray(coeffs, dtype=np.float32),
        G=G,
        rect=rect,
    )


def refit_grid(
    grid: OccluderGrid,
    tris_old: np.ndarray,
    coeffs_old: np.ndarray,
    tris_new: np.ndarray,
    coeffs_new: np.ndarray,
    changed: np.ndarray,
) -> OccluderGrid | None:
    """Refit a grid index for a perturbed triangle set without a full rebuild.

    ``changed`` lists triangle ids whose geometry differs between the old
    arrays (the ones ``grid`` was built from) and the new ones; all other
    triangles must be identical.  Each changed triangle's old cell
    classification is subtracted and its new one added — O(|changed|)
    classification work instead of O(M).  Counts are exact regardless of
    list order (``hits = base + #inside-of-listed``), so a refit grid is
    count-identical to a fresh :func:`build_grid`.

    Returns a new :class:`OccluderGrid` (the input is never mutated — cached
    scenes may still alias it), or ``None`` when the refit cannot be done in
    place (triangle count changed, or a cell's candidate list would overflow
    the padded width) — the caller falls back to :func:`build_grid`.
    """
    if len(tris_old) != len(tris_new):
        return None
    changed = np.asarray(changed, dtype=np.int64)
    base = grid.base.copy()
    lists = grid.lists.copy()
    coeffs = grid.coeffs.copy()
    G, rect = grid.G, grid.rect
    tris_old = np.asarray(tris_old, np.float64)
    tris_new = np.asarray(tris_new, np.float64)
    co_old = np.asarray(coeffs_old, np.float64)
    co_new = np.asarray(coeffs_new, np.float64)
    for t in changed:
        t = int(t)
        full_o, part_o = _tri_cell_classify(tris_old[t], co_old[t], rect, G)
        full_n, part_n = _tri_cell_classify(tris_new[t], co_new[t], rect, G)
        base[full_o] -= 1
        base[full_n] += 1
        for c in part_o:
            row = lists[int(c)]
            row[row == t] = -1
        for c in part_n:
            row = lists[int(c)]
            slots = np.flatnonzero(row < 0)
            if not len(slots):
                return None  # padded width exhausted: rebuild
            row[slots[0]] = t
        coeffs[t] = co_new[t].astype(np.float32)
    return OccluderGrid(base=base, lists=lists, coeffs=coeffs, G=G, rect=rect)


def shape_bucket(x: int, floor: int = 8) -> int:
    """Round ``x`` up to a quarter-octave shape bucket (>= ``floor``).

    Padded axes quantized through this stay stable under the small size
    drift dynamic updates produce, so the jitted batch dispatches reuse
    their compiled executables instead of recompiling every time a scene
    gains or loses a few triangles.  Overshoot is bounded by ~25% and the
    padding is semantically free (padded slots contribute nothing).
    """
    x = max(int(x), 1)
    if x <= floor:
        return floor
    step = 1 << max((x - 1).bit_length() - 3, 0)
    return -(-x // step) * step


def stack_grids(grids: list[OccluderGrid]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-query grid indices to common static shapes for one batched
    dispatch.

    All grids must share ``G`` and ``rect`` (the serving setup: one domain,
    many query scenes).  Candidate lists are right-padded with ``-1`` to the
    max list length; triangle coefficient tables are padded with degenerate
    never-inside rows so gathers on padded ids contribute nothing.  Both
    padded axes are :func:`shape_bucket`-quantized for executable reuse
    across update-churned batches.  Returns
    ``(base [Q, G*G] i32, lists [Q, G*G, L] i32, coeffs [Q, Mt, 3, 3] f32)``.
    """
    if not grids:
        raise ValueError("stack_grids needs at least one grid")
    G = grids[0].G
    if any(g.G != G for g in grids):
        raise ValueError("all grids in a batch must share G")
    rect = grids[0].rect
    if any(g.rect != rect for g in grids):
        raise ValueError("all grids in a batch must share the domain rect")
    L = shape_bucket(max(g.lists.shape[1] for g in grids), floor=1)
    Mt = shape_bucket(max(max(len(g.coeffs), 1) for g in grids), floor=1)
    Q = len(grids)
    base = np.stack([g.base for g in grids]).astype(np.int32)
    lists = np.full((Q, G * G, L), -1, np.int32)
    coeffs = np.zeros((Q, Mt, 3, 3), np.float32)
    coeffs[:, :, :, 2] = -1.0  # degenerate default (never inside)
    for i, g in enumerate(grids):
        lists[i, :, : g.lists.shape[1]] = g.lists
        if len(g.coeffs):
            coeffs[i, : len(g.coeffs)] = g.coeffs
    return base, lists, coeffs


def grid_hit_counts_torch(xs, ys, base, lists, coeffs, rect: Rect, G: int) -> torch.Tensor:
    """Grid query over one index: ``[N]`` int32 on the device of ``xs``.

    ``hits[u] = base[cell(u)] + sum_t in list[cell(u)] inside(u, t)``.
    ``base`` ``[G*G]``, ``lists`` ``[G*G, L]`` and ``coeffs`` ``[M, 3, 3]``
    may be numpy arrays or tensors; they are moved to the users' device.
    """
    dev = xs.device
    base = torch.as_tensor(base, dtype=torch.int32, device=dev)
    lists = torch.as_tensor(lists, dtype=torch.int64, device=dev)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    if coeffs.shape[0] == 0:  # occluder-free scenes: keep the gather legal
        coeffs = torch.tensor([[0.0, 0.0, -1.0]] * 3, device=dev)[None]  # degenerate
    lo = (float(rect.xmin), float(rect.ymin))
    size = (float(rect.width), float(rect.height))
    chunk = max(1, _GATHER_ELEMS // (9 * max(int(lists.shape[1]), 1)))
    n = xs.shape[0]
    if n <= chunk:
        return _ref.grid_raycast_ref(xs, ys, base, lists, coeffs, lo, size, G)
    return torch.cat([
        _ref.grid_raycast_ref(xs[s : s + chunk], ys[s : s + chunk], base, lists, coeffs, lo, size, G)
        for s in range(0, n, chunk)
    ])


def grid_hit_counts_batch_torch(xs, ys, base, lists, coeffs, rect: Rect, G: int) -> torch.Tensor:
    """Batched grid counting: ``[Q, N]`` int32 on the device of ``xs``.

    ``base``: ``[Q, G*G]``; ``lists``: ``[Q, G*G, L]``; ``coeffs``:
    ``[Q, Mt, 3, 3]`` (from :func:`stack_grids`).  One query at a time, each
    chunked over users: the JAX version's ``[N, L, 3, 3]`` gather per query
    would take several GB at road-network scale.
    """
    q_n = len(base)
    if q_n == 0:
        return torch.zeros((0, xs.shape[0]), dtype=torch.int32, device=xs.device)
    return torch.stack([
        grid_hit_counts_torch(xs, ys, base[i], lists[i], coeffs[i], rect, G) for i in range(q_n)
    ])


def grid_from_arrays(base, lists, coeffs, G: int, rect) -> OccluderGrid:
    """An :class:`OccluderGrid` of this package from another's fields.

    ``rect`` is any object with ``xmin, ymin, xmax, ymax`` (typically the
    reference JAX package's ``OccluderGrid``'s); the arrays are copied,
    so both packages' count paths can be fed one identical index.  The
    counterpart of :func:`repro_torch.core.scene.scene_from_arrays`.
    """
    return OccluderGrid(
        base=np.array(base, dtype=np.int32),
        lists=np.array(lists, dtype=np.int32),
        coeffs=np.array(coeffs, dtype=np.float32),
        G=int(G),
        rect=Rect(float(rect.xmin), float(rect.ymin), float(rect.xmax), float(rect.ymax)),
    )
