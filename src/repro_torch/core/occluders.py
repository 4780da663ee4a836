"""Occluder construction — paper Definition 3.1, all four scenarios.

For a competitor facility ``a`` and query facility ``q`` inside the domain
rectangle ``R``, the *invalid region* is ``{p in R : dist(p, a) < dist(p, q)}``
(the open half-plane ``p.n < c`` of the bisector, clipped to ``R``).  The
occluder is a set of one or two triangles whose union, **restricted to R**,
equals that invalid region:

(a) *normal*:   the invalid region contains exactly one corner of ``R`` →
                a single triangle ``(v, p1, p2)`` where ``p1, p2`` are the
                bisector's hits on the two boundary edges incident to ``v``;
(b) *extended*: the invalid region contains two or three corners (a quad or
                pentagon) → a single **covering triangle** with one edge on
                the bisector line, extended so far beyond ``R`` that inside
                ``R`` its coverage equals the half-plane exactly;
(c) *vertical bisector* (``n_y == 0``):   the invalid region is a rectangle →
                two triangles ``(v1, p1, p2)`` and ``(v1, v2, p2)``;
(d) *horizontal bisector* (``n_x == 0``): symmetric to (c).

The paper lifts each occluder to a distinct height ``z``; because every user
ray is vertical, the lift never changes hit outcomes and we keep occluders in
2-D (DESIGN.md §2, changed assumption 1).  ``z`` is retained as metadata only
so the faithful BVH path can report paper-consistent layered scenes.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.geometry import (
    Rect,
    bisector,
    edge_coeffs,
    ensure_ccw,
    line_rect_intersections,
)

__all__ = ["occluder_triangles", "occluders_for_facilities", "OCCLUDER_MAX_TRIS"]

# Any single occluder needs at most 2 triangles (cases c/d).
OCCLUDER_MAX_TRIS = 2

_EPS = 1e-12


def _covering_triangle(n: np.ndarray, c: float, rect: Rect) -> np.ndarray:
    """Case (b): one big triangle with an edge on the bisector line.

    Construction: take the bisector's chord through ``R`` (endpoints
    ``p1, p2``), extend it by 4 diagonals on both ends (so the two slanted
    triangle edges pass far outside ``R``) and place the apex 4 diagonals
    deep on the invalid side.  Inside ``R`` the triangle's boundary is then
    exactly the bisector line, so triangle ∩ R == invalid half-plane ∩ R.
    """
    pts = line_rect_intersections(n, c, rect)
    if len(pts) < 2:
        # Line grazes a corner: invalid region is (almost) all or none of R.
        # Fall back to a triangle covering the whole invalid side around R.
        pts = np.asarray(
            [pts[0] if len(pts) else [rect.xmin, rect.ymin], [rect.xmax, rect.ymax]],
            dtype=np.float64,
        )
    p1, p2 = pts[0], pts[1]
    d = rect.diagonal
    t = p2 - p1
    tn = np.linalg.norm(t)
    if tn < _EPS:  # degenerate chord; treat as covering nothing
        return np.zeros((0, 3, 2), dtype=np.float64)
    t = t / tn
    nn = np.asarray(n, dtype=np.float64)
    nn = nn / np.linalg.norm(nn)
    e1 = p1 - t * (4.0 * d)
    e2 = p2 + t * (4.0 * d)
    apex = (p1 + p2) / 2.0 - nn * (4.0 * d)  # -n direction = invalid side
    return ensure_ccw(np.asarray([[e1, e2, apex]], dtype=np.float64))


def _axis_aligned_occluder(n: np.ndarray, c: float, rect: Rect, axis: int) -> np.ndarray:
    """Cases (c)/(d): bisector parallel to an axis → rectangular invalid region.

    ``axis == 0``: vertical bisector ``x == c/n_x`` (n_y == 0).
    ``axis == 1``: horizontal bisector ``y == c/n_y`` (n_x == 0).
    Returns two triangles tiling the invalid rectangle.
    """
    if axis == 0:
        xb = c / n[0]
        xb = float(np.clip(xb, rect.xmin, rect.xmax))
        # invalid side: x * n_x < c
        if n[0] > 0:
            x0, x1 = rect.xmin, xb
        else:
            x0, x1 = xb, rect.xmax
        quad = np.array(
            [[x0, rect.ymin], [x1, rect.ymin], [x1, rect.ymax], [x0, rect.ymax]]
        )
    else:
        yb = c / n[1]
        yb = float(np.clip(yb, rect.ymin, rect.ymax))
        if n[1] > 0:
            y0, y1 = rect.ymin, yb
        else:
            y0, y1 = yb, rect.ymax
        quad = np.array(
            [[rect.xmin, y0], [rect.xmax, y0], [rect.xmax, y1], [rect.xmin, y1]]
        )
    if abs(quad[0, 0] - quad[1, 0]) < _EPS and abs(quad[0, 1] - quad[3, 1]) < _EPS:
        return np.zeros((0, 3, 2), dtype=np.float64)
    tris = np.asarray(
        [[quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]], dtype=np.float64
    )
    return ensure_ccw(tris)


def occluder_triangles(a: np.ndarray, q: np.ndarray, rect: Rect) -> np.ndarray:
    """Triangles (``[T, 3, 2]``, T in {0, 1, 2}) of the occluder ``O_{a:q}``.

    The union of the returned triangles, intersected with ``rect``, equals
    the invalid region of the bisector ``B_{a:q}`` (property-tested in
    ``tests/test_geometry.py``).
    """
    a = np.asarray(a, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n, c = bisector(a, q)
    nrm = float(np.linalg.norm(n))
    if nrm < _EPS:
        # a == q: no competitor information; empty occluder.
        return np.zeros((0, 3, 2), dtype=np.float64)

    scale = max(1.0, abs(c), nrm)
    if abs(n[1]) < _EPS * scale:  # bisector vertical (case c)
        return _axis_aligned_occluder(n, c, rect, axis=0)
    if abs(n[0]) < _EPS * scale:  # bisector horizontal (case d)
        return _axis_aligned_occluder(n, c, rect, axis=1)

    corners = rect.corners()
    d = corners @ n - c  # < 0 strictly invalid
    tol = 1e-12 * scale * rect.diagonal
    invalid = d < -tol
    n_inv = int(invalid.sum())

    if n_inv == 0:
        # Bisector passes outside (or grazes) R on the invalid side.
        # If *any* interior point is invalid the region is a sliver with no
        # corner; cover it with the covering triangle, else empty.
        try:
            pts = line_rect_intersections(n, c, rect)
        except ValueError:
            return np.zeros((0, 3, 2), dtype=np.float64)
        if len(pts) < 2:
            return np.zeros((0, 3, 2), dtype=np.float64)
        return _covering_triangle(n, c, rect)

    if n_inv == 1:
        # Case (a): single corner v; bisector crosses both incident edges.
        vi = int(np.argmax(invalid))
        v = corners[vi]
        try:
            pts = line_rect_intersections(n, c, rect)
        except ValueError:
            return np.zeros((0, 3, 2), dtype=np.float64)
        if len(pts) < 2:
            return np.zeros((0, 3, 2), dtype=np.float64)
        # The two chord endpoints must lie on the edges incident to v; when
        # the chord clips a different corner (numerical grazing) fall back to
        # the covering triangle, which is always exact inside R.
        p1, p2 = pts[0], pts[1]
        on_incident = (
            (abs(p1[0] - v[0]) < 1e-9 * scale or abs(p1[1] - v[1]) < 1e-9 * scale)
            and (abs(p2[0] - v[0]) < 1e-9 * scale or abs(p2[1] - v[1]) < 1e-9 * scale)
        )
        if not on_incident:
            return _covering_triangle(n, c, rect)
        return ensure_ccw(np.asarray([[v, p1, p2]], dtype=np.float64))

    if n_inv >= 3:
        # Pentagon (3 corners invalid): Def 3.1 does not enumerate this case
        # explicitly; the paper's "extended" covering construction applies
        # verbatim and stays exact inside R.
        return _covering_triangle(n, c, rect)

    # n_inv == 2 — Case (b), quad region -> single covering triangle.
    return _covering_triangle(n, c, rect)


def occluders_for_facilities(
    facilities: np.ndarray,
    q: np.ndarray,
    rect: Rect,
    keep: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build occluders for every kept facility.

    Returns ``(tris [T, 3, 2], coeffs [T, 3, 3], owner [T])`` where
    ``owner[t]`` is the facility row index that produced triangle ``t``
    (cases c/d contribute two triangles with the same owner — hit *counting*
    must deduplicate per owner only for points exactly on the shared
    diagonal, which is measure-zero; the two triangles partition the
    rectangle so interior double-hits cannot occur).
    """
    facilities = np.asarray(facilities, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    if keep is None:
        keep = np.ones(len(facilities), dtype=bool)
    tris: list[np.ndarray] = []
    owners: list[int] = []
    for i in np.flatnonzero(keep):
        t = occluder_triangles(facilities[i], q, rect)
        for tri in t:
            tris.append(tri)
            owners.append(int(i))
    if not tris:
        tris_arr = np.zeros((0, 3, 2), dtype=np.float64)
    else:
        tris_arr = np.asarray(tris, dtype=np.float64)
    coeffs = edge_coeffs(tris_arr) if len(tris_arr) else np.zeros((0, 3, 3))
    return tris_arr, coeffs, np.asarray(owners, dtype=np.int32)
