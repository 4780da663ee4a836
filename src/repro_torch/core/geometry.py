"""Planar geometry primitives underpinning the RT-RkNN formulation.

Everything here is exact-ish float geometry on the host (numpy, float64) plus
mirrored jnp helpers used on device.  The central objects:

* a rectangular domain ``Rect`` (the paper's bounded space ``R``),
* perpendicular bisectors in *normal form*: the bisector of facilities
  ``a`` (competitor) and ``q`` (query) is ``{p : p.n == c}`` with
  ``n = q - a`` and ``c = (|q|^2 - |a|^2) / 2``; the *invalid side*
  (``a`` strictly closer than ``q``) is the open half-plane ``p.n < c``,
* triangles in **edge-function form**: a CCW triangle is the set
  ``{p : e_i(p) >= 0 for i in 0..2}`` with ``e_i(p) = a_i x + b_i y + c_i``.
  A vertical ray through a layered 3-D occluder (paper Def. 3.1/3.3) hits it
  iff the 2-D point passes all three edge tests — this *dimension collapse*
  is the key TPU adaptation (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Rect",
    "bisector",
    "signed_area",
    "ensure_ccw",
    "edge_coeffs",
    "points_in_tris_np",
    "line_rect_intersections",
    "clip_polygon_halfplane",
    "polygon_area",
    "DEGENERATE_EDGE",
]

# Edge coefficients of a triangle that no point can ever be inside of
# (e(p) = -1 < 0 for every edge).  Used to pad scenes to static shapes.
DEGENERATE_EDGE = np.array([[0.0, 0.0, -1.0]] * 3, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned rectangular domain ``R`` (paper Def. 3.1)."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_bounds(lo: np.ndarray, hi: np.ndarray, pad_frac: float = 0.01) -> "Rect":
        """Padded rectangle from precomputed ``[2]`` min/max bounds.

        The pad keeps users strictly interior so boundary-degenerate
        occluder cases (bisector through a corner) have measure ~zero.
        """
        span = np.maximum(np.asarray(hi, np.float64) - np.asarray(lo, np.float64), 1e-9)
        pad = pad_frac * span
        return Rect(
            float(lo[0] - pad[0]),
            float(lo[1] - pad[1]),
            float(hi[0] + pad[0]),
            float(hi[1] + pad[1]),
        )

    @staticmethod
    def from_points(*point_sets: np.ndarray, pad_frac: float = 0.01) -> "Rect":
        """Bounding rectangle of one or more ``[N, 2]`` point sets, padded."""
        pts = np.concatenate([np.asarray(p, dtype=np.float64) for p in point_sets])
        return Rect.from_bounds(pts.min(axis=0), pts.max(axis=0), pad_frac)

    # ---- basic queries -------------------------------------------------
    @property
    def width(self) -> float:
        return self.xmax - self.xmin

    @property
    def height(self) -> float:
        return self.ymax - self.ymin

    @property
    def diagonal(self) -> float:
        return float(np.hypot(self.width, self.height))

    def corners(self) -> np.ndarray:
        """The four corners, CCW starting from (xmin, ymin): ``[4, 2]``."""
        return np.array(
            [
                [self.xmin, self.ymin],
                [self.xmax, self.ymin],
                [self.xmax, self.ymax],
                [self.xmin, self.ymax],
            ],
            dtype=np.float64,
        )

    def contains(self, pts: np.ndarray, atol: float = 0.0) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float64)
        return (
            (pts[..., 0] >= self.xmin - atol)
            & (pts[..., 0] <= self.xmax + atol)
            & (pts[..., 1] >= self.ymin - atol)
            & (pts[..., 1] <= self.ymax + atol)
        )

    def as_polygon(self) -> np.ndarray:
        return self.corners()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        xy = rng.random((n, 2))
        xy[:, 0] = self.xmin + xy[:, 0] * self.width
        xy[:, 1] = self.ymin + xy[:, 1] * self.height
        return xy


# --------------------------------------------------------------------------
# Bisectors
# --------------------------------------------------------------------------

def bisector(a: np.ndarray, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Normal form of the perpendicular bisector between ``a`` and ``q``.

    Supports batched ``a``: ``a`` may be ``[2]`` or ``[M, 2]``; ``q`` is
    ``[2]``.  Returns ``(n, c)`` with ``n = q - a`` (shape like ``a``) and
    ``c = (|q|^2 - |a|^2)/2`` such that:

    * invalid side (``a`` strictly closer):  ``p.n < c``
    * valid side   (``q`` closer or tied):   ``p.n >= c``.
    """
    a = np.asarray(a, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = q - a
    c = (np.sum(q * q, axis=-1) - np.sum(a * a, axis=-1)) / 2.0
    return n, c


def halfplane_signed(pts: np.ndarray, n: np.ndarray, c: float) -> np.ndarray:
    """``pts.n - c``; negative = strictly invalid side."""
    return pts @ np.asarray(n, dtype=np.float64) - c


# --------------------------------------------------------------------------
# Triangles / edge functions
# --------------------------------------------------------------------------

def signed_area(tris: np.ndarray) -> np.ndarray:
    """Twice the signed area of ``[..., 3, 2]`` triangles (CCW positive)."""
    v0, v1, v2 = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    return (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v1[..., 1] - v0[..., 1]
    ) * (v2[..., 0] - v0[..., 0])


def ensure_ccw(tris: np.ndarray) -> np.ndarray:
    """Flip vertex order where needed so all triangles are CCW."""
    tris = np.asarray(tris, dtype=np.float64).copy()
    flip = signed_area(tris) < 0.0
    if np.any(flip):
        tris[flip] = tris[flip][:, ::-1, :]
    return tris


def edge_coeffs(tris: np.ndarray) -> np.ndarray:
    """Edge-function coefficients for CCW ``[..., 3, 2]`` triangles.

    Returns ``[..., 3, 3]`` where row ``i`` holds ``(a, b, c)`` of edge
    ``v_i -> v_{i+1}`` with ``e(p) = a x + b y + c`` and the triangle
    interior satisfying ``e >= 0`` on all rows.  Degenerate (zero-area)
    triangles produce coefficient rows that are all-zero with ``c = -1``
    so that nothing is ever "inside" them — this makes padding safe.
    """
    tris = np.asarray(tris, dtype=np.float64)
    v = tris
    vn = np.roll(tris, -1, axis=-2)  # v_{i+1}
    a = -(vn[..., 1] - v[..., 1])
    b = vn[..., 0] - v[..., 0]
    c = -(a * v[..., 0] + b * v[..., 1])
    coeffs = np.stack([a, b, c], axis=-1)
    # kill degenerate triangles (zero signed area)
    degen = np.abs(signed_area(tris)) < 1e-30
    if np.any(degen):
        coeffs = coeffs.copy()
        coeffs[degen] = DEGENERATE_EDGE
    return coeffs


def points_in_tris_np(pts: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """``[N, M]`` bool containment matrix from points and edge coeffs.

    ``pts``: ``[N, 2]``; ``coeffs``: ``[M, 3, 3]``.  Inclusive (>= 0)
    boundary convention — ties on the bisector edge are measure-zero for
    continuous data and are excluded in property tests via margins.
    """
    pts = np.asarray(pts, dtype=np.float64)
    x = pts[:, 0][:, None, None]
    y = pts[:, 1][:, None, None]
    e = coeffs[None, :, :, 0] * x + coeffs[None, :, :, 1] * y + coeffs[None, :, :, 2]
    return np.all(e >= 0.0, axis=-1)


# --------------------------------------------------------------------------
# Line / rectangle intersections & polygon clipping
# --------------------------------------------------------------------------

def line_rect_intersections(n: np.ndarray, c: float, rect: Rect) -> np.ndarray:
    """Intersection points of the line ``{p.n == c}`` with ``rect``'s boundary.

    Returns the (up to 2, typically exactly 2) distinct intersection points
    as ``[K, 2]``.  Raises if the line misses the rectangle entirely.
    """
    nx, ny = float(n[0]), float(n[1])
    pts: list[tuple[float, float]] = []
    # vertical domain edges x = xmin / xmax  ->  y = (c - nx*x)/ny
    if abs(ny) > 0.0:
        for x in (rect.xmin, rect.xmax):
            y = (c - nx * x) / ny
            if rect.ymin - 1e-12 <= y <= rect.ymax + 1e-12:
                pts.append((x, float(np.clip(y, rect.ymin, rect.ymax))))
    # horizontal domain edges y = ymin / ymax -> x = (c - ny*y)/nx
    if abs(nx) > 0.0:
        for y in (rect.ymin, rect.ymax):
            x = (c - ny * y) / nx
            if rect.xmin - 1e-12 <= x <= rect.xmax + 1e-12:
                pts.append((float(np.clip(x, rect.xmin, rect.xmax)), y))
    if not pts:
        raise ValueError("line does not intersect the domain rectangle")
    # dedupe near-identical corner hits
    out: list[tuple[float, float]] = []
    for p in pts:
        if all(abs(p[0] - o[0]) + abs(p[1] - o[1]) > 1e-9 * (1.0 + rect.diagonal) for o in out):
            out.append(p)
    return np.asarray(out, dtype=np.float64)


def clip_polygon_halfplane(poly: np.ndarray, n: np.ndarray, c: float) -> np.ndarray:
    """Sutherland–Hodgman clip of ``poly`` to the closed half-plane ``p.n <= c``.

    ``poly``: ``[V, 2]`` CCW.  Returns the clipped polygon (possibly empty
    ``[0, 2]``).  Used to compute exact invalid regions in tests and in the
    InfZone-style zone bookkeeping.
    """
    poly = np.asarray(poly, dtype=np.float64)
    if len(poly) == 0:
        return poly
    n = np.asarray(n, dtype=np.float64)
    d = poly @ n - c  # <= 0 is inside (kept)
    out: list[np.ndarray] = []
    V = len(poly)
    for i in range(V):
        j = (i + 1) % V
        pi, pj = poly[i], poly[j]
        di, dj = d[i], d[j]
        if di <= 0.0:
            out.append(pi)
        if (di < 0.0 < dj) or (dj < 0.0 < di):
            t = di / (di - dj)
            out.append(pi + t * (pj - pi))
    if not out:
        return np.zeros((0, 2), dtype=np.float64)
    return np.asarray(out, dtype=np.float64)


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of a simple polygon ``[V, 2]`` (positive if CCW)."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
