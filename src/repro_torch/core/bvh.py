"""Paper-faithful BVH path: LBVH build + any-hit traversal with early exit.

The port of ``repro.core.bvh``: the reference execution model of the
paper's Algorithm 1/2, what the OptiX implementation does minus the
fixed-function hardware:

* an LBVH is built over the occluder triangles (Morton-ordered median
  splits; one primitive per leaf, as in paper Fig. 5),
* every user is a vertical ray; since the ray direction is ``(0,0,-1)`` the
  ray–AABB slab test degenerates to 2-D point-in-rectangle and the
  ray–triangle test to 2-D point-in-triangle,
* traversal keeps an explicit stack and terminates the ray as soon as the
  hit count reaches ``k`` (``optixTerminateRay`` in Alg. 2 line 16).

Build, refit and stacking are host numpy, bit-identical to the JAX
package's.  The traversal goes through :mod:`repro_torch.kernels.ops`:
on CUDA tensors the hand-written stack-walk kernel
(``csrc/bvh_traverse.cu``, one thread per (query, user), which is the
SIMT model's home ground), on CPU tensors its plain PyTorch version.
Unlike the JAX ``while_loop``, whose stack silently drops a push past
``max_stack``, the port raises when a tree is deeper than its stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels import ops as _ops
from repro_torch.kernels.bvh import MAX_STACK, stack_depth

__all__ = [
    "BVH",
    "build_bvh",
    "refit_bvh",
    "bvh_hit_counts",
    "stack_bvhs",
    "stack_depth",
    "bvh_hit_counts_batch",
    "MAX_STACK",
]


@dataclasses.dataclass
class BVH:
    """Array-encoded binary BVH.

    ``left``/``right``: child node ids; for leaves ``left = -(tri_idx + 1)``
    and ``right = -1``.  ``bbox``: ``[n_nodes, 4]`` as (xmin, ymin, xmax,
    ymax).  ``n_tris`` real triangles; root is node 0.
    """

    left: np.ndarray
    right: np.ndarray
    bbox: np.ndarray
    n_tris: int

    @property
    def n_nodes(self) -> int:
        return len(self.left)

    def depth(self) -> int:
        """Max depth, the root at 1: the stack entries a walk needs."""
        return stack_depth(self.left, self.right)


def _morton2d(xs: np.ndarray, ys: np.ndarray, bits: int = 16) -> np.ndarray:
    """Interleave quantized x/y into 2*bits Morton codes."""

    def _part(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    q = (1 << bits) - 1
    xi = np.clip((xs * q).astype(np.int64), 0, q)
    yi = np.clip((ys * q).astype(np.int64), 0, q)
    return _part(xi) | (_part(yi) << np.uint64(1))


def build_bvh(tris: np.ndarray) -> BVH:
    """LBVH over ``[M, 3, 2]`` triangles (host, numpy).

    Morton-sorts centroids then median-splits the sorted range — the
    standard linear-BVH construction (paper refs [53–55]) which yields
    spatially coherent subtrees without a full SAH sweep.
    """
    tris = np.asarray(tris, dtype=np.float64)
    M = len(tris)
    if M == 0:
        return BVH(
            left=np.array([-1], np.int32),
            right=np.array([-1], np.int32),
            bbox=np.zeros((1, 4), np.float32),
            n_tris=0,
        )
    lo = tris.min(axis=1)  # [M, 2]
    hi = tris.max(axis=1)
    cent = (lo + hi) / 2.0
    cmin = cent.min(axis=0)
    cspan = np.maximum(cent.max(axis=0) - cmin, 1e-12)
    norm = (cent - cmin) / cspan
    order = np.argsort(_morton2d(norm[:, 0], norm[:, 1]), kind="stable")

    n_nodes = 2 * M - 1
    left = np.full(n_nodes, -1, np.int32)
    right = np.full(n_nodes, -1, np.int32)
    bbox = np.zeros((n_nodes, 4), np.float64)

    next_id = [0]

    def alloc() -> int:
        i = next_id[0]
        next_id[0] += 1
        return i

    # iterative build: stack of (node_id, lo, hi) ranges over `order`
    root = alloc()
    stack: list[tuple[int, int, int]] = [(root, 0, M)]
    while stack:
        node, s, e = stack.pop()
        idx = order[s:e]
        bbox[node, :2] = lo[idx].min(axis=0)
        bbox[node, 2:] = hi[idx].max(axis=0)
        if e - s == 1:
            left[node] = -(int(idx[0]) + 1)
            right[node] = -1
            continue
        mid = (s + e) // 2
        l_id, r_id = alloc(), alloc()
        left[node] = l_id
        right[node] = r_id
        stack.append((l_id, s, mid))
        stack.append((r_id, mid, e))

    return BVH(left=left, right=right, bbox=bbox.astype(np.float32), n_tris=M)


def refit_bvh(
    bvh: BVH, tris_new: np.ndarray, *, max_growth: float = 1.5
) -> BVH | None:
    """Refit node AABBs to perturbed triangles, keeping the topology.

    The graphics-pipeline *refit* operation: when primitives move slightly,
    the tree structure is reused and only the boxes are recomputed
    bottom-up (children are always allocated after their parent, so
    descending node ids are a valid child-before-parent order).  Traversal
    counts are unaffected by stale topology — boxes stay conservative, so
    a refit BVH is count-identical to a fresh Morton-ordered rebuild.

    Quality gate: Morton order goes stale as primitives drift, inflating
    the boxes and the traversal cost.  When the total internal-node box
    area grows past ``max_growth``× the pre-refit area, ``None`` is
    returned and the caller should rebuild.  Also returns ``None`` when
    the triangle count changed (topology no longer matches).
    """
    tris_new = np.asarray(tris_new, dtype=np.float64)
    if bvh.n_tris != len(tris_new):
        return None
    if bvh.n_tris == 0:
        return BVH(bvh.left.copy(), bvh.right.copy(), bvh.bbox.copy(), 0)
    lo = tris_new.min(axis=1)  # [M, 2]
    hi = tris_new.max(axis=1)
    n = bvh.n_nodes
    bbox = np.zeros((n, 4), np.float64)
    left, right = bvh.left, bvh.right
    for node in range(n - 1, -1, -1):
        l = int(left[node])
        if l < 0:  # leaf: one primitive
            tri = -l - 1
            bbox[node, :2] = lo[tri]
            bbox[node, 2:] = hi[tri]
        else:
            r = int(right[node])
            bbox[node, :2] = np.minimum(bbox[l, :2], bbox[r, :2])
            bbox[node, 2:] = np.maximum(bbox[l, 2:], bbox[r, 2:])
    internal = left >= 0
    if internal.any():
        old = bvh.bbox.astype(np.float64)
        area_old = float(
            ((old[internal, 2] - old[internal, 0])
             * (old[internal, 3] - old[internal, 1])).sum()
        )
        area_new = float(
            ((bbox[internal, 2] - bbox[internal, 0])
             * (bbox[internal, 3] - bbox[internal, 1])).sum()
        )
        if area_new > max_growth * area_old + 1e-12:
            return None
    return BVH(left.copy(), right.copy(), bbox.astype(np.float32), bvh.n_tris)


def stack_bvhs(
    bvhs: list[BVH], coeffs_list: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-query BVHs + triangle coefficients to static batch shapes.

    Node arrays are right-padded to the max node count (padding nodes are
    unreachable from the root, so their contents never matter); coefficient
    tables are padded with degenerate never-inside rows.  Returns
    ``(left [Q, Nn], right [Q, Nn], bbox [Q, Nn, 4], coeffs [Q, Mt, 3, 3])``.
    """
    if not bvhs:
        raise ValueError("stack_bvhs needs at least one BVH")
    Q = len(bvhs)
    Nn = max(b.n_nodes for b in bvhs)
    Mt = max(max(len(c), 1) for c in coeffs_list)
    left = np.full((Q, Nn), -1, np.int32)
    right = np.full((Q, Nn), -1, np.int32)
    bbox = np.zeros((Q, Nn, 4), np.float32)
    coeffs = np.zeros((Q, Mt, 3, 3), np.float32)
    coeffs[:, :, :, 2] = -1.0  # degenerate default (never inside)
    for i, (b, cf) in enumerate(zip(bvhs, coeffs_list)):
        left[i, : b.n_nodes] = b.left
        right[i, : b.n_nodes] = b.right
        bbox[i, : b.n_nodes] = b.bbox
        if len(cf):
            coeffs[i, : len(cf)] = np.asarray(cf, np.float32)
    return left, right, bbox, coeffs


def bvh_hit_counts(
    xs,
    ys,
    left,
    right,
    bbox,
    coeffs,
    k: int | None = None,
    max_stack: int = MAX_STACK,
    *,
    order=None,
):
    """Per-user occluder hit counts via stack traversal.

    ``xs, ys``: ``[N]`` user coordinates (torch tensors; the count runs on
    their device).  ``coeffs``: ``[M, 3, 3]`` edge functions.  ``k``:
    early-termination threshold (``None`` counts all hits).  Returns
    ``[N]`` int32 counts saturated at ``k`` when early termination is
    active — exactly the information Alg. 2 extracts.  ``max_stack``: the
    stack the walk may use (at most :data:`MAX_STACK`); a deeper tree
    raises ``ValueError`` (the depth is :func:`stack_depth` of the node
    arrays).  ``order``: the kernel's user order, built when ``None``.
    """
    return _ops.bvh_count(
        xs, ys, left, right, bbox, coeffs, k=k, max_stack=max_stack, order=order
    )


def bvh_hit_counts_batch(
    xs,
    ys,
    left,
    right,
    bbox,
    coeffs,
    k: int | None = None,
    max_stack: int = MAX_STACK,
    *,
    order=None,
):
    """Batched multi-query traversal: ``[Q, N]`` counts in one dispatch.

    ``left/right``: ``[Q, Nn]``; ``bbox``: ``[Q, Nn, 4]``; ``coeffs``:
    ``[Q, Mt, 3, 3]`` (from :func:`stack_bvhs`); users are shared across
    queries.  Early termination at ``k`` applies per (query, user) lane.

    An empty scene's BVH (what :func:`build_bvh` emits for ``M == 0``) is a
    single leaf root referencing triangle 0, which :func:`stack_bvhs` pads
    with a degenerate never-inside coefficient row — so it counts zero hits.
    ``max_stack`` and ``order`` as in :func:`bvh_hit_counts`.
    """
    return _ops.bvh_count_batch(
        xs, ys, left, right, bbox, coeffs, k=k, max_stack=max_stack, order=order
    )
