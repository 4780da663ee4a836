"""Plain PyTorch versions of the CUDA kernels (``repro.kernels.ref``).

These run on tensors of any device.  On the CPU they are the path every
kernel wrapper takes (the parity tests hold them against the JAX
package); on the card they are what the kernels are compared with.  They
repeat the kernels' arithmetic and are no yardstick of speed.

Rounding contract: edge functions are evaluated as
``((x * a) + (y * b)) + c`` and squared distances as
``(dx * dx) + (dy * dy)``, one rounding per operation and no fused
multiply-add, exactly as ``repro_torch/csrc/*.cu`` writes them.

``calls`` counts calls into this module's functions, so a run can show
that it took no plain version.

:func:`raycast_tile_classes_ref` is the plain twin of the classifier
the ray-cast kernel applies per tile of users, and
:func:`grid_block_classes_ref` of the one the grid kernel applies per user
block, for tests and diagnostics: they repeat the kernels' float64
arithmetic and margin (derived in ``csrc/tile_class.cuh``).
:func:`rank_tile_classes_ref` is the twin of the rank-count kernel's
per-sub-tile facility classifier, in its float32 order with no margin
(derived in ``csrc/rank_count.cu``).  :func:`bvh_hit_counts_ref` is the
plain version of the BVH stack walk (``csrc/bvh_traverse.cu``), the same
walk written out over all lanes at once.
"""

from __future__ import annotations

import torch

__all__ = [
    "raycast_count_ref",
    "raycast_count_batch_ref",
    "raycast_tile_classes_ref",
    "grid_block_classes_ref",
    "TILE_SKIP",
    "TILE_FULL",
    "TILE_TEST",
    "rank_count_ref",
    "rank_count_batch_ref",
    "rank_tile_classes_ref",
    "grid_raycast_ref",
    "grid_cells_count_batch_ref",
    "bvh_hit_counts_ref",
]

#: Number of calls into the plain versions since the last reset to 0.
calls = 0


def _count() -> None:
    global calls
    calls += 1


def _affine(x, y, a, b, c):
    """``((x * a) + (y * b)) + c``, one rounding per operation, broadcast:
    the one order in which every kernel and plain version evaluates an
    edge function."""
    return (x * a + y * b) + c


def _edge(xs, ys, coeffs, i: int):
    """Edge ``i`` of ``coeffs`` ``[..., M, 3, 3]`` at users ``xs, ys``
    ``[N]``, broadcast to ``[..., N, M]``."""
    return _affine(
        xs[:, None], ys[:, None],
        coeffs[..., None, :, i, 0], coeffs[..., None, :, i, 1], coeffs[..., None, :, i, 2],
    )


def raycast_count_batch_ref(xs, ys, coeffs):
    """Batched hit counts: ``xs, ys`` ``[N]`` f32 shared users, ``coeffs``
    ``[Q, Mp, 3, 3]`` f32 per-query edge functions (padding degenerate).
    Returns ``[Q, N]`` int32: per (query, user), the number of that query's
    triangles with all three ``a x + b y + c >= 0``."""
    _count()
    inside = _edge(xs, ys, coeffs, 0) >= 0.0
    inside &= _edge(xs, ys, coeffs, 1) >= 0.0
    inside &= _edge(xs, ys, coeffs, 2) >= 0.0
    return inside.sum(dim=-1, dtype=torch.int32)


def raycast_count_ref(xs, ys, coeffs):
    """Single-query hit counts: ``coeffs`` ``[M, 3, 3]`` → ``[N]`` int32."""
    return raycast_count_batch_ref(xs, ys, coeffs[None])[0]


#: Classes of a (tile, triangle) pair: no user of the tile is inside, every
#: user is inside, or each user needs its own test.
TILE_SKIP, TILE_FULL, TILE_TEST = 0, 1, 2
_DELTA_REL = 2.0**-22  # 4 u, u = 2^-24 the float32 unit roundoff
_DELTA_ABS = 2.0**-126  # covers products that round into the subnormals
_MAG_MAX = 2.0**126  # beyond it a float32 term may overflow: always test


def raycast_tile_classes_ref(boxes, coeffs):
    """Class of every (query, tile, triangle): ``boxes`` ``[T, 4]`` f32
    ``(x_min, y_min, x_max, y_max)`` of each tile's users, ``coeffs``
    ``[Q, Mp, 3, 3]`` f32.  Returns ``[Q, T, Mp]`` int8 of
    ``TILE_SKIP`` / ``TILE_FULL`` / ``TILE_TEST``.

    Per edge, in float64 and in the kernel's order: the edge's least and
    greatest value on the box, ``e_min``, ``e_max`` (``((a x) + (b y)) + c``
    at the box's corners), and the margin
    ``delta = ((|a| X + |b| Y) + |c|) * 2^-22 + 2^-126`` with
    ``X, Y`` the box's largest ``|x|, |y|``.  SKIP: some edge has
    ``e_max < -delta``; FULL: every edge ``e_min >= delta``; an edge whose
    terms reach ``2^126`` decides neither."""
    _count()
    return _classes(boxes[None, :, None, :], coeffs[:, None])


def grid_block_classes_ref(boxes, cell_map, planes):
    """Class of every (query, user block, lane) of the grid kernel:
    ``boxes`` ``[n_blocks, 4]`` f32 of each user block's rows, ``cell_map``
    ``[n_blocks]`` the cell of each block, ``planes``
    ``[Q, n_cells, 3, 3, L]`` f32.  Returns ``[Q, n_blocks, L]`` int8 of
    ``TILE_SKIP`` / ``TILE_FULL`` / ``TILE_TEST``, each lane of the
    block's cell classified on the block's box as
    :func:`raycast_tile_classes_ref` does (the degenerate lanes past a
    cell's list length are SKIP)."""
    _count()
    per_block = planes[:, cell_map.long()].permute(0, 1, 4, 2, 3)  # [Q, NB, L, 3, 3]
    return _classes(boxes[None, :, None, :], per_block)


def _classes(boxes, coeffs):
    """Classes of the triangles ``coeffs`` ``[..., 3, 3]`` on the boxes
    ``[..., 4]`` (broadcast against the triangles' leading axes)."""
    b = boxes.to(torch.float64)[..., None, :]  # one box for the three edges
    c = coeffs.to(torch.float64)
    x_lo, y_lo, x_hi, y_hi = b.unbind(-1)
    a, bb, cc = c.unbind(-1)
    pos_a, pos_b = a >= 0, bb >= 0
    e_min = _affine(torch.where(pos_a, x_lo, x_hi), torch.where(pos_b, y_lo, y_hi), a, bb, cc)
    e_max = _affine(torch.where(pos_a, x_hi, x_lo), torch.where(pos_b, y_hi, y_lo), a, bb, cc)
    mag = _affine(torch.maximum(x_lo.abs(), x_hi.abs()), torch.maximum(y_lo.abs(), y_hi.abs()),
                  a.abs(), bb.abs(), cc.abs())
    delta = mag * _DELTA_REL + _DELTA_ABS
    ok = mag < _MAG_MAX
    skip = (ok & (e_max < -delta)).any(-1)
    full = (ok & (e_min >= delta)).all(-1)
    return torch.where(
        skip, TILE_SKIP, torch.where(full, TILE_FULL, TILE_TEST)
    ).to(torch.int8)


def rank_count_ref(xs, ys, fx, fy, thr):
    """Distance-rank counts: per user, facilities with
    ``(x - fx)^2 + (y - fy)^2 < thr``.  ``xs, ys, thr`` ``[N]``; ``fx, fy``
    ``[M]`` (a facility at +inf is never closer).  Returns ``[N]`` int32."""
    _count()
    dx = xs[:, None] - fx[None, :]
    dy = ys[:, None] - fy[None, :]
    return (dx * dx + dy * dy < thr[:, None]).sum(dim=-1, dtype=torch.int32)


def rank_count_batch_ref(xs, ys, fx, fy, thr):
    """Batched distance-rank counts: ``fx, fy`` ``[Q, M]`` per-query
    facilities, ``thr`` ``[Q, N]``.  Returns ``[Q, N]`` int32."""
    _count()
    dx = xs[None, :, None] - fx[:, None, :]
    dy = ys[None, :, None] - fy[:, None, :]
    return (dx * dx + dy * dy < thr[:, :, None]).sum(dim=-1, dtype=torch.int32)


def rank_tile_classes_ref(boxes, tmin, tmax, fx, fy):
    """Class of every (query, user sub-tile, facility) of the rank-count
    kernel: ``boxes`` ``[T, 4]`` f32 ``(x_min, y_min, x_max, y_max)`` of
    each sub-tile's users, ``tmin, tmax`` ``[Q, T]`` f32 the least and
    greatest threshold ``d^2(u, q)`` of each sub-tile's users (NaN if any
    is NaN), ``fx, fy`` ``[M]`` (or ``[Q, M]``) f32.  Returns
    ``[Q, T, M]`` int8 of ``TILE_SKIP`` / ``TILE_FULL`` / ``TILE_TEST``.

    In float32, in the kernel's order, per axis ``a = x_lo - fx`` and
    ``b = x_hi - fx``, the nearest offset ``max(a, -b, 0)`` and the
    farthest ``max(|a|, |b|)`` (maxima that ignore a NaN, as CUDA's
    ``fmaxf``); ``gmin`` and ``gmax`` the sums of their squares.  SKIP:
    ``gmin >= tmax``; FULL: ``gmax < tmin``; a NaN fails both (TEST)."""
    _count()
    x_lo, y_lo, x_hi, y_hi = (boxes[:, i, None] for i in range(4))  # [T, 1] each
    fx, fy = fx[..., None, :], fy[..., None, :]  # [(Q,) 1, M]
    zero = torch.zeros((), dtype=fx.dtype, device=fx.device)

    def near_far(lo, hi, f):
        a, b = lo - f, hi - f
        return torch.fmax(torch.fmax(a, -b), zero), torch.fmax(a.abs(), b.abs())

    nx, wx = near_far(x_lo, x_hi, fx)
    ny, wy = near_far(y_lo, y_hi, fy)
    skip = nx * nx + ny * ny >= tmax[..., None]
    full = wx * wx + wy * wy < tmin[..., None]
    return torch.where(
        skip, TILE_SKIP, torch.where(full, TILE_FULL, TILE_TEST)
    ).to(torch.int8)


def grid_cells_count_batch_ref(xs_sorted, ys_sorted, cell_map, planes):
    """Batched cell-bucketed counting (plain version of the grid kernel).

    ``xs_sorted, ys_sorted``: ``[n_blocks*block]`` cell-sorted padded user
    coordinates; ``cell_map``: ``[n_blocks]`` cell per user block;
    ``planes``: ``[Q, n_cells, 3, 3, L]`` per-query cell coefficient
    planes.  Returns partial-list hit counts ``[Q, n_blocks*block]`` int32
    in sorted order (the caller adds ``base[q, cell]``).
    """
    _count()
    nb = cell_map.shape[0]
    block = xs_sorted.shape[0] // max(nb, 1)
    x = xs_sorted.reshape(nb, block)[None, :, :, None]  # [1, NB, B, 1]
    y = ys_sorted.reshape(nb, block)[None, :, :, None]
    p = planes[:, cell_map.long()]  # [Q, NB, 3, 3, L]

    def ev(e):
        return _affine(x, y, *(p[:, :, e, j, None, :] for j in range(3)))  # [Q, NB, B, L]

    inside = (ev(0) >= 0.0) & (ev(1) >= 0.0) & (ev(2) >= 0.0)
    return inside.sum(dim=-1, dtype=torch.int32).reshape(planes.shape[0], nb * block)


def grid_raycast_ref(xs, ys, base, lists, coeffs, rect_lo, rect_size, G: int):
    """Grid-culled hit counting: ``[N]`` int32,
    ``base[cell(u)] + #{t in lists[cell(u)] : u inside t}``.

    ``base`` ``[G*G]`` int32, ``lists`` ``[G*G, L]`` (``-1`` padded),
    ``coeffs`` ``[M, 3, 3]`` (``M >= 1``); ``rect_lo``/``rect_size`` are
    Python floats, so the cell arithmetic is float32 as in the JAX oracle.
    """
    _count()
    w = rect_size[0] / G
    h = rect_size[1] / G
    cx = torch.clamp(torch.floor((xs - rect_lo[0]) / w), 0, G - 1).long()
    cy = torch.clamp(torch.floor((ys - rect_lo[1]) / h), 0, G - 1).long()
    cell = cx * G + cy
    cand = lists[cell].long()  # [N, L]
    e = coeffs[cand.clamp(min=0)]  # [N, L, 3, 3]
    x, y = xs[:, None], ys[:, None]
    inside = cand >= 0
    for i in range(3):
        inside &= _affine(x, y, e[..., i, 0], e[..., i, 1], e[..., i, 2]) >= 0.0
    return base[cell] + inside.sum(dim=-1, dtype=torch.int32)


def bvh_hit_counts_ref(xs, ys, left, right, bbox, coeffs, k_cap: int, depth: int):
    """BVH hit counts (plain version of the stack-walk kernel): ``[Q, N]``
    int32, per (query, user) ``min(#{t : every box on the path from the
    root to leaf t holds the user, and the user is inside t}, k_cap)``.

    ``xs, ys`` ``[N]`` f32 users; ``left, right`` ``[Q, Nn]`` int32 (a
    leaf has ``left = -(tri + 1)``); ``bbox`` ``[Q, Nn, 4]`` f32
    ``(xmin, ymin, xmax, ymax)``; ``coeffs`` ``[Q, Mt, 3, 3]`` f32;
    ``depth``: the deepest tree's depth, the stack each lane needs.

    The kernel's walk, written out over all ``(query, user)`` lanes at
    once: every lane keeps a stack of node ids (a row of a ``[lanes,
    depth]`` tensor) that starts at the root (with no box test); each step
    pops one node from every lane still walking, tests a leaf's triangle
    or pushes the children whose box holds the lane's user (left, then
    right, so the right one pops first), and drops the lanes whose stack
    is empty or whose count reached ``k_cap``.  The early exit keeps the
    work that of the kernel: a level-by-level frontier without it would
    visit every node whose box holds the user, on a non-pruned scene most
    of the tree for every lane.  A leaf that names a row ``>= Mt``
    counts nothing, and a child ``>= Nn`` is not pushed, as in the kernel."""
    _count()
    dev = xs.device
    q_n, n, nn, mt = left.shape[0], xs.shape[0], left.shape[1], coeffs.shape[1]
    lanes = q_n * n
    counts = torch.zeros(lanes, dtype=torch.int32, device=dev)
    stack = torch.zeros((lanes, max(int(depth), 1)), dtype=torch.int32, device=dev)
    sp = torch.ones(lanes, dtype=torch.long, device=dev)
    walking = torch.arange(lanes if k_cap > 0 else 0, device=dev)  # lane = q * N + user
    while walking.numel():
        a = walking
        sp[a] -= 1
        node = stack[a, sp[a]].long()
        q = a // n
        l = left[q, node].long()
        leaf = l < 0
        al, ql, tri = a[leaf], q[leaf], -(l[leaf] + 1)
        ok = tri < mt
        al, ql, tri = al[ok], ql[ok], tri[ok]
        e = coeffs[ql, tri]  # [P, 3, 3]
        x, y = xs[al % n], ys[al % n]
        inside = torch.ones(tri.shape, dtype=torch.bool, device=dev)
        for i in range(3):
            inside &= _affine(x, y, e[:, i, 0], e[:, i, 1], e[:, i, 2]) >= 0.0
        counts[al[inside]] += 1
        inner = ~leaf
        ai, qi = a[inner], q[inner]
        x, y = xs[ai % n], ys[ai % n]
        for kid in (l[inner], right[qi, node[inner]].long()):  # left pushed first
            b = bbox[qi, kid.clamp(0, nn - 1)]
            holds = (kid >= 0) & (kid < nn) & (x >= b[:, 0]) & (y >= b[:, 1]) & (x <= b[:, 2]) \
                & (y <= b[:, 3])
            push = ai[holds]
            stack[push, sp[push]] = kid[holds].to(torch.int32)
            sp[push] += 1
        walking = a[(sp[a] > 0) & (counts[a] < k_cap)]
    return counts.reshape(q_n, n)
