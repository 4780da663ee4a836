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
plain version of the BVH walk (``csrc/bvh_traverse.cu``): the reference
walk, one stack per lane, written out over all lanes at once, whose pops
the kernel's warp walk repeats lane for lane.

:func:`flash_attention_ref` and :func:`decode_attention_ref` are the plain
versions of the LM attention kernels (``csrc/attention.cu``): the JAX
package's own math (``repro.models.attention``), float32 scores from the
inputs, scaled by ``D ** -0.5``, masked at ``-1e30``; the flash version
is its running ``(max, sum, acc)`` over ``_pick_block`` blocks, every key
block scanned masked, and ``acc / max(sum, 1e-30)``; the decode version
a softmax over the whole cache.  Both cast the output to ``q``'s dtype.
:func:`flash_attention_fwd_ref` is the flash version that also returns
the log-sum-exp ``lse [B, K, G, S]`` (``_flash_fwd_loop``), and
:func:`flash_attention_bwd_ref` the fused backward (``_flash_fused_bwd``,
block for block): the plain versions of row 7 with its ``lse`` and of
row 9 (``csrc/attention_bwd.cu``).

:func:`adamw_ref` and :func:`adamw8bit_ref` are the plain versions of the
fused AdamW kernels (``csrc/adamw.cu``, rows 10 and 11): the bodies of
``repro.optim.adamw.adamw_update`` and ``repro.optim.adamw8bit``'s
``adamw8bit_update`` over a list of leaves, in place, with the global-norm
clip's scale applied to each gradient.  Each torch op rounds once, and the
kernels repeat them in order.  :func:`quantize_blockwise` and
:func:`dequantize_blockwise` are the 8-bit moments' format (blocks of
:data:`QUANT_BLOCK`); their divisions by 127 and 255 divide by a 0-d
tensor on the input's device, which is a true division on the CPU and on
the card alike (a Python number there would multiply by its reciprocal on
the card).

:func:`moe_expert_mlp_ref` is the plain version of row 12
(``csrc/moe.cu``), the routed experts' MLP of ``repro.models.ffn``
``moe_ffn`` (its ``_expert_mlp``) over compact rows: a loop over (group,
expert) with ``torch.matmul`` on each expert's rows, rounding where the
kernel rounds (each product to the input's dtype, the activation on that
value, the GLU product).  It reads the row offsets back to the host.

:func:`local_attention_ref` is the plain version of row 13 (the
sliding-window prefill of ``csrc/attention.cu`` ``flash_fwd`` with a
window): ``repro.models.attention`` ``local_attention``'s algorithm, query
block ``i`` of ``w = min(window, S)`` positions against key blocks ``i -
1`` and ``i`` (zeros before the first), the end padded with zeros, the
mask ``0 <= qpos - kpos < w``, softmax in float32, one block at a time.
:func:`rglru_scan_ref` is the plain version of row 14 (``csrc/rglru.cu``):
``repro.models.rglru`` ``_rglru_scan`` after its gates, the linear
recurrence written as ``lax.associative_scan``'s own recursion (odd and
even pairs, log depth) in torch ops, so that it rounds as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    "flash_attention_ref",
    "flash_attention_fwd_ref",
    "flash_attention_bwd_ref",
    "decode_attention_ref",
    "adamw_ref",
    "adamw8bit_ref",
    "moe_expert_mlp_ref",
    "local_attention_ref",
    "rglru_scan_ref",
    "RGLRU_C",
    "quantize_blockwise",
    "dequantize_blockwise",
    "QUANT_BLOCK",
    "SCALE_FLOOR",
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


def bvh_hit_counts_ref(xs, ys, left, right, bbox, coeffs, k_cap: int, depth: int,
                       pops: bool = False):
    """BVH hit counts (plain version of the walk kernel): ``[Q, N]``
    int32, per (query, user) ``min(#{t : every box on the path from the
    root to leaf t holds the user, and the user is inside t}, k_cap)``;
    with ``pops``, ``(counts, pops)``, ``pops`` ``[2, Q, N]`` int32 the
    internal nodes (row 0) and the leaves (row 1) each lane popped.

    ``xs, ys`` ``[N]`` f32 users; ``left, right`` ``[Q, Nn]`` int32 (a
    leaf has ``left = -(tri + 1)``); ``bbox`` ``[Q, Nn, 4]`` f32
    ``(xmin, ymin, xmax, ymax)``; ``coeffs`` ``[Q, Mt, 3, 3]`` f32;
    ``depth``: the deepest tree's depth, the stack each lane needs.

    The reference walk, one stack per lane, written out over all
    ``(query, user)`` lanes at once: every lane keeps a stack of node ids
    (a row of a ``[lanes, depth]`` tensor) that starts at the root (with
    no box test); each step pops one node from every lane still walking,
    tests a leaf's triangle or pushes the children whose box holds the
    lane's user (left, then right, so the right one pops first), and drops
    the lanes whose stack is empty or whose count reached ``k_cap``.  The
    kernel walks once per warp for a span of users, but each lane takes
    part in exactly these pops.  The early exit keeps the work that of the
    kernel: a level-by-level frontier without it would visit every node
    whose box holds the user, on a non-pruned scene most of the tree for
    every lane.  A leaf that names a row ``>= Mt`` counts nothing, and a
    child ``>= Nn`` is not pushed, as in the kernel."""
    _count()
    dev = xs.device
    q_n, n, nn, mt = left.shape[0], xs.shape[0], left.shape[1], coeffs.shape[1]
    lanes = q_n * n
    counts = torch.zeros(lanes, dtype=torch.int32, device=dev)
    popped = torch.zeros((2, lanes if pops else 0), dtype=torch.int32, device=dev)
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
        if pops:
            popped[1, a[leaf]] += 1
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
        if pops:
            popped[0, ai] += 1
        x, y = xs[ai % n], ys[ai % n]
        for kid in (l[inner], right[qi, node[inner]].long()):  # left pushed first
            b = bbox[qi, kid.clamp(0, nn - 1)]
            holds = (kid >= 0) & (kid < nn) & (x >= b[:, 0]) & (y >= b[:, 1]) & (x <= b[:, 2]) \
                & (y <= b[:, 3])
            push = ai[holds]
            stack[push, sp[push]] = kid[holds].to(torch.int32)
            sp[push] += 1
        walking = a[(sp[a] > 0) & (counts[a] < k_cap)]
    counts = counts.reshape(q_n, n)
    return (counts, popped.reshape(2, q_n, n)) if pops else counts


# ---- LM attention ------------------------------------------------------------

_NEG = -1e30  # the JAX package's mask value


def _pick_block(S: int, pref: int) -> int:
    """Largest divisor of ``S`` that is ``<= pref`` (the JAX package's)."""
    b = min(pref, S)
    while S % b:
        b -= 1
    return max(b, 1)


def _flash_fwd(q, k, v, causal: bool, q_block: int, kv_block: int):
    """``(out [B, S, K, G, D] in q's dtype, lse [B, K, G, S] f32)``."""
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    bq, bk = _pick_block(S, q_block), _pick_block(Skv, kv_block)
    scale = D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, bq):
        q_blk = q[:, q0:q0 + bq].float()
        m = torch.full((B, K, G, bq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, K, G, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, bq, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, bk):
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k[:, k0:k0 + bk].float()) * scale
            if causal:
                qpos = torch.arange(q0, q0 + bq, device=q.device)
                kpos = torch.arange(k0, k0 + bk, device=q.device)
                s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v[:, k0:k0 + bk].float())
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
        lse[..., q0:q0 + bq] = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def flash_attention_ref(q, k, v, causal: bool = True, q_block: int = 512,
                        kv_block: int = 1024):
    """Blockwise attention: ``q [B, S, K, G, D]``, ``k``/``v [B, Skv, K, D]``
    -> ``[B, S, K, G, D]`` in ``q``'s dtype (``repro.models.attention``
    ``flash_attention`` without ``causal_skip``)."""
    _count()
    return _flash_fwd(q, k, v, causal, q_block, kv_block)[0]


def flash_attention_fwd_ref(q, k, v, causal: bool = True, q_block: int = 512,
                            kv_block: int = 1024):
    """:func:`flash_attention_ref` and its log-sum-exp: ``(out, lse)``,
    ``lse [B, K, G, S]`` float32, ``m + log(max(l, 1e-30))`` in natural
    units (``repro.models.attention`` ``_flash_fwd_loop``, its output cast
    to ``q``'s dtype as ``flash_attention_fused`` returns it)."""
    _count()
    return _flash_fwd(q, k, v, causal, q_block, kv_block)


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = True, q_block: int = 512,
                            kv_block: int = 1024):
    """The fused backward (``repro.models.attention`` ``_flash_fused_bwd``,
    block for block): ``delta = rowsum(dO * O)`` from ``out`` as given (the
    forward's output in its dtype), ``p = exp(s - lse)`` under the causal
    mask, ``ds = p * (dp - delta)``, every sum in float32, and ``(dq, dk,
    dv)`` returned in the inputs' dtypes."""
    _count()
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    bq, bk = _pick_block(S, q_block), _pick_block(Skv, kv_block)
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dof, out.float())  # [B, K, G, S]
    dq = torch.empty((B, S, K, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, K, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Skv, K, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, bq):
        q_blk, do_blk = qf[:, q0:q0 + bq], dof[:, q0:q0 + bq]
        lse_blk, delta_blk = lse[..., q0:q0 + bq], delta[..., q0:q0 + bq]
        dq_blk = torch.zeros((B, bq, K, G, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Skv, bk):
            k_blk, v_blk = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) * scale
            if causal:
                qpos = torch.arange(q0, q0 + bq, device=q.device)
                kpos = torch.arange(k0, k0 + bk, device=q.device)
                s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None], s, _NEG)
            p = torch.exp(s - lse_blk[..., None])  # [B, K, G, bq, bk]
            dv[:, k0:k0 + bk] += torch.einsum("bkgqs,bqkgd->bskd", p, do_blk)
            dp = torch.einsum("bqkgd,bskd->bkgqs", do_blk, v_blk)
            ds = p * (dp - delta_blk[..., None])
            dq_blk += torch.einsum("bkgqs,bskd->bqkgd", ds, k_blk) * scale
            dk[:, k0:k0 + bk] += torch.einsum("bkgqs,bqkgd->bskd", ds, q_blk) * scale
        dq[:, q0:q0 + bq] = dq_blk
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos):
    """One query token per row against the cache: ``q [B, 1, K, G, D]``,
    caches ``[B, Smax, K, D]``, ``pos [B]`` (slots ``s <= pos`` are valid;
    the caller has written the new token at ``pos``) -> ``[B, 1, K, G, D]``
    (``repro.models.attention`` ``decode_attention``)."""
    _count()
    Smax = k_cache.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k_cache.float()) * scale
    valid = torch.arange(Smax, device=q.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.to(q.dtype)


# ---- AdamW (rows 10 and 11) ---------------------------------------------------

#: Elements of a block of the 8-bit moments, each with one float32 scale.
QUANT_BLOCK = 128
#: The least scale a block divides by (``max(scale, 1e-30)``).
SCALE_FLOOR = 1e-30


def _law(p, g, m, v, lr, bc1, bc2, b1: float, b2: float, eps: float, weight_decay: float):
    """``repro.optim.adamw``'s law on one leaf: ``m`` and ``v`` in place,
    the new parameters returned (float32)."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    pf = p.float()
    return pf - lr * (upd + weight_decay * pf)


def adamw_ref(ps, gs, ms, vs, lr, bc1, bc2, scale, *, b1: float, b2: float, eps: float,
              weight_decay: float) -> None:
    """Row 10's plain version: each leaf ``p`` and its float32 moments
    ``m``, ``v`` updated in place from its gradient ``g`` times the clip's
    ``scale``; ``lr``, ``bc1``, ``bc2`` and ``scale`` 0-d float32 tensors."""
    _count()
    for p, g, m, v in zip(ps, gs, ms, vs):
        p.copy_(_law(p, g.float() * scale, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay))


def _div(x, c: float):
    """``x / c`` as a true division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_blockwise(x, signed: bool = True):
    """``x`` (any shape, float32) -> ``(q int8 [nblocks, 128], scale float32
    [nblocks])``, the last block padded with zeros: signed with ``scale =
    absmax / 127``, or unsigned (``x >= 0``) with ``scale = max / 255``,
    stored as ``q - 128``."""
    flat = x.reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % QUANT_BLOCK))
    blocks = blocks.reshape(-1, QUANT_BLOCK)
    if signed:
        scale = _div(torch.amax(torch.abs(blocks), dim=1), 127.0)
        q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=SCALE_FLOOR)[:, None]),
                        -127, 127)
    else:
        scale = _div(torch.amax(blocks, dim=1), 255.0)
        q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=SCALE_FLOOR)[:, None]),
                        0, 255) - 128
    return q.to(torch.int8), scale


def dequantize_blockwise(q, scale, shape, signed: bool = True):
    """The float32 tensor of ``shape`` that :func:`quantize_blockwise` gave
    ``(q, scale)`` for."""
    blocks = q.float()
    if not signed:
        blocks = blocks + 128.0
    n = 1
    for d in shape:
        n *= d
    return (blocks * scale[:, None]).reshape(-1)[:n].reshape(shape)


def adamw8bit_ref(ps, gs, states, lr, bc1, bc2, scale, *, b1: float, b2: float, eps: float,
                  weight_decay: float) -> None:
    """Row 11's plain version: each leaf ``p`` and its 8-bit moments
    (``{"mq", "ms", "vq", "vs"}``) updated in place: dequantize, the law of
    :func:`adamw_ref`, requantize."""
    _count()
    for p, g, s8 in zip(ps, gs, states):
        m = dequantize_blockwise(s8["mq"], s8["ms"], p.shape, signed=True)
        v = dequantize_blockwise(s8["vq"], s8["vs"], p.shape, signed=False)
        p.copy_(_law(p, g.float() * scale, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay))
        for key, t, signed in (("m", m, True), ("v", v, False)):
            q, sc = quantize_blockwise(t, signed=signed)
            s8[f"{key}q"].copy_(q)
            s8[f"{key}s"].copy_(sc)


# ---- the MoE FFN's routed experts (row 12) -------------------------------------

def _moe_act(act: str, h, g):
    """JAX's ``_expert_mlp`` activation: ``h * silu(g)`` (``swiglu``),
    ``h * gelu(g)`` (``geglu``, tanh form), or ``activation(act, h)``."""
    if act == "swiglu":
        return h * F.silu(g)
    if act == "geglu":
        return h * F.gelu(g, approximate="tanh")
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(f"unknown ffn_act {act!r}")


def moe_expert_mlp_ref(xc, offsets, rows_bound: int, w_in, w_gate, w_out, act: str):
    """Row 12's plain version: ``xc [R, d]`` holds each (expert, group)'s
    rows at ``offsets[e*n + g] : offsets[e*n + g + 1]`` (``offsets [E*n +
    1]`` int32, at most ``rows_bound`` rows a pair); each run goes through
    expert ``e``'s MLP (``w_in``/``w_gate [E, d, f]``, ``w_out [E, f, d]``;
    ``w_gate`` None for ``gelu``/``relu2``).  Returns ``[R, d]`` in
    ``xc``'s dtype, zero past the last run."""
    _count()
    E = w_in.shape[0]
    off = offsets.tolist()
    n = (len(off) - 1) // E
    y = torch.zeros((xc.shape[0], w_out.shape[2]), dtype=xc.dtype, device=xc.device)
    for q in range(len(off) - 1):
        a, b = off[q], off[q + 1]
        if a == b:
            continue
        e, g = divmod(q, n)
        if b - a > rows_bound:
            raise ValueError(f"(group, expert) {(g, e)} holds {b - a} rows, "
                             f"more than the bound {rows_bound}")
        xe = xc[a:b]
        h = xe @ w_in[e]
        h = _moe_act(act, h, None if w_gate is None else xe @ w_gate[e])
        y[a:b] = h @ w_out[e]
    return y


# ---- the hybrid family: sliding-window attention (row 13), RG-LRU (row 14) ----

def local_attention_ref(q, k, v, window: int):
    """Row 13's plain version: causal attention of ``q [B, S, K, G, D]``
    over ``k``/``v [B, S, K, D]`` where query ``i`` sees keys ``i - w < j
    <= i``, ``w = min(window, S)`` (``repro.models.attention``
    ``local_attention``) -> ``[B, S, K, G, D]`` in ``q``'s dtype.  One
    query block at a time: its ``[B, K, G, w, 2w]`` float32 scores are what
    JAX's einsum gives for that block."""
    _count()
    B, S, K, G, D = q.shape
    w = min(window, S)
    pad = (-S) % w
    if pad:  # end padding: the padded keys sit at future positions, masked out
        q, k, v = (F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad]) for t in (q, k, v))
    n = q.shape[1] // w
    scale = D ** -0.5
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None]
    delta = qpos - (torch.arange(2 * w, device=dev)[None, :] - w)
    mask = (delta >= 0) & (delta < w)  # [w, 2w]
    first = mask & (torch.arange(2 * w, device=dev) >= w)[None, :]
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    zeros = torch.zeros((B, w, K, D), dtype=k.dtype, device=dev)
    for i in range(n):
        blk = slice(i * w, (i + 1) * w)
        prev = slice((i - 1) * w, i * w)
        k2 = torch.cat([zeros if i == 0 else k[:, prev], k[:, blk]], dim=1)  # [B, 2w, K, D]
        v2 = torch.cat([zeros if i == 0 else v[:, prev], v[:, blk]], dim=1)
        s = torch.einsum("bqkgd,bskd->bkgqs", q[:, blk].float(), k2.float()) * scale
        s = torch.where((first if i == 0 else mask)[None, None, None], s, _NEG)
        p = torch.softmax(s, dim=-1)
        out[:, blk] = torch.einsum("bkgqs,bskd->bqkgd", p, v2.float()).to(q.dtype)
    return out[:, :S]


#: The RG-LRU's decay exponent ``c`` (``repro.models.rglru._C``).
RGLRU_C = 8.0


def _assoc_scan(a, b):
    """``lax.associative_scan`` over axis 1 of ``(a, b)`` with JAX's
    recursion for ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``:
    the scanned ``(a, b)``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_lo, b_lo, a_hi, b_hi = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _assoc_scan(a_lo * a_hi, a_hi * b_lo + b_hi)
    a_ev, b_ev = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        odd_a_, odd_b_ = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_, odd_b_ = odd_a, odd_b
    even_a = torch.cat([a[:, :1], odd_a_ * a_ev], dim=1)
    even_b = torch.cat([b[:, :1], a_ev * odd_b_ + b_ev], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_b[:, 0::2] = even_a, even_b
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    return out_a, out_b


def rglru_scan_ref(r, i, h, lam, init_state=None):
    """Row 14's plain version: ``r``, ``i`` float32 ``[B, S, w]`` (the
    gates), ``h [B, S, w]`` (the conv output, any float dtype, read in
    ``r``'s), ``lam [w]`` (Λ, float32), ``init_state`` None or float32 ``[B,
    w]`` -> ``(y [B, S, w] float32, y[:, -1])`` (every float32 here may be
    float64 throughout): ``log a_t = c r_t log σ(Λ)``, ``β_t = sqrt(max(1 -
    a_t², 1e-12))``, ``x_t = β_t i_t h_t`` (``+ a_0 init_state`` at t = 0),
    ``y_t = a_t y_{t-1} + x_t`` by :func:`_assoc_scan`."""
    _count()
    log_a0 = F.logsigmoid(lam)[None, None, :]
    at = torch.exp(RGLRU_C * r * log_a0)
    beta = torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12))
    xin = beta * i * h.to(r.dtype)
    if init_state is not None:
        xin = xin.clone()
        xin[:, 0] = xin[:, 0] + at[:, 0] * init_state
    _, y = _assoc_scan(at, xin)
    return y, y[:, -1]
