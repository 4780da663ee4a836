"""Shared helpers of the parity tests between ``repro`` (JAX, the
reference) and ``repro_torch`` (the PyTorch/CUDA port).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; results come back as numpy and are compared there.
"""

import numpy as np
import torch

CPU = torch.device("cpu")


def instance(seed, M=60, N=400):
    """``(facilities [M, 2], users [N, 2], rng)`` uniform in the unit square."""
    rng = np.random.default_rng(seed)
    return rng.random((M, 2)), rng.random((N, 2)), rng


def non_tie_mask(U, F, q_row, eps=1e-6):
    """Users with no competitor facility at a near-tie distance to the
    query ``F[q_row]``: a strict-< verdict at a 1-ulp boundary is arbitrary,
    so rank counts are compared exactly on the others only.

    The JAX tests' ``_non_tie_mask`` (``tests/test_kernels.py``) also scans
    the query's own row, which always ties with itself and so marks every
    user; here that row is left out, as the count excludes it.
    """
    U = np.asarray(U, np.float64)
    comp = np.delete(np.asarray(F, np.float64), q_row, axis=0)
    q = np.asarray(F, np.float64)[q_row]
    d2 = np.sum((U[:, None, :] - comp[None, :, :]) ** 2, axis=-1)
    d2q = np.sum((U - q) ** 2, axis=1)
    return ~np.any(np.abs(d2 - d2q[:, None]) < eps * (1.0 + d2q[:, None]), axis=1)


def edge_tie_mask(xs, ys, coeffs, rel=1e-6):
    """Users at a rounding-level tie of some triangle: one edge function
    within ``rel`` of its terms' magnitude from 0 while the other two edges
    hold, evaluated in float64.  XLA on the CPU contracts ``a*x + b*y``
    into a fused multiply-add and the port rounds every operation (its
    rounding contract), so at such a tie the two packages may count the
    triangle differently; the float64 oracle decides neither way."""
    x = np.asarray(xs, np.float64)[:, None, None]
    y = np.asarray(ys, np.float64)[:, None, None]
    c = np.asarray(coeffs, np.float64)[None]
    e = x * c[..., 0] + y * c[..., 1] + c[..., 2]  # [N, M, 3]
    tol = rel * (np.abs(x * c[..., 0]) + np.abs(y * c[..., 1]) + np.abs(c[..., 2]))
    near = np.abs(e) <= tol
    holds = e >= -tol
    return np.any(np.any(near, -1) & np.all(holds, -1), -1)


def _ulp_steps(v, steps):
    """``v`` (float32) moved ``steps`` ulps (elementwise, |steps| <= 3)."""
    v = v.copy()
    for s in range(3):
        v = np.where(steps > s, np.nextafter(v, np.float32(np.inf)), v)
        v = np.where(steps < -s, np.nextafter(v, np.float32(-np.inf)), v)
    return v.astype(np.float32)


def adversarial_users(seed, n, *, scale=1.0, offset=0.0):
    """``[N]`` float32 ``xs, ys`` for the ray-cast kernel's tile
    classifier: clusters of width ``0.05 * scale`` around ``offset``, a
    quarter of the users replaced by exact copies of others or copies moved
    1-3 ulps, and a few exact zeros when the clusters straddle 0.  Made
    with numpy from ``seed``; imports nothing of JAX."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (6, 2)) * scale + offset
    pts = (centers[rng.integers(0, 6, n)] + rng.normal(0.0, 0.05 * scale, (n, 2))).astype(np.float32)
    k = n // 4
    if k:
        src, dst = rng.integers(0, n, k), rng.integers(0, n, k)
        pts[dst] = _ulp_steps(pts[src], rng.integers(-3, 4, (k, 2)) * (rng.random((k, 1)) < 0.7))
        pts[rng.integers(0, n, max(k // 8, 1)), rng.integers(0, 2)] = np.float32(offset)
    return np.ascontiguousarray(pts[:, 0]), np.ascontiguousarray(pts[:, 1])


def adversarial_coeffs(seed, q_n, mp, ax, ay, *, coef_scale=1.0):
    """``[Q, Mp, 3, 3]`` float32 edge functions whose edges pass exactly
    through (or 1-2 ulps of ``c`` beside) the anchor points ``ax, ay``:
    give it users and tile-box corners to put users and corners on edges.
    Each triangle is one of: degenerate padding (``a = b = 0, c = -1``);
    three edges through anchors, some axis-parallel, some with
    ``a = b = c = 0``; three wide half-planes offset from the anchors'
    centre (so that whole tiles lie inside or outside).  Edge normals are
    of magnitude ``coef_scale``."""
    rng = np.random.default_rng(seed)
    ax = np.asarray(ax, np.float32)
    ay = np.asarray(ay, np.float32)
    out = np.zeros((q_n, mp, 3, 3), np.float32)
    kind = rng.choice(3, (q_n, mp), p=[0.2, 0.5, 0.3])
    shape = (q_n, mp, 3)
    a = (rng.normal(size=shape) * coef_scale).astype(np.float32)
    b = (rng.normal(size=shape) * coef_scale).astype(np.float32)
    axis = rng.random(shape)
    a = np.where(axis < 0.15, np.float32(0), a)
    b = np.where((axis >= 0.15) & (axis < 0.3), np.float32(0), b)
    pick = rng.integers(0, len(ax), shape)
    px, py = ax[pick], ay[pick]
    # c = -(fl(fl(px a) + fl(py b))): the edge is exactly 0 at the anchor
    c = -((px * a).astype(np.float32) + (py * b).astype(np.float32)).astype(np.float32)
    c = _ulp_steps(c, rng.integers(-2, 3, shape) * (rng.random(shape) < 0.4))
    null = rng.random(shape) < 0.03
    a, b, c = (np.where(null, np.float32(0), v) for v in (a, b, c))
    # wide half-planes: the line offset from the anchors' centre by up to
    # about their spread, so some tiles lie wholly on each side
    cx, cy = np.float32(np.mean(ax)), np.float32(np.mean(ay))
    spread = np.float32(max(np.ptp(ax), np.ptp(ay), 1e-30))
    wide_c = (-(cx * a + cy * b) + rng.normal(size=shape) * spread * coef_scale).astype(np.float32)
    out[..., 0] = a
    out[..., 1] = b
    out[..., 2] = np.where((kind == 2)[..., None], wide_c, c)
    out[kind == 0] = np.array([0.0, 0.0, -1.0], np.float32)
    return out


def ragged_cell_planes(seed, q_n, n_cells, lanes, ax, ay, coef_scale):
    """``[Q, n_cells, 3, 3, L]`` planes of adversarial triangles anchored on
    ``ax, ay``: each (query, cell) list cut to a random length (some 0, some
    ``L``) with degenerate lanes past it and degenerate holes inside it."""
    rng = np.random.default_rng(seed)
    tris = adversarial_coeffs(seed, q_n * n_cells, lanes, ax, ay, coef_scale=coef_scale)
    planes = tris.reshape(q_n, n_cells, lanes, 3, 3).transpose(0, 1, 3, 4, 2).copy()
    deg = np.array([0.0, 0.0, -1.0], np.float32)[None, :, None]  # [1, 3, 1] over (edge, coef, lane)
    lengths = rng.integers(0, lanes + 1, (q_n, n_cells))
    lengths[0, 0], lengths[-1, -1] = 0, lanes
    for q in range(q_n):
        for c in range(n_cells):
            n = lengths[q, c]
            planes[q, c, :, :, n:] = deg
            holes = rng.random(lanes) < 0.15
            planes[q, c, :, :, holes] = np.broadcast_to(deg[:, :, 0], (int(holes.sum()), 3, 3))
    return planes


def adversarial_rank_inputs(seed, n, m, q_n, *, scale=1.0, offset=0.0):
    """Float32 ``(users [N, 2], facilities [M, 2], q_pts [Q, 2], exclude)``
    for the rank-count kernel's facility classifier (``M >= 16``).

    Users: :func:`adversarial_users` (clusters, exact copies, copies moved
    1-3 ulps), half of them snapped to a grid of step ``scale * 2^-8`` so
    that the constructions below are exact.  Query points: snapped users;
    the first half of the queries are facility rows (their ``exclude``),
    the rest free points (``None``).  Facilities: the queries' rows; the
    mirror ``2u - q`` of a snapped user through a query point (the user's
    squared distance to it equals its threshold exactly, in float32 and
    exactly), some moved 1-3 ulps; copies of users and of query points
    (a tie for every user); points around the clusters; and a facility at
    ``(+inf, +inf)`` and one at ``(+inf, y)``.  Imports nothing of JAX."""
    rng = np.random.default_rng(seed)
    xs, ys = adversarial_users(seed, n, scale=scale, offset=offset)
    users = np.stack([xs, ys], axis=1)
    step = np.float32(scale * 2.0**-8)
    snap = rng.random(n) < 0.5
    users[snap] = (np.round(users[snap] / step) * step).astype(np.float32)
    snapped = users[snap] if snap.any() else users
    q_pts = snapped[rng.integers(0, len(snapped), q_n)].copy()
    q_pts[q_n // 2 :] += (rng.integers(-8, 9, (q_n - q_n // 2, 2)) * step).astype(np.float32)
    kinds = rng.choice(4, m, p=[0.35, 0.25, 0.15, 0.25])
    near = users[rng.integers(0, n, m)] + rng.normal(0.0, 0.05 * scale, (m, 2))
    u_pick = snapped[rng.integers(0, len(snapped), m)]
    q_pick = q_pts[rng.integers(0, q_n, m)]
    mirror = (2 * u_pick.astype(np.float64) - q_pick).astype(np.float32)
    mirror = _ulp_steps(mirror, rng.integers(-3, 4, (m, 2)) * (rng.random((m, 1)) < 0.4))
    copies = np.where(rng.random((m, 1)) < 0.5, users[rng.integers(0, n, m)], q_pick)
    fac = np.select([kinds[:, None] == 0, kinds[:, None] == 1, kinds[:, None] == 2],
                    [near, mirror, copies], rng.uniform(-1.0, 1.0, (m, 2)) * scale + offset)
    fac = fac.astype(np.float32)
    rows = rng.permutation(m)
    fac[rows[0]] = (np.inf, np.inf)
    fac[rows[1]] = (np.inf, q_pts[0, 1])
    exclude = [None] * q_n
    for i in range(q_n // 2):
        fac[rows[2 + i]] = q_pts[i]
        exclude[i] = int(rows[2 + i])
    return users, fac, q_pts, exclude


def chain_tree(depth, *, leaf_side="right", box=(0.0, 0.0, 1.0, 1.0)):
    """A tree of ``depth`` levels that is a path: each internal node has
    one leaf child (on ``leaf_side``) and the next internal node as its
    other child, every box ``box``.  ``(left, right, bbox)`` as
    ``build_bvh`` encodes them, with ``depth`` leaves, leaf ``i`` naming
    triangle ``i``.  With the leaves on the left, the walk pushes every
    leaf on its way down to the deepest node, so its stack reaches
    ``depth - 1`` entries (the kernel's second register slot from 33 on);
    with the leaves on the right, it never holds more than one."""
    n_int = depth - 1
    n_nodes = 2 * n_int + 1
    left = np.full(n_nodes, -1, np.int32)
    right = np.full(n_nodes, -1, np.int32)
    for i in range(n_int):
        nxt = i + 1 if i + 1 < n_int else n_int + n_int  # the last one: two leaves
        leaf = n_int + i
        left[i], right[i] = (leaf, nxt) if leaf_side == "left" else (nxt, leaf)
    left[n_int:] = [-(i + 1) for i in range(n_int + 1)]
    bbox = np.tile(np.asarray(box, np.float32), (n_nodes, 1))
    return left, right, bbox


def warp_walk_twin(xs_s, ys_s, nodes, tris, root, k_cap, warp=32):
    """A numpy twin of the warp walk of ``csrc/bvh_traverse.cu`` over the
    packed records (``repro_torch.kernels.bvh.pack_bvh``: ``nodes``
    ``[Q, n_inner, 12]``, ``tris`` ``[Q, rows, 12]`` f32, ``root`` ``[Q]``)
    and the users in their sorted order (``xs_s, ys_s`` ``[N]`` f32), in
    warps of ``warp`` consecutive users, the last one ragged.

    Each warp keeps a stack of (code, lane mask) entries; a step takes one
    node for the lanes of its mask that are below ``k_cap``, enters the
    right child when its mask is not empty (pushing the left one), else the
    left one, else pops; a node whose lanes all stopped is skipped.  Float32
    with one rounding per operation.  Returns ``(counts [Q, N], pops
    [2, Q, N], steps [Q, n_warps], most)``, all in the sorted order; ``most``
    is the most entries any warp's stack held."""
    nodes = np.asarray(nodes, np.float32)
    codes = nodes.view(np.int32)[..., 8:10]
    tris = np.asarray(tris, np.float32)
    xs_s, ys_s = np.asarray(xs_s, np.float32), np.asarray(ys_s, np.float32)
    q_n, n = nodes.shape[0], len(xs_s)
    n_warps = -(-n // warp)
    counts = np.zeros((q_n, n), np.int32)
    pops = np.zeros((2, q_n, n), np.int32)
    steps = np.zeros((q_n, n_warps), np.int32)
    most = 0

    def edge(x, y, a, b, c):
        return (x * np.float32(a) + y * np.float32(b)) + np.float32(c)

    def in_box(x, y, b):
        return (x >= b[0]) & (y >= b[1]) & (x <= b[2]) & (y <= b[3])

    for q in range(q_n):
        for w in range(n_warps):
            sl = slice(w * warp, min((w + 1) * warp, n))
            x, y = xs_s[sl], ys_s[sl]
            count = np.zeros(len(x), np.int32)
            inner = np.zeros(len(x), np.int32)
            leaves = np.zeros(len(x), np.int32)
            live = count < k_cap
            code, mask, stack = int(root[q]), live.copy(), []
            while live.any():
                act = mask & live
                descend = None
                if act.any():
                    steps[q, w] += 1
                    if code >= 0:
                        rec = nodes[q, code]
                        ml, mr = act & in_box(x, y, rec[0:4]), act & in_box(x, y, rec[4:8])
                        inner += act
                        lc, rc = int(codes[q, code, 0]), int(codes[q, code, 1])
                        if mr.any():
                            if ml.any():
                                stack.append((lc, ml))
                                most = max(most, len(stack))
                            descend = (rc, mr)
                        elif ml.any():
                            descend = (lc, ml)
                    else:
                        row = tris[q, ~code]
                        inside = act.copy()
                        for e in range(3):
                            inside &= edge(x, y, *row[3 * e : 3 * e + 3]) >= 0
                        count += inside
                        leaves += act
                        live = count < k_cap
                if descend is not None:
                    code, mask = descend
                    continue
                if not stack:
                    break
                code, mask = stack.pop()
            counts[q, sl], pops[0, q, sl], pops[1, q, sl] = count, inner, leaves
    return counts, pops, steps, most


# ---- LM attention yardsticks (float64, independent of the port) -------------

def attention64(q, k, v, causal=True):
    """Float64 attention of bf16/f32 tensors in the JAX GQA layout:
    ``q [B, S, K, G, D]``, ``k``/``v [B, Skv, K, D]`` -> float64 like ``q``,
    one row ``b`` at a time (the scores of a row are ``[K, G, S, Skv]``)."""
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
    for b in range(B):
        s = torch.einsum("qkgd,skd->kgqs", q[b].double(), k[b].double()) * D ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[b] = torch.einsum("kgqs,skd->qkgd", p, v[b].double())
    return out


def attention64_grads(q, k, v, do, causal=True):
    """Float64 exact attention and its backward, one row ``b`` at a time:
    ``(out, lse [B, K, G, S], dq, dk, dv)``, the gradients by autograd for
    the output's gradient ``do``: the yardstick of row 9 and of row 7's
    ``lse``."""
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    f64 = dict(dtype=torch.float64, device=q.device)
    out, dq = torch.empty(q.shape, **f64), torch.empty(q.shape, **f64)
    dk, dv = torch.empty(k.shape, **f64), torch.empty(k.shape, **f64)
    lse = torch.empty((B, K, G, S), **f64)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
    for b in range(B):
        qb, kb, vb = (t[b].double().requires_grad_(True) for t in (q, k, v))
        s = (torch.einsum("qkgd,skd->kgqs", qb, kb) * D ** -0.5).masked_fill(~mask, float("-inf"))
        lse[b] = torch.logsumexp(s.detach(), dim=-1)
        o = torch.einsum("kgqs,skd->qkgd", torch.softmax(s, dim=-1), vb)
        out[b] = o.detach()
        dq[b], dk[b], dv[b] = torch.autograd.grad(o, (qb, kb, vb), do[b].double())
    return out, lse, dq, dk, dv


#: Row 9's gradients against float64 also get 2^-18 of the tensor's largest
#: value (32 f32 ulps there): a query that sees one key has an exact zero
#: dq (dS = P (dP - delta) cancels), which f32 sums of dP and delta in
#: another order than the plain version's miss by a few ulps of dP
BWD_FLOOR = 2.0 ** -18

#: lse against float64: the kernel's error at most twice the plain
#: version's plus 2^-17 of max(|lse|, 1) (64 f32 ulps: sums of ex2 terms)
LSE_ABS = 2.0 ** -17


def lse_within_yardstick(kernel, plain, want64):
    """``(ok, err_kernel, err_plain)`` of each row's log-sum-exp."""
    err_k = (kernel.double() - want64).abs()
    err_p = (plain.double() - want64).abs()
    ok = bool((err_k <= 2 * err_p + LSE_ABS * want64.abs().clamp_min(1.0)).all())
    return ok, float(err_k.max()), float(err_p.max())


def decode_attention64(q, k_cache, v_cache, pos):
    """Float64 one-token attention: slots ``s <= pos[b]`` of each row
    (``pos >= 0``)."""
    Smax, D = k_cache.shape[1], q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.double(), k_cache.double()) * D ** -0.5
    valid = torch.arange(Smax, device=q.device)[None, :] <= pos.long()[:, None]
    p = torch.softmax(s.masked_fill(~valid[:, None, None, None, :], float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.double())


def bf16_ulp(scale):
    """One bf16 ulp at ``scale`` (8 significant bits: ``2**(e - 7)`` for
    values in ``[2**e, 2**(e + 1))``)."""
    return 2.0 ** (np.floor(np.log2(max(float(scale), 1e-30))) - 7)


def kernel_within_yardstick(kernel, plain, want64, floor=0.0):
    """``(ok, err_kernel, err_plain, worst)``, row by row: each output row
    (every index but the last, head dimension) holds the kernel's max abs
    error against the float64 yardstick to at most twice the plain
    version's error on that row plus one bf16 ulp at the row's own
    max |out| (plus ``floor`` times the tensor's largest |out|, where a
    caller states one).  ``err_kernel``/``err_plain`` are the largest errors
    over all rows; ``worst`` is the row nearest to (or furthest past) its
    limit."""
    err_k = (kernel.double() - want64).abs().amax(-1)
    err_p = (plain.double() - want64).abs().amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(want64.abs().amax(-1).clamp_min(1e-30))) - 7)
    excess = err_k - (2 * err_p + ulp + floor * float(want64.abs().max()))
    i = int(excess.argmax())
    worst = {"row": tuple(int(j) for j in np.unravel_index(i, tuple(err_k.shape))),
             "err_kernel": float(err_k.flatten()[i]), "err_plain": float(err_p.flatten()[i]),
             "bf16_ulp": float(ulp.flatten()[i])}
    return bool((excess <= 0).all()), float(err_k.max()), float(err_p.max()), worst


# ---- the MoE FFN's routed experts (row 12) -------------------------------------

def moe_offsets(counts, device=CPU):
    """``offsets [E*n + 1]`` int32 of compact runs of ``counts [n, E]`` rows,
    laid out in (expert, group) order."""
    c = np.asarray(counts, np.int64).T.reshape(-1)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(c)]).astype(np.int32)).to(device)


def moe_inputs(seed, counts, d, f, glu=True, tail=3, dtype=torch.float32, device=CPU):
    """Compact rows ``xc [sum(counts) + tail, d]``, their ``offsets`` and
    an expert's ``w_in``/``w_gate [E, d, f]``, ``w_out [E, f, d]`` (N(0, 1)
    rows, fan-in scaled weights), made with numpy from ``seed``; the
    ``tail`` rows past the last run hold NaN, which no output row may show
    (the kernels may load them with a tile, and never store them)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    E = counts.shape[1]
    R = int(counts.sum())

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    xc = np.concatenate([rng.standard_normal((R, d)), np.full((tail, d), np.nan)])
    w_in = rng.standard_normal((E, d, f)) * d ** -0.5
    w_gate = rng.standard_normal((E, d, f)) * d ** -0.5 if glu else None
    w_out = rng.standard_normal((E, f, d)) * f ** -0.5
    return (t(xc), moe_offsets(counts, device), t(w_in),
            None if w_gate is None else t(w_gate), t(w_out))


def _act64(act, h, g):
    if act in ("swiglu", "geglu"):
        if act == "swiglu":
            return h * g / (1.0 + torch.exp(-g))
        return h * 0.5 * g * (1.0 + torch.tanh((2.0 / np.pi) ** 0.5 * (g + 0.044715 * g ** 3)))
    if act == "gelu":
        return 0.5 * h * (1.0 + torch.tanh((2.0 / np.pi) ** 0.5 * (h + 0.044715 * h ** 3)))
    return torch.clamp_min(h, 0.0) ** 2  # relu2


def moe_mlp64(xc, offsets, w_in, w_gate, w_out, act):
    """Float64 expert MLP over each compact run (no rounding anywhere):
    row 12's yardstick, ``[R, d]`` float64, zero past the last run."""
    off = offsets.tolist()
    n = (len(off) - 1) // w_in.shape[0]
    out = torch.zeros((xc.shape[0], w_out.shape[2]), dtype=torch.float64, device=xc.device)
    for q in range(len(off) - 1):
        a, b = off[q], off[q + 1]
        if a == b:
            continue
        e = q // n
        x = xc[a:b].double()
        h = x @ w_in[e].double()
        g = None if w_gate is None else x @ w_gate[e].double()
        out[a:b] = _act64(act, h, g) @ w_out[e].double()
    return out


def moe_tie_mask(logits, k, rel=2.0 ** -7):
    """Tokens (rows of ``logits [..., E]``, float64 router logits from the
    bf16 inputs) whose ``k``-th and ``(k+1)``-th largest logits lie within
    one bf16 ulp (``rel`` of their magnitude): the two packages round the
    router's product to bf16 apart, so such a token may take another
    expert in each; the float64 logits decide neither way."""
    s = np.sort(np.asarray(logits, np.float64), axis=-1)[..., ::-1]
    kth, nxt = s[..., k - 1], s[..., k]
    return (kth - nxt) <= rel * np.maximum(np.abs(kth), np.abs(nxt))


# ---- the hybrid family: sliding-window attention (row 13), RG-LRU (row 14) ----

def local_attention64(q, k, v, window):
    """Float64 sliding-window attention (key ``j`` seen by query ``i`` iff
    ``i - window < j <= i``) of ``q [B, S, K, G, D]`` over ``k``/``v [B, S,
    K, D]``, one row ``b`` at a time: row 13's yardstick."""
    B, S, K, G, D = q.shape
    i = torch.arange(S, device=q.device)
    delta = i[:, None] - i[None, :]
    mask = (delta >= 0) & (delta < window)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        s = torch.einsum("qkgd,skd->kgqs", q[b].double(), k[b].double()) * D ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[b] = torch.einsum("kgqs,skd->qkgd", p, v[b].double())
    return out


def rglru_scan64(r, i, h, lam, init_state=None):
    """Float64 RG-LRU recurrence walked in order from the same inputs
    (``a_t = σ(Λ)^(8 r_t)``, ``y_t = a_t y_{t-1} + sqrt(max(1 - a_t², 1e-12))
    i_t h_t``): ``(y [B, S, w], y[:, -1])``, row 14's yardstick."""
    log_a0 = torch.nn.functional.logsigmoid(lam.double())
    at = torch.exp(8.0 * r.double() * log_a0)
    x = torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12)) * i.double() * h.double()
    y = torch.empty_like(x)
    acc = (torch.zeros_like(x[:, 0]) if init_state is None else init_state.double())
    for t in range(x.shape[1]):
        acc = at[:, t] * acc + x[:, t]
        y[:, t] = acc
    return y, acc
