"""Launch the BVH walk kernel (``csrc/bvh_traverse.cu``).

Replaces the JAX package's traversal (``repro/core/bvh.py``
``bvh_hit_counts`` and ``bvh_hit_counts_batch``, a ``lax.while_loop``
under ``vmap``, not a Pallas site).  The kernel gives each warp a span of
``32 * USERS_PER_LANE`` consecutive users of the spatial order of
:mod:`repro_torch.kernels.user_order` and one query, walks the query's
tree once for the whole span (a stack of (node, user masks) entries in
the warp's registers), lets each user stop at ``k_cap`` hits, and stores
each count through the order's permutation into the callers' order.  Any
order of the users gives the same counts, and each user's pops are those
of its own stack walk (the plain version,
:func:`repro_torch.kernels.ref.bvh_hit_counts_ref`).

The trees reach the kernel (and its plain version) as a :class:`BvhBatch`
made by :func:`bvh_batch`, which checks their shapes and takes the stack
the walk needs from the node arrays themselves; for the card it packs them
into the records the kernel reads (:func:`pack_bvh`) and uploads those
alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.user_order import UserOrder, build_user_order, check_order

__all__ = [
    "MAX_STACK",
    "RECORD_FLOATS",
    "BvhBatch",
    "WalkStats",
    "bvh_batch",
    "pack_bvh",
    "stack_depth",
    "bvh_count_batch_kernel_call",
    "bvh_count_kernel_call",
    "walk_stats",
    "batch_launches",
    "launches",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else): the single-query wrapper and the batched wrapper.
launches = 0
batch_launches = 0

#: Entries of each warp's stack (``kMaxStack`` of ``csrc/bvh_traverse.cu``,
#: two register slots a lane, which the library also reports): a tree
#: deeper than this is refused.  Ample for median-split trees, whose depth
#: is ``ceil(log2 M) + 1``.
MAX_STACK = 64
#: Floats of one packed record (48 bytes: three ``float4`` loads).
RECORD_FLOATS = 12
_MAX_QUERIES = 65_535  # gridDim.y
#: Users each lane of a warp walks for (``kUsers`` of the kernel, which the
#: library also reports): a warp walks for 32 times as many consecutive
#: sorted users.  4 was faster than 1, 2 and 8 at both CAL batches on the
#: H100 (PERF.md, Findings).
USERS_PER_LANE = 4
_EMPTY_BOX = (float("inf"), float("inf"), float("-inf"), float("-inf"))  # holds no user
_NEVER_INSIDE = (0.0, 0.0, -1.0)  # an edge that is < 0 for every user


class BvhBatch(NamedTuple):
    """A batch of trees as the kernel and its plain version read it, made
    by :func:`bvh_batch` only: its ``depth`` is the deepest tree's, taken
    there from the node arrays, so no caller hands the walk a wrong one.
    The plain version reads the node arrays, which stay on the host (it
    moves them to the users' device), the kernel the packed records
    (:func:`pack_bvh`) on the card, ``None`` in a batch made for the
    CPU."""

    left: torch.Tensor  # [Q, Nn] int32, host
    right: torch.Tensor  # [Q, Nn] int32, host
    bbox: torch.Tensor  # [Q, Nn, 4] f32, host, 16-byte aligned
    coeffs: torch.Tensor  # [Q, Mt, 3, 3] f32, host
    depth: int
    nodes: torch.Tensor | None  # [Q, n_inner, 12] f32: child boxes, child codes
    tris: torch.Tensor | None  # [Q, Mt + 1, 12] f32: coefficient rows, a never-inside row last
    root: torch.Tensor | None  # [Q] int32: the root's code


class WalkStats(NamedTuple):
    """The counting instance's outputs (:func:`walk_stats`)."""

    counts: torch.Tensor  # [Q, N] int32, the users' order
    pops: torch.Tensor  # [2, Q, N] int32: internal nodes (row 0) and leaves (row 1) per lane
    steps: torch.Tensor  # [Q, n_spans] int32: the nodes the warp of each span of users took


def stack_depth(left, right) -> int:
    """Depth of the deepest tree of ``left, right`` (``[Nn]`` or ``[Q, Nn]``
    int arrays, numpy or host tensors; root node 0 at depth 1): the stack
    entries a walk needs (it pops one node and pushes at most two, so each
    internal node on a path adds one entry; a child outside ``[0, Nn)`` is
    never pushed).

    One vectorised step per level over the whole batch (``depth`` numpy
    passes, not a Python walk of every tree).  Raises ``ValueError`` on a
    cycle (a level past ``Nn``)."""
    left = np.atleast_2d(np.asarray(left))
    right = np.atleast_2d(np.asarray(right))
    q_n, nn = left.shape
    if q_n == 0 or nn == 0:
        return 0
    rows = np.arange(q_n)
    nodes = np.zeros(q_n, np.int64)
    depth = 0
    while len(rows):
        depth += 1
        if depth > nn:
            raise ValueError("the node arrays hold a cycle: no tree is deeper than its node count")
        kids_l, kids_r = left[rows, nodes], right[rows, nodes]
        has_l, has_r = (kids_l >= 0) & (kids_l < nn), (kids_r >= 0) & (kids_r < nn)
        rows = np.concatenate([rows[has_l], rows[has_r]])
        nodes = np.concatenate([kids_l[has_l], kids_r[has_r]]).astype(np.int64)
    return depth


def pack_bvh(left, right, bbox, coeffs):
    """The records the kernel reads, from a stacked batch of trees (host
    numpy arrays: ``left, right`` ``[Q, Nn]`` int, ``bbox`` ``[Q, Nn, 4]``
    and ``coeffs`` ``[Q, Mt, 3, 3]`` f32): ``(nodes, tris, root)``.

    * ``nodes`` ``[Q, n_inner, 12]`` f32: internal node ``j`` of each tree
      (the ``j``-th node with ``left >= 0``, in node order, so the root, if
      internal, is record 0) holds its left child's box (floats 0-3), its
      right child's box (4-7) and the children's codes (int32 bits in 8 and
      9): a child's internal index, or ``~row`` for a leaf, ``row`` its
      triangle.  ``n_inner`` is the most internal nodes of a tree, at
      least 1.
    * ``tris`` ``[Q, Mt + 1, 12]`` f32: each coefficient row ``(a0, b0, c0,
      a1, b1, c1, a2, b2, c2)`` padded to 12; row ``Mt`` is never inside.
    * ``root`` ``[Q]`` int32: the root's code.

    Where the plain walk skips (a leaf whose row is ``>= Mt`` counts
    nothing; a child outside ``[0, Nn)`` is not pushed), the records hold
    what gives the same walk with no test: such a leaf's code names row
    ``Mt``, such a child has an empty box (min ``+inf``, max ``-inf``).
    Host numpy, called by :func:`bvh_batch`: a single query's tree is
    packed on its verify path, where a queue of small launches on the card
    would cost more than the walk."""
    left, right = np.asarray(left, np.int64), np.asarray(right, np.int64)
    bbox, coeffs = np.asarray(bbox, np.float32), np.asarray(coeffs, np.float32)
    q_n, nn = left.shape
    mt = coeffs.shape[1]
    rows = np.arange(q_n)[:, None]
    internal = left >= 0
    index = np.cumsum(internal, axis=1) - 1  # a node's internal index, where internal

    def code_of(child):  # node ids (valid ones) -> codes
        own = left[rows, child]
        return np.where(own >= 0, index[rows, child], ~np.minimum(-own - 1, mt))

    qi, ni = np.nonzero(internal)
    slot = index[qi, ni]
    nodes = np.zeros((q_n, max(int(internal.sum(axis=1).max(initial=0)), 1), RECORD_FLOATS),
                     np.float32)
    for side, child in enumerate((left, right)):
        ok = (child >= 0) & (child < nn)
        safe = np.where(ok, child, 0)
        box = np.where(ok[..., None], bbox[rows, safe], np.asarray(_EMPTY_BOX, np.float32))
        nodes[qi, slot, 4 * side : 4 * side + 4] = box[qi, ni]
        nodes.view(np.int32)[qi, slot, 8 + side] = code_of(safe)[qi, ni]
    tris = np.zeros((q_n, mt + 1, RECORD_FLOATS), np.float32)
    tris[:, :mt, :9] = coeffs.reshape(q_n, mt, 9)
    tris[:, mt, :9] = _NEVER_INSIDE * 3
    root = code_of(np.zeros((q_n, 1), np.int64))[:, 0].astype(np.int32)
    return nodes, tris, root


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it that starts on a 16-byte boundary."""
    return t.clone() if t.data_ptr() % 16 else t


def bvh_batch(left, right, bbox, coeffs, device, *, max_stack: int = MAX_STACK) -> BvhBatch:
    """Check a stacked batch of trees (:func:`repro_torch.core.bvh.stack_bvhs`:
    ``left, right`` ``[Q, Nn]``, ``bbox`` ``[Q, Nn, 4]``, ``coeffs``
    ``[Q, Mt, 3, 3]``; numpy arrays or tensors) and take its depth, on a
    host copy (int32 ids, float32 boxes and coefficients, contiguous, the
    tables 16-byte aligned).  When ``device`` is not the CPU, pack it there
    for the kernel (:func:`pack_bvh`) and put the records on ``device``.  A
    tree deeper than ``max_stack`` (at most :data:`MAX_STACK`) raises
    ``ValueError`` here, where the JAX walk drops the push."""
    left, right, bbox, coeffs = (torch.as_tensor(v) for v in (left, right, bbox, coeffs))
    if left.ndim != 2 or right.shape != left.shape or left.shape[1] == 0:
        raise ValueError(
            f"left, right must both be [Q, Nn] with Nn >= 1, got {tuple(left.shape)}, "
            f"{tuple(right.shape)}")
    q_n, nn = left.shape
    if bbox.shape != (q_n, nn, 4):
        raise ValueError(f"bbox must be [{q_n}, {nn}, 4], got {tuple(bbox.shape)}")
    if coeffs.ndim != 4 or coeffs.shape[0] != q_n or coeffs.shape[2:] != (3, 3):
        raise ValueError(f"coeffs must be [{q_n}, Mt, 3, 3], got {tuple(coeffs.shape)}")
    left, right = (v.to("cpu", torch.int32).contiguous() for v in (left, right))
    bbox, coeffs = (_aligned(v.to("cpu", torch.float32).contiguous()) for v in (bbox, coeffs))
    depth = stack_depth(left, right)
    stack = min(int(max_stack), MAX_STACK)
    if depth > stack:
        raise ValueError(f"a tree of depth {depth} needs a stack of {depth} entries; the walk "
                         f"has {stack} (max_stack={max_stack}, the kernel's {MAX_STACK})")
    if torch.device(device).type == "cpu":
        return BvhBatch(left, right, bbox, coeffs, depth, None, None, None)
    packed = pack_bvh(*(v.numpy() for v in (left, right, bbox, coeffs)))
    return BvhBatch(left, right, bbox, coeffs, depth,
                    *(_aligned(torch.from_numpy(v).to(device)) for v in packed))


def _lib() -> ctypes.CDLL:
    lib = build.load("bvh_traverse")
    fn = lib.bvh_traverse
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.bvh_traverse_error_string.argtypes = [ctypes.c_int]
    lib.bvh_traverse_error_string.restype = ctypes.c_char_p
    for what, want in (("max_stack", MAX_STACK), ("users_per_lane", USERS_PER_LANE)):
        query = getattr(lib, f"bvh_traverse_{what}")
        query.argtypes, query.restype = [], ctypes.c_int
        if query() != want:
            raise RuntimeError(f"csrc/bvh_traverse.cu has {what} {query()}, kernels/bvh.py "
                               f"expects {want}")
    return lib


def bvh_count_batch_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, batch: BvhBatch, k_cap: int,
    order: UserOrder | None = None,
) -> torch.Tensor:
    """``[Q, N]`` int32 hit counts on the card, saturated at ``k_cap``, in
    the users' order.  ``xs, ys``: ``[N]`` f32 users on the device of the
    batch (:func:`bvh_batch`).  ``order`` as in
    :func:`repro_torch.kernels.rank_count.rank_count_batch_kernel_call`.
    Launches on the current stream and does not synchronize; an empty
    ``Q`` or ``N`` launches nothing."""
    global batch_launches
    out, _pops, _steps, launched = _launch(xs, ys, batch, k_cap, order)
    batch_launches += launched
    return out


def bvh_count_kernel_call(
    xs: torch.Tensor, ys: torch.Tensor, batch: BvhBatch, k_cap: int,
    order: UserOrder | None = None,
) -> torch.Tensor:
    """``[N]`` int32 hit counts of a batch of one tree: the batched kernel
    at ``Q = 1``."""
    global launches
    if batch.left.shape[0] != 1:
        raise ValueError(f"the single-tree launch takes a batch of one tree, got "
                         f"{batch.left.shape[0]}")
    out, _pops, _steps, launched = _launch(xs, ys, batch, k_cap, order)
    launches += launched
    return out[0]


def walk_stats(xs: torch.Tensor, ys: torch.Tensor, batch: BvhBatch, k_cap: int,
               order: UserOrder | None = None) -> WalkStats:
    """The counting instance of the kernel (not a serving launch, and not
    counted): the counts, each lane's pops and each warp's steps."""
    out, pops, steps, _ = _launch(xs, ys, batch, k_cap, order, with_pops=True)
    return WalkStats(out, pops, steps)


def _launch(xs, ys, batch: BvhBatch, k_cap: int, order, with_pops: bool = False):
    """Check the users, allocate and launch: ``(out, pops, steps, 1 if
    launched else 0)``, ``out`` ``[Q, N]`` in the users' order; when
    ``with_pops``, ``pops`` ``[2, Q, N]`` and ``steps``
    ``[Q, ceil(N / (32 * USERS_PER_LANE))]`` (:class:`WalkStats`), else
    ``None``."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the BVH traversal kernel needs CUDA tensors, got {dev}")
    n = xs.shape[0]
    if xs.ndim != 1 or ys.shape != (n,):
        raise ValueError(f"xs, ys must both be [N], got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if xs.dtype != torch.float32 or ys.dtype != torch.float32 or ys.device != dev:
        raise ValueError(f"xs, ys must be float32 on {dev}")
    if batch.nodes is None or batch.nodes.device != dev:
        where = "the CPU" if batch.nodes is None else batch.nodes.device
        raise ValueError(f"the trees were packed for {where}, the users are on {dev}")
    q_n = batch.left.shape[0]
    if q_n > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, got {q_n}")
    if k_cap < 0:
        raise ValueError(f"k_cap must be >= 0, got {k_cap}")
    out = torch.empty((q_n, n), dtype=torch.int32, device=dev)
    pops = steps = None
    if with_pops:
        pops = torch.empty((2, q_n, n), dtype=torch.int32, device=dev)
        steps = torch.empty((q_n, -(-n // (32 * USERS_PER_LANE))), dtype=torch.int32, device=dev)
    if q_n == 0 or n == 0:
        return out, pops, steps, 0
    if order is None:
        order = build_user_order(xs, ys)
    check_order(order, n, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bvh_traverse(
            order.xs_s.data_ptr(), order.ys_s.data_ptr(), order.perm.data_ptr(),
            batch.nodes.data_ptr(), batch.tris.data_ptr(), batch.root.data_ptr(),
            out.data_ptr(), None if pops is None else pops.data_ptr(),
            None if steps is None else steps.data_ptr(), n, batch.nodes.shape[1],
            batch.tris.shape[1], q_n, k_cap, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bvh_traverse launch failed: {lib.bvh_traverse_error_string(rc).decode()}"
        )
    return out, pops, steps, 1
