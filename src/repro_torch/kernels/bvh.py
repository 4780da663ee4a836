"""Launch the BVH stack-traversal kernel (``csrc/bvh_traverse.cu``).

Replaces the JAX package's traversal (``repro/core/bvh.py``
``bvh_hit_counts`` and ``bvh_hit_counts_batch``, a ``lax.while_loop``
under ``vmap``, not a Pallas site): one thread per (query, user) walks
its query's tree with an explicit stack and stops at ``k_cap`` hits.  The
kernel reads the users in the spatial order of
:mod:`repro_torch.kernels.user_order` (so a warp's lanes walk nearly the
same nodes) and stores each count through the order's permutation into
the callers' order.  Any order of the users gives the same counts.

The trees reach the kernel (and its plain version) as a :class:`BvhBatch`
made by :func:`bvh_batch`, which checks their shapes and takes the stack
the walk needs from the node arrays themselves.
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
    "BvhBatch",
    "bvh_batch",
    "stack_depth",
    "bvh_count_batch_kernel_call",
    "bvh_count_kernel_call",
    "batch_launches",
    "launches",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else): the single-query wrapper and the batched wrapper.
launches = 0
batch_launches = 0

#: Entries of each thread's stack (``kMaxStack`` of ``csrc/bvh_traverse.cu``,
#: which the library also reports): a tree deeper than this is refused.
#: Ample for median-split trees, whose depth is ``ceil(log2 M) + 1``.
MAX_STACK = 64
_MAX_QUERIES = 65_535  # gridDim.y


class BvhBatch(NamedTuple):
    """A batch of trees as the kernel and its plain version read it, made
    by :func:`bvh_batch` only: its ``depth`` is the deepest tree's, taken
    there from the node arrays, so no caller hands the walk a wrong one."""

    left: torch.Tensor  # [Q, Nn] int32
    right: torch.Tensor  # [Q, Nn] int32
    bbox: torch.Tensor  # [Q, Nn, 4] f32, 16-byte aligned
    coeffs: torch.Tensor  # [Q, Mt, 3, 3] f32
    depth: int


def stack_depth(left, right) -> int:
    """Depth of the deepest tree of ``left, right`` (``[Nn]`` or ``[Q, Nn]``
    int arrays, numpy or host tensors; root node 0 at depth 1): the stack
    entries a walk needs (it pops one node and pushes at most two, so each
    internal node on a path adds one entry).

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
        has_l, has_r = kids_l >= 0, kids_r >= 0
        rows = np.concatenate([rows[has_l], rows[has_r]])
        nodes = np.concatenate([kids_l[has_l], kids_r[has_r]]).astype(np.int64)
    return depth


def bvh_batch(left, right, bbox, coeffs, device, *, max_stack: int = MAX_STACK) -> BvhBatch:
    """Check a stacked batch of trees (:func:`repro_torch.core.bvh.stack_bvhs`:
    ``left, right`` ``[Q, Nn]``, ``bbox`` ``[Q, Nn, 4]``, ``coeffs``
    ``[Q, Mt, 3, 3]``; numpy arrays or tensors), take its depth from a host
    copy of ``left, right``, and put it on ``device`` as the kernel reads it
    (int32 ids, float32 boxes and coefficients, contiguous, ``bbox``
    16-byte aligned).  A tree deeper than ``max_stack`` (at most
    :data:`MAX_STACK`) raises ``ValueError`` here, where the JAX walk
    drops the push."""
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
    depth = stack_depth(left.cpu().numpy(), right.cpu().numpy())
    stack = min(int(max_stack), MAX_STACK)
    if depth > stack:
        raise ValueError(f"a tree of depth {depth} needs a stack of {depth} entries; the walk "
                         f"has {stack} (max_stack={max_stack}, the kernel's {MAX_STACK})")
    left, right = (v.to(device, torch.int32).contiguous() for v in (left, right))
    bbox, coeffs = (v.to(device, torch.float32).contiguous() for v in (bbox, coeffs))
    if bbox.data_ptr() % 16:  # the kernel reads each box as a float4
        bbox = bbox.clone()
    return BvhBatch(left, right, bbox, coeffs, depth)


def _lib() -> ctypes.CDLL:
    lib = build.load("bvh_traverse")
    fn = lib.bvh_traverse
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.bvh_traverse_max_stack.argtypes = []
    lib.bvh_traverse_max_stack.restype = ctypes.c_int
    lib.bvh_traverse_error_string.argtypes = [ctypes.c_int]
    lib.bvh_traverse_error_string.restype = ctypes.c_char_p
    if lib.bvh_traverse_max_stack() != MAX_STACK:
        raise RuntimeError(
            f"csrc/bvh_traverse.cu has a stack of {lib.bvh_traverse_max_stack()}, "
            f"kernels/bvh.py expects {MAX_STACK}")
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
    out, _pops, launched = _launch(xs, ys, batch, k_cap, order)
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
    out, _pops, launched = _launch(xs, ys, batch, k_cap, order)
    launches += launched
    return out[0]


def _launch(xs, ys, batch: BvhBatch, k_cap: int, order, with_pops: bool = False):
    """Check the users, allocate and launch: ``(out, pops, 1 if launched
    else 0)``, ``out`` ``[Q, N]`` in the users' order; when ``with_pops``,
    ``pops`` ``[2, Q, N]``, the internal nodes (row 0) and the leaves (row
    1) each lane popped, else ``None``."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"the BVH traversal kernel needs CUDA tensors, got {dev}")
    n = xs.shape[0]
    if xs.ndim != 1 or ys.shape != (n,):
        raise ValueError(f"xs, ys must both be [N], got {tuple(xs.shape)}, {tuple(ys.shape)}")
    if xs.dtype != torch.float32 or ys.dtype != torch.float32 or ys.device != dev:
        raise ValueError(f"xs, ys must be float32 on {dev}")
    if batch.left.device != dev:
        raise ValueError(f"the trees are on {batch.left.device}, the users on {dev}")
    q_n, nn = batch.left.shape
    if q_n > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, got {q_n}")
    if k_cap < 0:
        raise ValueError(f"k_cap must be >= 0, got {k_cap}")
    out = torch.empty((q_n, n), dtype=torch.int32, device=dev)
    pops = torch.empty((2, q_n, n), dtype=torch.int32, device=dev) if with_pops else None
    if q_n == 0 or n == 0:
        return out, pops, 0
    if order is None:
        order = build_user_order(xs, ys)
    check_order(order, n, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bvh_traverse(
            order.xs_s.data_ptr(), order.ys_s.data_ptr(), order.perm.data_ptr(),
            batch.left.data_ptr(), batch.right.data_ptr(), batch.bbox.data_ptr(),
            batch.coeffs.data_ptr(), out.data_ptr(), None if pops is None else pops.data_ptr(),
            n, nn, batch.coeffs.shape[1], q_n, k_cap, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bvh_traverse launch failed: {lib.bvh_traverse_error_string(rc).decode()}"
        )
    return out, pops, 1
