"""The BVH walk kernel's host side and the walks it must repeat, on the CPU.

The kernel (``csrc/bvh_traverse.cu``) walks each tree once per warp for a
span of 128 sorted users (4 a lane) over records that ``kernels/bvh.py
pack_bvh`` packs in host numpy inside ``bvh_batch`` (for a batch on the
card only).  It runs only on the card (``tests/test_torch_cuda.py``); here:

* the plain walk's pops (``ref.bvh_hit_counts_ref(pops=True)``, the
  internal nodes and leaves each lane popped) equal those of a direct
  Python transcription of the JAX loop (``repro/core/bvh.py``
  ``bvh_hit_counts``), lane for lane, and its counts bit for bit (both
  round every operation in float32); the transcription's counts equal
  JAX's off edge ties (``tests/_torch_parity.py: edge_tie_mask``), where
  XLA's fused multiply-adds may split a tie;
* the packed records decode to the tree, and its edge cases (one-leaf
  root, empty scene, padded batch, a leaf row ``>= Mt``, a child
  ``>= Nn``) pack to records that walk as the plain version does;
* the numpy twin of the warp walk over those records
  (``tests/_torch_parity.py: warp_walk_twin``) gives the plain walk's
  counts and pops bit for bit, on ragged last warps, on spans of 32 to
  256 users and on trees of depth 33-64 whose stack reaches the second
  register slot, and JAX's counts off edge ties.
"""

import numpy as np
import pytest
import torch

from repro.core import bvh as jbvh
from repro.core.geometry import Rect as JRect
from repro.core.geometry import edge_coeffs
from repro.core.scene import build_scene as j_build_scene
from repro_torch.core import bvh as tbvh
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bvh import RECORD_FLOATS, bvh_batch, pack_bvh
from repro_torch.kernels.user_order import build_user_order

from tests._torch_parity import CPU, chain_tree, edge_tie_mask, instance, warp_walk_twin

NEVER_INSIDE = [0.0, 0.0, -1.0] * 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _records(batch):
    """The kernel's records of a batch made for the CPU, which holds none:
    ``pack_bvh`` on its node arrays, as ``bvh_batch`` packs for the card."""
    assert batch.nodes is None and batch.tris is None and batch.root is None
    return pack_bvh(*(v.numpy() for v in batch[:4]))


def _mixed(n_users=150):
    """Scenes of several sizes (infzone, non-pruned, empty, M = 1..3) and
    ``n_users`` users: ``(xs, ys, [(tris, coeffs)])``."""
    F, U, rng = instance(31, 60, n_users)
    rect = JRect.from_points(F, U)
    parts = []
    for q, strategy in ((3, "infzone"), (8, "none"), (21, "infzone")):
        sc = j_build_scene(F, q, 5, rect, strategy=strategy)
        parts.append((sc.tris[: sc.n_tris], sc.coeffs[: sc.n_tris]))
    for m in (0, 1, 2, 3):
        tris = rng.random((m, 3, 2))
        parts.append((tris, edge_coeffs(tris) if m else np.zeros((0, 3, 3), np.float32)))
    xs, ys = (np.ascontiguousarray(U[:, i], np.float32) for i in (0, 1))
    return xs, ys, parts


def _stacked(parts):
    return tbvh.stack_bvhs([tbvh.build_bvh(t) for t, _ in parts], [c for _, c in parts])


def _jax_loop(x, y, left, right, bbox, coeffs, k, max_stack=64):
    """``repro/core/bvh.py`` ``bvh_hit_counts``'s loop for one user, line
    for line, in float32 scalars (one rounding per operation), counting
    the internal nodes and the leaves it pops: ``(count, inner, leaves)``."""
    k_cap = int(k) if k is not None else int(coeffs.shape[0]) + 1
    stack = [0] * max_stack
    sp, cnt, inner, leaves = (1 if coeffs.shape[0] > 0 else 0), 0, 0, 0
    while sp > 0 and cnt < k_cap:  # cond
        node = stack[sp - 1]
        sp -= 1
        l, r = int(left[node]), int(right[node])
        is_leaf = l < 0
        e = coeffs[max(-l - 1, 0)]
        inside = all((x * e[i, 0] + y * e[i, 1]) + e[i, 2] >= 0 for i in range(3))
        cnt += int(is_leaf and inside)
        li, ri = max(l, 0), max(r, 0)

        def in_box(b):
            return x >= b[0] and y >= b[1] and x <= b[2] and y <= b[3]

        push_l = (not is_leaf) and in_box(bbox[li])
        push_r = (not is_leaf) and r >= 0 and in_box(bbox[ri])
        if sp < max_stack:
            stack[sp] = li
        sp += int(push_l)
        if sp < max_stack:
            stack[sp] = ri
        sp += int(push_r)
        inner += int(not is_leaf)
        leaves += int(is_leaf)
    return cnt, inner, leaves


@pytest.mark.parametrize("k", [1, 3, None])
def test_plain_pops_equal_a_transcription_of_the_jax_loop(k):
    xs, ys, parts = _mixed()
    stacked = _stacked(parts)
    counts, pops = ops.bvh_count_stacked(_t(xs), _t(ys), bvh_batch(*stacked, CPU), k=k,
                                         backend="ref", pops=True)
    left, right, bbox, coeffs = stacked
    loop = np.array([[_jax_loop(x, y, left[q], right[q], bbox[q], coeffs[q], k)
                      for x, y in zip(xs, ys)] for q in range(len(parts))], np.int32)
    np.testing.assert_array_equal(counts.numpy(), loop[..., 0])
    np.testing.assert_array_equal(pops.numpy(), np.moveaxis(loop[..., 1:], -1, 0))
    assert int(pops.sum(0).min()) >= 1  # every lane pops the root, the empty scene's too
    want = np.asarray(jbvh.bvh_hit_counts_batch(xs, ys, *stacked, k=k))
    for q, (_, cf) in enumerate(parts):
        off = ~edge_tie_mask(xs, ys, cf)
        np.testing.assert_array_equal(loop[q, off, 0], want[q][off])


def test_packed_records_decode_to_the_tree():
    _, _, parts = _mixed()
    left, right, bbox, coeffs = _stacked(parts)
    nodes, tris, root = _records(bvh_batch(left, right, bbox, coeffs, CPU))
    q_n, mt = left.shape[0], coeffs.shape[1]
    assert nodes.dtype == tris.dtype == np.float32 and root.dtype == np.int32
    assert nodes.shape == (q_n, max(int((left >= 0).sum(1).max()), 1), RECORD_FLOATS)
    assert tris.shape == (q_n, mt + 1, RECORD_FLOATS)
    for t in (nodes, tris):  # three 16-byte loads a record
        assert t.flags.c_contiguous and RECORD_FLOATS * 4 == 48
    codes = nodes.view(np.int32)[..., 8:10]
    for q in range(q_n):
        internal = np.flatnonzero(left[q] >= 0)
        index = {int(v): j for j, v in enumerate(internal)}

        def code(c):
            return index[c] if left[q, c] >= 0 else int(left[q, c])  # a leaf's ~row

        assert root[q] == code(0)
        for j, node in enumerate(internal):
            lc, rc = int(left[q, node]), int(right[q, node])
            np.testing.assert_array_equal(nodes[q, j, 0:4], bbox[q, lc])
            np.testing.assert_array_equal(nodes[q, j, 4:8], bbox[q, rc])
            assert (codes[q, j, 0], codes[q, j, 1]) == (code(lc), code(rc))
            assert not nodes[q, j, 10:].any()
        assert not nodes[q, len(internal):].any()  # rows past the tree's own
        np.testing.assert_array_equal(tris[q, :mt, :9], coeffs[q].reshape(mt, 9))
        np.testing.assert_array_equal(tris[q, mt, :9], NEVER_INSIDE)
        assert not tris[q, :, 9:].any()


def _hand_tree(case):
    """``(left, right, bbox, coeffs)`` of one tree for an edge case of
    the packing, and the root code and left-child code it must get."""
    box = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    full = np.array([[0.0, 0.0, 1.0]] * 3, np.float32)  # holds every user
    if case == "one_leaf_root":
        tree = tbvh.build_bvh(np.random.default_rng(1).random((1, 3, 2)))
        return tree.left, tree.right, tree.bbox, full[None], -1, None
    if case == "empty_scene":  # unpadded: Mt = 0, the leaf root names row 0 = Mt
        tree = tbvh.build_bvh(np.zeros((0, 3, 2)))
        return tree.left, tree.right, tree.bbox, np.zeros((0, 3, 3), np.float32), -1, None
    if case == "leaf_row_past_mt":  # the left leaf names row 5 of 2
        left, right = np.array([1, -6, -1], np.int32), np.array([2, -1, -1], np.int32)
        return left, right, np.tile(box, (3, 1)), np.stack([full, full]), 0, ~2
    if case == "child_past_nn":  # the right child is node 6 of 3
        left, right = np.array([1, -1, -2], np.int32), np.array([6, -1, -1], np.int32)
        return left, right, np.tile(box, (3, 1)), np.stack([full, full]), 0, ~0
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["one_leaf_root", "empty_scene", "leaf_row_past_mt",
                                  "child_past_nn"])
def test_packing_edge_cases_walk_as_the_plain_version(case):
    left, right, bbox, coeffs, root_code, left_code = _hand_tree(case)
    batch = bvh_batch(*(_t(a)[None] for a in (left, right, bbox, coeffs)), CPU)
    nodes, tris, root = _records(batch)
    assert int(root[0]) == root_code
    mt = coeffs.shape[0]
    np.testing.assert_array_equal(tris[0, mt, :9], NEVER_INSIDE)
    if left_code is not None:
        rec = nodes[0, 0]
        assert int(rec.view(np.int32)[8]) == left_code
        if case == "child_past_nn":  # an empty box: min +inf, max -inf
            assert rec[4:8].tolist() == [np.inf, np.inf, -np.inf, -np.inf]
    xs, ys = (_t(v) for v in (np.linspace(0.05, 0.95, 45, dtype=np.float32),) * 2)
    counts, pops = ops.bvh_count_stacked(xs, ys, batch, k=None, backend="ref", pops=True)
    order = build_user_order(xs, ys)
    twin = warp_walk_twin(order.xs_s.numpy(), order.ys_s.numpy(), nodes, tris, root, mt + 1)
    perm = order.perm.long().numpy()
    np.testing.assert_array_equal(twin[0], counts.numpy()[:, perm])
    np.testing.assert_array_equal(twin[1], pops.numpy()[:, :, perm])
    want_hits = {"one_leaf_root": 1, "empty_scene": 0, "leaf_row_past_mt": 1,
                 "child_past_nn": 1}[case]
    assert counts.tolist() == [[want_hits] * 45]
    want_pops = {"one_leaf_root": (0, 1), "empty_scene": (0, 1), "leaf_row_past_mt": (1, 2),
                 "child_past_nn": (1, 1)}[case]
    assert pops[:, 0].T.tolist() == [list(want_pops)] * 45


def _twin_case(case):
    """``(xs, ys, [(left, right, bbox, coeffs)])`` for the warp twin."""
    if case == "mixed":  # 333 users: ten warps and a ragged one of 13
        xs, ys, parts = _mixed(333)
        left, right, bbox, coeffs = _stacked(parts)
        return xs, ys, [(left, right, bbox, coeffs)]
    depth, side = int(case.split("_")[1]), case.split("_")[2]
    left, right, bbox = chain_tree(depth, leaf_side=side)
    coeffs = np.tile(np.array([[0.0, 0.0, 1.0]] * 3, np.float32), (depth, 1, 1))
    coeffs[1::3, 2] = (0.0, 0.0, -1.0)  # every third triangle holds no user
    rng = np.random.default_rng(depth)
    xs, ys = (rng.uniform(-0.2, 1.2, 100).astype(np.float32) for _ in range(2))
    return xs, ys, [tuple(a[None] for a in (left, right, bbox, coeffs))]


@pytest.mark.parametrize("k", [0, 1, 3, None])
@pytest.mark.parametrize("case", ["mixed", "chain_33_left", "chain_34_left", "chain_64_left",
                                  "chain_64_right"])
def test_warp_walk_twin_repeats_the_plain_walk_lane_for_lane(case, k):
    if case != "mixed" and k in (1, 3):
        k = 2 * k + 9  # the chains: a cap that ends the walk part way down
    xs, ys, [stacked] = _twin_case(case)
    batch = bvh_batch(*stacked, CPU)
    counts, pops = ops.bvh_count_stacked(_t(xs), _t(ys), batch, k=k, backend="ref", pops=True)
    order = build_user_order(_t(xs), _t(ys))
    k_cap = ops._bvh_k_cap(k, batch.coeffs.shape[1])
    got, got_pops, steps, most = warp_walk_twin(order.xs_s.numpy(), order.ys_s.numpy(),
                                                *_records(batch), k_cap)
    perm = order.perm.long().numpy()
    np.testing.assert_array_equal(got, counts.numpy()[:, perm])
    np.testing.assert_array_equal(got_pops, pops.numpy()[:, :, perm])
    both = np.pad(got_pops.sum(0), ((0, 0), (0, -len(xs) % 32))).reshape(len(got), -1, 32)
    assert (steps >= both.max(2)).all() and (steps <= both.sum(2)).all()
    if case.endswith("left") and k != 0:  # entry e in slot e // 32: from depth 34 on, slot 1
        assert most == batch.depth - 1
    if k == 0:
        assert not got.any() and not got_pops.any() and not steps.any()
    want = np.asarray(jbvh.bvh_hit_counts_batch(xs, ys, *stacked, k=k))
    for q in range(len(got)):
        off = ~edge_tie_mask(xs, ys, stacked[3][q])
        np.testing.assert_array_equal(counts.numpy()[q][off], want[q][off])


def test_plain_pops_are_chunk_independent_and_empty_shapes():
    xs, ys, parts = _mixed(200)
    batch = bvh_batch(*_stacked(parts), CPU)
    xs, ys = _t(xs), _t(ys)
    whole, pops = ref.bvh_hit_counts_ref(xs, ys, *batch[:4], 4, batch.depth, pops=True)
    cut = [ref.bvh_hit_counts_ref(xs[s : s + 37], ys[s : s + 37], *batch[:4], 4, batch.depth,
                                  pops=True) for s in range(0, len(xs), 37)]
    assert torch.equal(whole, torch.cat([c for c, _ in cut], dim=1))
    assert torch.equal(pops, torch.cat([p for _, p in cut], dim=2))
    assert torch.equal(whole, ref.bvh_hit_counts_ref(xs, ys, *batch[:4], 4, batch.depth))
    counts, none = ops.bvh_count_stacked(xs[:0], ys[:0], batch, k=4, pops=True)
    assert counts.shape == (len(parts), 0) and none.shape == (2, len(parts), 0)
    assert none.dtype == counts.dtype == torch.int32


@pytest.mark.parametrize("warp", [64, 128, 256])
@pytest.mark.parametrize("case", ["mixed", "chain_64_left"])
def test_warp_walk_twin_over_wider_spans(case, warp):
    """A warp that walks for a span wider than its 32 lanes (64, 128 or 256
    sorted users; the kernel walks for 128, 4 a lane) gives every user the
    same nodes."""
    xs, ys, [stacked] = _twin_case(case)
    batch = bvh_batch(*stacked, CPU)
    counts, pops = ops.bvh_count_stacked(_t(xs), _t(ys), batch, k=11, backend="ref", pops=True)
    order = build_user_order(_t(xs), _t(ys))
    k_cap = ops._bvh_k_cap(11, batch.coeffs.shape[1])
    records = _records(batch)
    got, got_pops, steps, most = warp_walk_twin(order.xs_s.numpy(), order.ys_s.numpy(),
                                                *records, k_cap, warp=warp)
    perm = order.perm.long().numpy()
    np.testing.assert_array_equal(got, counts.numpy()[:, perm])
    np.testing.assert_array_equal(got_pops, pops.numpy()[:, :, perm])
    assert steps.shape == (len(got), -(-len(xs) // warp))
    narrow = warp_walk_twin(order.xs_s.numpy(), order.ys_s.numpy(), *records, k_cap)[2]
    assert steps.sum() <= narrow.sum()  # a wider span takes each shared node once
    if case.endswith("left"):
        assert most == batch.depth - 1
