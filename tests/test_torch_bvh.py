"""The port's BVH path against the JAX package's, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Tolerances:

* host code (``build_bvh``, ``refit_bvh`` with its quality gate,
  ``stack_bvhs``) — bit-identical arrays;
* counts — int32, exactly equal on every user that is not at a
  rounding-level edge tie (``tests/_torch_parity.py: edge_tie_mask``):
  XLA contracts ``a*x + b*y + c`` into fused multiply-adds, while the
  port rounds every operation (its one rounding contract);
* within the port — the traversal equals ``min(dense count, k)`` off edge
  ties (the dense count reaches every triangle, the walk only those whose
  boxes hold the user), and a numpy twin of the walk that pops the
  children in the other order gives the same counts bit for bit.

The engine paths (``query``, ``query_batch``, ``query_mono``, ``stream``
and the shims with ``backend="bvh"``) are held against the JAX engine by
``tests/test_torch_engine.py``; the CUDA kernel against its plain version
by ``tests/test_torch_cuda.py`` (skips without a card) and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import bvh as jbvh
from repro.core.geometry import Rect as JRect
from repro.core.geometry import edge_coeffs
from repro.core.scene import build_scene as j_build_scene
from repro_torch.core import bvh as tbvh
from repro_torch.core.backends import get_backend
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.scene import build_scene
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bvh import bvh_batch, stack_depth

from tests._torch_parity import CPU, edge_tie_mask, instance


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(seed, strategy="infzone", M=60, N=400, k=5):
    """A JAX scene of a random query over ``instance(seed)``, its users."""
    F, U, rng = instance(seed, M, N)
    q = int(rng.integers(0, M))
    sc = j_build_scene(F, q, k, JRect.from_points(F, U), strategy=strategy)
    return sc.tris[: sc.n_tris], sc.coeffs[: sc.n_tris], U


def _hand_tris(m, seed=5):
    """``m`` random triangles in the unit square (M = 1, 2, 3 trees)."""
    return np.random.default_rng(seed).random((m, 3, 2))


def _same_bvh(a, b):
    for f in ("left", "right", "bbox"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert a.n_tris == b.n_tris


def _users(U):
    xs, ys = (np.ascontiguousarray(U[:, i], np.float32) for i in (0, 1))
    return xs, ys


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy", ["infzone", "none"])
def test_build_and_stack_bit_identical(seed, strategy):
    tris, coeffs, _ = _scene(seed, strategy)
    a, b = jbvh.build_bvh(tris), tbvh.build_bvh(tris)
    _same_bvh(a, b)
    assert a.depth() == b.depth()  # JAX's walk of the tree, the port's stack_depth
    assert b.depth() == int(np.ceil(np.log2(len(tris)))) + 1


@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_tiny_and_empty_trees_bit_identical(m):
    tris = _hand_tris(m).reshape(m, 3, 2)
    a, b = jbvh.build_bvh(tris), tbvh.build_bvh(tris)
    _same_bvh(a, b)
    assert a.depth() == b.depth() == (1 if m <= 1 else 2 if m == 2 else 3)


def test_refit_gate_both_outcomes_and_changed_count():
    rng = np.random.default_rng(7)  # 64 small triangles spread over the unit square
    tris = rng.random((64, 1, 2)) + rng.normal(0.0, 0.01, (64, 3, 2))
    a, b = jbvh.build_bvh(tris), tbvh.build_bvh(tris)
    small = tris + rng.normal(0.0, 1e-3, tris.shape)
    _same_bvh(jbvh.refit_bvh(a, small), tbvh.refit_bvh(b, small))
    # shuffled triangles inflate the boxes past max_growth: both refuse
    shuffled = tris[rng.permutation(len(tris))]
    assert jbvh.refit_bvh(a, shuffled) is None and tbvh.refit_bvh(b, shuffled) is None
    # a looser gate takes the same shuffled refit in both
    _same_bvh(jbvh.refit_bvh(a, shuffled, max_growth=1e9),
              tbvh.refit_bvh(b, shuffled, max_growth=1e9))
    assert tbvh.refit_bvh(b, tris[:-1]) is None and jbvh.refit_bvh(a, tris[:-1]) is None
    empty = np.zeros((0, 3, 2))
    _same_bvh(jbvh.refit_bvh(jbvh.build_bvh(empty), empty),
              tbvh.refit_bvh(tbvh.build_bvh(empty), empty))


def _mixed_batch():
    """Scenes of several sizes (infzone, non-pruned, empty, M = 1..3), so
    the stack pads to a larger ``Nn`` and ``Mt`` than most trees have."""
    parts = [_scene(s, strat)[:2] for s, strat in ((0, "infzone"), (1, "none"), (2, "infzone"))]
    for m in (0, 1, 2, 3):
        tris = _hand_tris(m).reshape(m, 3, 2)
        parts.append((tris, edge_coeffs(tris) if m else np.zeros((0, 3, 3), np.float32)))
    return parts


def test_stack_bvhs_bit_identical_on_a_padded_batch():
    parts = _mixed_batch()
    ja = jbvh.stack_bvhs([jbvh.build_bvh(t) for t, _ in parts], [c for _, c in parts])
    ta = tbvh.stack_bvhs([tbvh.build_bvh(t) for t, _ in parts], [c for _, c in parts])
    for x, y in zip(ja, ta):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert stack_depth(ta[0], ta[1]) == max(jbvh.build_bvh(t).depth() for t, _ in parts)
    with pytest.raises(ValueError, match="at least one"):
        tbvh.stack_bvhs([], [])


@pytest.mark.parametrize("k", [None, 1, 4, 1000])
def test_batch_counts_match_jax_off_edge_ties(k):
    parts = _mixed_batch()
    _, _, U = _scene(0)
    xs, ys = _users(U)
    bvhs = [tbvh.build_bvh(t) for t, _ in parts]
    stacked = tbvh.stack_bvhs(bvhs, [c for _, c in parts])
    want = np.asarray(jbvh.bvh_hit_counts_batch(xs, ys, *stacked, k=k))
    got = tbvh.bvh_hit_counts_batch(_t(xs), _t(ys), *(_t(a) for a in stacked), k=k)
    assert got.dtype == torch.int32 and got.shape == want.shape
    for i, (_, coeffs) in enumerate(parts):
        off = ~edge_tie_mask(xs, ys, coeffs)
        np.testing.assert_array_equal(got[i].numpy()[off], want[i][off])
    if k is not None:
        assert got.max() <= k


@pytest.mark.parametrize("k", [None, 1, 4, 1000])
@pytest.mark.parametrize("strategy", ["infzone", "none"])
def test_single_counts_match_jax_and_saturate_the_dense_count(strategy, k):
    tris, coeffs, U = _scene(11, strategy)
    xs, ys = _users(U)
    b = tbvh.build_bvh(tris)
    want = np.asarray(jbvh.bvh_hit_counts(xs, ys, b.left, b.right, b.bbox, coeffs, k=k))
    got = tbvh.bvh_hit_counts(_t(xs), _t(ys), b.left, b.right, b.bbox, coeffs, k=k).numpy()
    off = ~edge_tie_mask(xs, ys, coeffs)
    np.testing.assert_array_equal(got[off], want[off])
    dense = ops.raycast_count(_t(xs), _t(ys), _t(coeffs)).numpy()
    cap = len(coeffs) + 1 if k is None else k
    np.testing.assert_array_equal(got[off], np.minimum(dense, cap)[off])


def test_refit_tree_counts_match_jax_and_a_fresh_build():
    tris, _, U = _scene(13, "none")
    xs, ys = _users(U)
    moved = tris + np.random.default_rng(14).normal(0.0, 5e-4, tris.shape)
    coeffs = edge_coeffs(moved)
    b = tbvh.refit_bvh(tbvh.build_bvh(tris), moved)
    assert b is not None
    want = np.asarray(jbvh.bvh_hit_counts(xs, ys, b.left, b.right, b.bbox, coeffs, k=6))
    got = tbvh.bvh_hit_counts(_t(xs), _t(ys), b.left, b.right, b.bbox, coeffs, k=6).numpy()
    fresh = tbvh.build_bvh(moved)
    cold = tbvh.bvh_hit_counts(_t(xs), _t(ys), fresh.left, fresh.right, fresh.bbox, coeffs,
                               k=6).numpy()
    off = ~edge_tie_mask(xs, ys, coeffs)
    np.testing.assert_array_equal(got[off], want[off])
    np.testing.assert_array_equal(got, cold)


def _walk_left_first(x, y, left, right, bbox, coeffs, k_cap):
    """A numpy twin of the kernel's walk that pops the LEFT child first
    (the kernel and the JAX loop pop the right one first), in float32 with
    one rounding per operation."""
    count, stack = 0, [0]
    while stack and count < k_cap:
        node = stack.pop()
        l = int(left[node])
        if l < 0:
            e = coeffs[-(l + 1)]
            if all((x * e[i, 0] + y * e[i, 1]) + e[i, 2] >= 0 for i in range(3)):
                count += 1
            continue
        for child in (int(right[node]), l):  # pushed right first: left pops first
            b = bbox[child]
            if child >= 0 and b[0] <= x <= b[2] and b[1] <= y <= b[3]:
                stack.append(child)
    return count


@pytest.mark.parametrize("k", [2, 5, None])
def test_counts_do_not_depend_on_the_order_children_are_popped(k):
    tris, coeffs, U = _scene(17, "none", N=150)
    xs, ys = _users(U)
    b = tbvh.build_bvh(tris)
    got = tbvh.bvh_hit_counts(_t(xs), _t(ys), b.left, b.right, b.bbox, coeffs, k=k).numpy()
    cap = len(coeffs) + 1 if k is None else k
    cf = coeffs.astype(np.float32)
    twin = [_walk_left_first(x, y, b.left, b.right, b.bbox, cf, cap) for x, y in zip(xs, ys)]
    np.testing.assert_array_equal(got, np.asarray(twin))


def test_plain_walk_is_chunk_independent_and_empty_shapes():
    parts = _mixed_batch()
    _, _, U = _scene(0)
    xs, ys = (_t(v) for v in _users(U))
    stacked = [_t(a) for a in tbvh.stack_bvhs([tbvh.build_bvh(t) for t, _ in parts],
                                               [c for _, c in parts])]
    batch = bvh_batch(*stacked, CPU)
    assert batch.depth == stack_depth(stacked[0].numpy(), stacked[1].numpy())
    whole = ref.bvh_hit_counts_ref(xs, ys, *batch[:4], 4, batch.depth)
    cut = torch.cat([ref.bvh_hit_counts_ref(xs[s : s + 37], ys[s : s + 37], *batch[:4], 4,
                                            batch.depth)
                     for s in range(0, len(xs), 37)], dim=1)
    assert torch.equal(whole, cut)
    assert torch.equal(whole, ops.bvh_count_batch(xs, ys, *stacked, k=4))
    assert torch.equal(whole, ops.bvh_count_stacked(xs, ys, batch, k=4))
    assert ops.bvh_count_batch(xs[:0], ys[:0], *stacked, k=4).shape == (len(parts), 0)
    none = ops.bvh_count_batch(xs, ys, *(a[:0] for a in stacked), k=4)
    assert none.shape == (0, len(xs)) and none.dtype == torch.int32


def _chain(depth):
    """A tree of ``depth`` levels that is a path (each internal node's left
    child is the next internal node, its right child a leaf), every box
    the unit square: deeper than any median-split tree of as many leaves."""
    n_int = depth - 1
    left, right = [], []
    for i in range(n_int):
        nxt = i + 1 if i + 1 < n_int else n_int + n_int  # the last one's left: a leaf
        left.append(nxt)
        right.append(n_int + i)
    n_nodes = 2 * n_int + 1
    left = np.array(left + [-(i + 1) for i in range(n_int + 1)], np.int32)
    right = np.array(right + [-1] * (n_int + 1), np.int32)
    bbox = np.tile(np.array([0.0, 0.0, 1.0, 1.0], np.float32), (n_nodes, 1))
    return left, right, bbox


def test_too_deep_tree_raises_instead_of_dropping_pushes():
    left, right, bbox = _chain(tbvh.MAX_STACK + 1)
    assert stack_depth(left, right) == tbvh.MAX_STACK + 1
    coeffs = np.tile(np.array([[0.0, 0.0, 1.0]] * 3, np.float32), (len(left) // 2 + 1, 1, 1))
    xs = ys = torch.full((5,), 0.5)
    with pytest.raises(ValueError, match="stack"):
        tbvh.bvh_hit_counts(xs, ys, left, right, bbox, coeffs)
    with pytest.raises(ValueError, match="stack"):
        tbvh.bvh_hit_counts_batch(xs, ys, left[None], right[None], bbox[None], coeffs[None])
    ok_l, ok_r, ok_b = _chain(tbvh.MAX_STACK)
    got = tbvh.bvh_hit_counts(xs, ys, ok_l, ok_r, ok_b, coeffs[: len(ok_l) // 2 + 1])
    assert got.tolist() == [len(ok_l) // 2 + 1] * 5  # every leaf's triangle holds (0.5, 0.5)
    with pytest.raises(ValueError, match="max_stack"):
        tbvh.bvh_hit_counts(xs, ys, ok_l, ok_r, ok_b, coeffs, max_stack=8)
    with pytest.raises(ValueError, match="k must be"):
        tbvh.bvh_hit_counts(xs, ys, ok_l, ok_r, ok_b, coeffs, k=-1)
    looped = np.array([1, 0], np.int32), np.array([1, 0], np.int32)
    with pytest.raises(ValueError, match="cycle"):
        stack_depth(*looped)


def test_the_batch_takes_its_own_depth_checks_shapes_and_aligns_boxes():
    tris, coeffs, _ = _scene(3)
    b = tbvh.build_bvh(tris)
    left, right, bbox, cf = tbvh.stack_bvhs([b], [coeffs])
    batch = bvh_batch(left, right, bbox, cf, CPU)
    assert batch.depth == b.depth() == jbvh.build_bvh(tris).depth()
    assert batch.left.dtype == batch.right.dtype == torch.int32
    assert batch.bbox.dtype == batch.coeffs.dtype == torch.float32
    shifted = torch.empty(bbox.size + 1)[1:].view(bbox.shape)  # 4 bytes off 16
    shifted.copy_(_t(bbox))
    assert shifted.data_ptr() % 16
    moved = bvh_batch(left, right, shifted, cf, CPU)
    assert moved.bbox.data_ptr() % 16 == 0 and torch.equal(moved.bbox, batch.bbox)
    with pytest.raises(ValueError, match="left, right"):
        bvh_batch(left, right[:, :-1], bbox, cf, CPU)
    with pytest.raises(ValueError, match="bbox"):
        bvh_batch(left, right, bbox[:, :-1], cf, CPU)
    with pytest.raises(ValueError, match="coeffs"):
        bvh_batch(left, right, bbox, cf[..., :2], CPU)
    # the public wrappers take no depth from their callers: they derive it
    xs, ys = torch.zeros(3), torch.zeros(3)
    for fn, args in ((ops.bvh_count_batch, (left, right, bbox, cf)),
                     (ops.bvh_count, (left[0], right[0], bbox[0], cf[0])),
                     (tbvh.bvh_hit_counts_batch, (left, right, bbox, cf)),
                     (tbvh.bvh_hit_counts, (left[0], right[0], bbox[0], cf[0]))):
        with pytest.raises(TypeError):
            fn(xs, ys, *args, depth=1)
        assert fn(xs, ys, *args).shape[-1] == 3


def test_engine_scene_cache_hit_reuses_the_bvh():
    F, U, _ = instance(19, 50, 300)
    eng = RkNNEngine(F, U, RkNNConfig(backend="bvh", batch_cache=0), device=CPU)
    a = eng.query_batch([3, 4], 5)
    scenes = a.scenes
    store = eng._snap.index_memo.store_for(scenes[0])
    first = store[("bvh", eng.config.grid_g)]
    b = eng.query_batch([3, 4], 5)
    assert eng.scene_cache.hits >= 2 and b.scenes[0] is scenes[0]
    assert eng._snap.index_memo.store_for(b.scenes[0])[("bvh", eng.config.grid_g)] is first
    np.testing.assert_array_equal(a.counts, b.counts)
    one = eng.query(3, 5)
    np.testing.assert_array_equal(one.counts, a.counts[0])


def test_backend_refit_index_refits_or_rebuilds():
    F, U, rng = instance(23, 60, 300)
    rect = Rect.from_points(F, U)
    be = get_backend("bvh")
    old = build_scene(F, 5, 4, rect, strategy="none")
    moved_f = F + rng.normal(0.0, 1e-4, F.shape)
    new = build_scene(moved_f, 5, 4, rect, strategy="none")
    changed = np.arange(new.n_tris)
    index = be.build_index(old)
    refit, was_refit = be.refit_index(index, old, new, changed)
    assert was_refit
    j_refit = jbvh.refit_bvh(index, new.tris[: new.n_tris])
    _same_bvh(refit, j_refit)
    far = build_scene(F[:-5], 5, 4, rect, strategy="none")  # fewer triangles: no refit
    rebuilt, was_refit = be.refit_index(index, old, far, np.arange(far.n_tris))
    assert not was_refit
    _same_bvh(rebuilt, tbvh.build_bvh(far.tris[: far.n_tris]))
    fresh, was_refit = be.refit_index(None, old, new, changed)
    assert not was_refit
    xs, ys = (_t(v) for v in _users(U))
    cf = new.coeffs[: new.n_tris]
    assert torch.equal(
        tbvh.bvh_hit_counts(xs, ys, refit.left, refit.right, refit.bbox, cf, k=4),
        tbvh.bvh_hit_counts(xs, ys, fresh.left, fresh.right, fresh.bbox, cf, k=4),
    )
