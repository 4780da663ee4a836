"""The dense ray-cast kernel's tile design, on the CPU.

The kernel (``csrc/raycast.cu``) reads the users in a spatial order
(``repro_torch/kernels/user_order.py``), classifies every triangle once
per tile of users as SKIP, FULL or TEST on the tile's bounding box, and
tests single users only against the TEST triangles.  The kernel runs only
on the card (``tests/test_torch_cuda.py``); here its plain twin
``ref.raycast_tile_classes_ref`` (the same float64 arithmetic and margin)
is held against the plain count: "add the FULL triangles, test only the
TEST ones" must equal ``raycast_count_batch_ref`` exactly, ties included,
on inputs built to sit on or within a few ulps of edges and tile corners.
Small sizes: each case runs in well under a second.
"""

import numpy as np
import pytest
import torch

from repro.core.geometry import Rect
from repro.core.scene import build_scene
from repro.kernels import ops as jops
from repro_torch.core import RkNNConfig, RkNNEngine
from repro_torch.kernels import ops, ref
from repro_torch.kernels.user_order import TILE_USERS, build_user_order

from tests._torch_parity import (
    CPU,
    adversarial_coeffs,
    adversarial_users,
    edge_tie_mask,
    instance,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tile_boxes(order, tile):
    """The ``[n_tiles, 4]`` boxes of the order's sorted users cut into tiles
    of ``tile`` (the last one ragged): the order's own boxes at
    ``TILE_USERS``, and smaller tiles for small test sets."""
    n = order.xs_s.shape[0]
    n_tiles = -(-n // tile)
    xy = torch.stack([order.xs_s, order.ys_s])
    pad = xy[:, -1:].expand(2, n_tiles * tile - n)
    lo, hi = torch.aminmax(torch.cat([xy, pad], dim=1).reshape(2, n_tiles, tile), dim=2)
    return torch.cat([lo, hi]).T.contiguous()


def tiled_count(order, coeffs, tile=TILE_USERS):
    """``[Q, N]`` counts in the users' order the way the kernel forms them,
    on tiles of ``tile`` sorted users: per tile, the FULL triangles plus the
    TEST triangles that hold the user; a SKIP triangle adds nothing
    whatever the user."""
    classes = ref.raycast_tile_classes_ref(tile_boxes(order, tile), coeffs)  # [Q, T, Mp]
    tile_of = torch.arange(order.xs_s.shape[0]) // tile
    per_user = classes[:, tile_of, :]  # [Q, N, Mp]
    inside = ref.raycast_count_batch_ref  # the per-user test, one triangle at a time below
    hits = torch.zeros(per_user.shape, dtype=torch.bool)
    for t in range(coeffs.shape[1]):
        hits[:, :, t] = inside(order.xs_s, order.ys_s, coeffs[:, t : t + 1]) > 0
    sorted_counts = ((hits & (per_user == ref.TILE_TEST)) | (per_user == ref.TILE_FULL)).sum(
        -1, dtype=torch.int32
    )
    out = torch.empty_like(sorted_counts)
    out[:, order.perm.long()] = sorted_counts
    return out, classes


def _anchors(xs, ys, boxes):
    """Users and the corners of every tile box: the points edges pass through."""
    b = boxes.numpy()
    cx = np.concatenate([xs, b[:, 0], b[:, 2], b[:, 0], b[:, 2]])
    cy = np.concatenate([ys, b[:, 1], b[:, 3], b[:, 3], b[:, 1]])
    return cx, cy


# (seed, users, tile, queries, triangle slots, coordinate scale, offset, normal scale)
CASES = {
    "unit": (0, 700, 16, 2, 64, 1.0, 0.0, 1.0),
    "one-user-tiles": (1, 40, 1, 2, 32, 1.0, 0.0, 1.0),
    "one-user": (2, 1, 16, 3, 16, 1.0, 0.0, 1.0),
    "ragged-tile": (3, 1025, 64, 1, 40, 1.0, 0.0, 1.0),
    "kernel-tile": (4, 2100, TILE_USERS, 2, 24, 1.0, 0.0, 1.0),
    "near-zero": (5, 600, 8, 2, 48, 1e-3, 0.0, 1.0),
    "subnormal-products": (6, 500, 8, 2, 48, 1e-21, 0.0, 1e-21),
    "near-1e4": (7, 800, 32, 2, 48, 1.0, 1e4, 1.0),
    "1e4-wide": (8, 800, 16, 1, 48, 1e4, 0.0, 1.0),
    "mp-300": (9, 300, 16, 1, 300, 1.0, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_classes_reproduce_the_plain_count_exactly(case):
    seed, n, tile, q_n, mp, scale, offset, coef_scale = CASES[case]
    xs, ys = adversarial_users(seed, n, scale=scale, offset=offset)
    order = build_user_order(_t(xs), _t(ys))
    coeffs = _t(adversarial_coeffs(seed + 100, q_n, mp, *_anchors(xs, ys, tile_boxes(order, tile)),
                                   coef_scale=coef_scale))
    got, classes = tiled_count(order, coeffs, tile)
    want = ref.raycast_count_batch_ref(_t(xs), _t(ys), coeffs)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # the case exercises what it is meant to: SKIP and TEST always, FULL
    # wherever tiles are small against the triangles (not where every term
    # lies below the margin's 2^-126 floor), and users at an exact or near
    # edge tie
    seen = set(torch.unique(classes).tolist())
    assert {ref.TILE_SKIP, ref.TILE_TEST} <= seen
    if tile <= 64 and n >= 40 and scale * coef_scale > 1e-30:
        assert ref.TILE_FULL in seen
    assert edge_tie_mask(xs, ys, coeffs[0].numpy()).any()


def test_padding_rows_are_skipped_on_every_tile():
    xs, ys = adversarial_users(11, 900, scale=1e4, offset=-5e3)
    order = build_user_order(_t(xs), _t(ys))
    coeffs = torch.zeros(2, 5, 3, 3)
    coeffs[..., 2] = -1.0
    for boxes in (order.boxes, tile_boxes(order, 32)):
        assert (ref.raycast_tile_classes_ref(boxes, coeffs) == ref.TILE_SKIP).all()


def test_classifier_refuses_to_decide_where_float32_terms_may_overflow_or_are_nan():
    box = torch.tensor([[1.0, 1.0, 2.0, 2.0]])
    huge = torch.tensor([[[[3e38, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                          [[-3e38, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                          [[float("nan"), 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                          [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]]]])
    classes = ref.raycast_tile_classes_ref(box, huge)[0, 0].tolist()
    assert classes == [ref.TILE_TEST, ref.TILE_TEST, ref.TILE_TEST, ref.TILE_FULL]


@pytest.mark.parametrize("n,tile", [(1, 1024), (1023, 1024), (1025, 1024), (3000, 64), (5, 1)])
def test_user_order_is_a_permutation_with_tiles_inside_their_boxes(n, tile):
    xs, ys = adversarial_users(n, n)
    order = build_user_order(_t(xs), _t(ys))
    perm = order.perm.long()
    assert order.perm.dtype == torch.int32
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    assert torch.equal(order.xs_s, _t(xs)[perm]) and torch.equal(order.ys_s, _t(ys)[perm])
    # the order's own boxes, and the test helper's at the tile of the case
    assert torch.equal(tile_boxes(order, TILE_USERS), order.boxes)
    for size, boxes in ((TILE_USERS, order.boxes), (tile, tile_boxes(order, tile))):
        n_tiles = -(-n // size)
        assert boxes.shape == (n_tiles, 4) and boxes.dtype == torch.float32
        box = boxes[torch.arange(n) // size]
        assert bool(((box[:, 0] <= order.xs_s) & (order.xs_s <= box[:, 2])).all())
        assert bool(((box[:, 1] <= order.ys_s) & (order.ys_s <= box[:, 3])).all())
        # each box is the tight box of its tile's users (the last tile ragged)
        last = order.ys_s[(n_tiles - 1) * size :]
        assert boxes[-1, 1] == last.min() and boxes[-1, 3] == last.max()
    # the unsort index gathers counts in tile order back to the users' order
    assert order.unsort.dtype == torch.int32
    counts = _t(np.random.default_rng(n).integers(0, 99, (2, n)).astype(np.int32))
    assert torch.equal(counts[:, perm].index_select(1, order.unsort), counts)


def test_user_order_groups_close_users_and_handles_empty_and_flat_sets():
    rng = np.random.default_rng(3)
    xs, ys = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    order = build_user_order(_t(xs), _t(ys))
    # 4 tiles of a Z-order over the unit square, and 16 of a quarter the size:
    # each box is a small part of it
    for b, most in ((order.boxes, 0.4), (tile_boxes(order, 256), 0.15)):
        assert float(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).mean()) < most
    empty = build_user_order(torch.zeros(0), torch.zeros(0))
    assert empty.perm.shape == (0,) and empty.boxes.shape == (0, 4)
    flat = build_user_order(torch.full((10,), 2.0), torch.arange(10.0))
    assert torch.equal(torch.sort(flat.perm.long()).values, torch.arange(10))
    with pytest.raises(ValueError, match=r"\[N\]"):
        build_user_order(torch.zeros(3), torch.zeros(4))


def test_plain_path_ignores_the_order_and_matches_the_jax_kernel():
    rng = np.random.default_rng(21)
    F = rng.random((50, 2))
    rect = Rect(0.0, 0.0, 1.0, 1.0)
    coeffs = np.stack([build_scene(F, qi, 4, rect, pad_to=64).coeffs for qi in (0, 9, 17)])
    U = rng.random((1500, 2)).astype(np.float32)
    xs, ys = _t(U[:, 0]), _t(U[:, 1])
    order = build_user_order(xs, ys)
    got = ops.raycast_count_batch(xs, ys, _t(coeffs), order=order).numpy()
    np.testing.assert_array_equal(got, ops.raycast_count_batch(xs, ys, _t(coeffs)).numpy())
    np.testing.assert_array_equal(
        ops.raycast_count(xs, ys, _t(coeffs[1]), order=order).numpy(), got[1]
    )
    pallas = np.asarray(
        jops.raycast_count_batch(U[:, 0], U[:, 1], coeffs, backend="pallas", interpret=True)
    )
    tiled, _ = tiled_count(order, _t(coeffs), 32)
    for i in range(len(coeffs)):
        ok = ~edge_tie_mask(U[:, 0], U[:, 1], coeffs[i])
        np.testing.assert_array_equal(got[i][ok], pallas[i][ok])
        np.testing.assert_array_equal(tiled[i].numpy(), got[i])


def test_dense_engine_on_the_cpu_builds_no_user_order():
    F, U, _ = instance(5, M=40, N=300)
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    eng.query_batch([1, 2], 4)
    eng.query(3, 4)
    assert not [k for k in eng._snap.kernel_memo._store if k[0] == "user-order"]
