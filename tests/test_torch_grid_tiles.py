"""The grid kernel's block design, on the CPU.

The grid kernel (``csrc/grid_raycast.cu``) walks only each cell's listed
lanes (``cell_list_lengths``), reads the users of each cell in Morton
order with the padding rows on their run's last user
(``order_cell_runs``), and classifies the listed triangles once per user
block on the block's box (``block_boxes``) as SKIP, FULL or TEST, testing
single users only against the TEST ones.  The kernel runs only on the
card (``tests/test_torch_cuda.py``); here the plain twin of its classes,
``ref.grid_block_classes_ref`` (the float64 arithmetic and margin of
``csrc/tile_class.cuh``), is held against the plain count: "add the FULL
triangles, test only the TEST ones, up to each cell's length" must equal
``grid_cells_count_batch_ref`` exactly, ties included, on users on and a
few ulps off edges and block corners.  Small sizes: seconds in all.
"""

import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.core.geometry import Rect as JRect
from repro.core.geometry import edge_coeffs
from repro.core.scene import build_scene as j_build_scene
from repro.kernels import grid_raycast as jgr
from repro.workloads import SCENARIOS
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.kernels import grid_raycast, ops, ref
from repro_torch.kernels.user_order import morton_codes

from tests._torch_parity import CPU, adversarial_users, edge_tie_mask, ragged_cell_planes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _buckets(xs, ys, rect, G, block):
    """The engine's bucketing of ``xs, ys``: JAX's cell sort, then the
    port's in-run order.  ``(xs_s, ys_s, order, ranks, block, jax_bucket)``."""
    jb = jgr.prepare_cell_buckets(xs, ys, JRect(rect.xmin, rect.ymin, rect.xmax, rect.ymax), G,
                                  block=block)
    xs_s, ys_s, order, cell_map, nb = jb
    ranks = _t(np.searchsorted(np.unique(cell_map), cell_map).astype(np.int32))
    block = len(xs_s) // max(nb, 1)
    x, y, o = grid_raycast.order_cell_runs(_t(xs_s), _t(ys_s), _t(order), ranks, block, rect)
    return x, y, o, ranks, block, jb


def _inside(xs_s, ys_s, cell_map, planes):
    """``[Q, n_blocks, block, L]``: each row inside each lane of its block's
    cell, by the plain float32 evaluation (one rounding per operation)."""
    nb = cell_map.shape[0]
    block = xs_s.shape[0] // nb
    x = xs_s.reshape(nb, block)[None, :, :, None]
    y = ys_s.reshape(nb, block)[None, :, :, None]
    p = planes[:, cell_map.long()]  # [Q, NB, 3, 3, L]
    out = torch.ones((), dtype=torch.bool)
    for e in range(3):
        a, b, c = (p[:, :, e, j, None, :] for j in range(3))
        out = out & ((x * a + y * b) + c >= 0.0)
    return out


def blocked_count(xs_s, ys_s, cell_map, planes, lens, boxes):
    """``[Q, n_sorted]`` counts the way the kernel forms them: per (query,
    user block), over the lanes below the cell's length, the FULL lanes
    plus the TEST lanes that hold the row; a SKIP lane adds nothing
    whatever the row.  Also returns the classes and the plain inside."""
    classes = ref.grid_block_classes_ref(boxes, cell_map, planes)  # [Q, NB, L]
    inside = _inside(xs_s, ys_s, cell_map, planes)  # [Q, NB, B, L]
    walked = torch.arange(planes.shape[-1]) < lens[:, cell_map.long(), None]  # [Q, NB, L]
    cls = classes[:, :, None, :]
    hits = walked[:, :, None, :] & ((cls == ref.TILE_FULL) | ((cls == ref.TILE_TEST) & inside))
    return hits.sum(-1, dtype=torch.int32).reshape(planes.shape[0], -1), classes, inside


# ---- list lengths ------------------------------------------------------------


def test_cell_list_lengths_with_holes_and_empty_cells():
    deg = torch.tensor([0.0, 0.0, -1.0])
    planes = torch.zeros(2, 4, 3, 3, 6)
    planes[..., :, :] = deg[:, None]
    planes[0, 1, :, :, 2] = 1.0  # one triangle at lane 2, degenerate holes before it
    planes[0, 2, :, :, 5] = 0.5  # the last lane
    planes[1, 3, :, :, 0] = -2.0
    planes[1, 3, 1, :, 4] = torch.tensor([0.0, 0.0, -1.0])  # one edge degenerate: still a lane
    planes[1, 3, 0, :, 4] = torch.tensor([1.0, 0.0, 0.0])
    lens = grid_raycast.cell_list_lengths(planes)
    assert lens.dtype == torch.int32 and lens.tolist() == [[0, 3, 6, 0], [0, 0, 0, 5]]
    assert grid_raycast.cell_list_lengths(planes[1]).tolist() == [0, 0, 0, 5]
    assert grid_raycast.cell_list_lengths(torch.zeros(3, 3, 3, 0)).tolist() == [0, 0, 0]


@pytest.mark.parametrize("scenario", ["dense_facility", "large_k", "clustered"])
def test_list_lengths_are_the_lists_and_cut_no_count(scenario):
    """On the JAX package's packed planes (``lane_pad=1``, the port's form)
    of every strategy's grid, and of a refit grid with ``-1`` holes: the
    lengths are one past each cell's last listed slot, and the plain
    count over the lanes below them equals the count over all ``L``."""
    w = SCENARIOS[scenario].generate(0.01)
    U = w.users[:2000]
    rect = JRect.from_points(w.facilities, w.users)
    grids = []
    for i, strategy in enumerate(("none", "infzone")):
        sc = j_build_scene(w.facilities, w.qs[i], w.k, strategy=strategy, users_hint=w.users)
        g = jgrid.build_grid(sc.tris[: sc.n_tris], sc.coeffs[: sc.n_tris], rect, G=16)
        grids.append(g)
        if strategy == "none":  # refit: moved triangles leave -1 holes in place
            n = sc.n_tris
            moved = (sc.tris[:n] + 0.002).astype(np.float32)
            changed = np.arange(0, n, 3)
            tris, coeffs = sc.tris[:n].copy(), sc.coeffs[:n].copy()
            tris[changed] = moved[changed]
            coeffs[changed] = edge_coeffs(tris[changed].astype(np.float64)).astype(np.float32)
            refit = jgrid.refit_grid(g, sc.tris[:n], sc.coeffs[:n], tris, coeffs, changed)
            if refit is not None:
                assert ((refit.lists[:, :-1] < 0) & (refit.lists[:, 1:] >= 0)).any()  # holes
                grids.append(refit)
    for g in grids:
        planes = _t(jgr.pack_cell_coeff_planes(g, lane_pad=1))
        lens = grid_raycast.cell_list_lengths(planes)
        listed = g.lists >= 0
        want = np.where(listed.any(1), g.lists.shape[1] - np.argmax(listed[:, ::-1], axis=1), 0)
        np.testing.assert_array_equal(lens.numpy(), want)
        port_rect = Rect(rect.xmin, rect.ymin, rect.xmax, rect.ymax)
        xs_s, ys_s, _order, ranks, block, jb = _buckets(U[:, 0], U[:, 1], port_rect, 16, None)
        cells = _t(jb[3])
        full = ref.grid_cells_count_batch_ref(xs_s, ys_s, cells, planes[None])
        inside = _inside(xs_s, ys_s, cells, planes[None])
        walked = torch.arange(planes.shape[-1]) < lens[cells.long(), None]
        cut = (inside & walked[None, :, None, :]).sum(-1, dtype=torch.int32).reshape(1, -1)
        assert torch.equal(cut, full)


# ---- the in-cell order -------------------------------------------------------


@pytest.mark.parametrize("n,G,block", [(3000, 8, None), (3000, 8, 16), (700, 4, 256), (1, 4, 8),
                                       (257, 16, 8)])
def test_in_cell_order_is_a_permutation_inside_each_run(n, G, block):
    rng = np.random.default_rng(n + G)
    U = rng.random((n, 2)) * [3.0, 2.0] - [1.0, 0.5]
    rect = Rect(-1.0, -0.5, 2.0, 1.5)
    xs_s, ys_s, order, ranks, block, (jx, jy, jorder, jcells, nb) = _buckets(
        U[:, 0], U[:, 1], rect, G, block)
    assert xs_s.shape == (nb * block,) and order.dtype == torch.int64
    run = ranks.long().repeat_interleave(block).numpy()
    o = order.numpy()
    x32, y32 = U[:, 0].astype(np.float32), U[:, 1].astype(np.float32)
    code = morton_codes(torch.stack([xs_s, ys_s]), torch.tensor([[-1.0], [-0.5]]),
                        torch.tensor([[2.0], [1.5]])).numpy()
    for r in np.unique(run):
        rows = np.flatnonzero(run == r)
        real = o[rows] >= 0
        # the same users as the JAX bucketing's run, real rows first
        assert sorted(o[rows][real]) == sorted(jorder[rows][jorder[rows] >= 0])
        k = int(real.sum())
        assert real[:k].all() and not real[k:].any()
        # Morton order inside the run, padding rows on its last real user
        assert (np.diff(code[rows[:k]].astype(np.int64)) >= 0).all()
        assert (xs_s.numpy()[rows[k:]] == xs_s.numpy()[rows[k - 1]]).all()
        assert (ys_s.numpy()[rows[k:]] == ys_s.numpy()[rows[k - 1]]).all()
    real_rows = np.flatnonzero(o >= 0)
    np.testing.assert_array_equal(xs_s.numpy()[real_rows], x32[o[real_rows]])
    np.testing.assert_array_equal(ys_s.numpy()[real_rows], y32[o[real_rows]])
    # the unsort index gathers every user's row back
    index = grid_raycast.unsort_index(order, n)
    assert index.dtype == torch.int64 and torch.equal(order[index], torch.arange(n))
    # every block's box is the tight box of its rows
    boxes = grid_raycast.block_boxes(xs_s, ys_s, block)
    xb, yb = xs_s.reshape(nb, block), ys_s.reshape(nb, block)
    assert boxes.shape == (nb, 4) and boxes.dtype == torch.float32
    assert torch.equal(boxes, torch.stack([xb.amin(1), yb.amin(1), xb.amax(1), yb.amax(1)], 1))


def test_in_cell_order_shrinks_the_block_boxes():
    rng = np.random.default_rng(4)
    U = rng.random((20_000, 2))
    rect = Rect(0.0, 0.0, 1.0, 1.0)
    xs_s, ys_s, _o, _r, block, (jx, jy, *_rest) = _buckets(U[:, 0], U[:, 1], rect, 8, 64)
    pad = jx > 1e9  # JAX's rows, with its 2e9 filler replaced by a point in the cell
    jx, jy = np.where(pad, xs_s.numpy(), jx), np.where(pad, ys_s.numpy(), jy)

    def area(b):
        return float(((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).mean())

    ordered = area(grid_raycast.block_boxes(xs_s, ys_s, block))
    assert ordered < 0.5 * area(grid_raycast.block_boxes(_t(jx), _t(jy), block))
    assert grid_raycast.block_boxes(torch.zeros(0), torch.zeros(0), 8).shape == (0, 4)


# ---- the block classes -------------------------------------------------------


# (seed, users, G, block, queries, lanes, coordinate scale, offset, normal scale)
CASES = {
    "unit": (0, 900, 4, 16, 2, 24, 1.0, 0.0, 1.0),
    "block-8": (1, 600, 4, 8, 2, 16, 1.0, 0.0, 1.0),
    "one-user": (2, 1, 4, 8, 3, 12, 1.0, 0.0, 1.0),
    "auto-block": (3, 2000, 4, None, 1, 20, 1.0, 0.0, 1.0),
    "near-zero": (5, 700, 4, 16, 2, 20, 1e-3, 0.0, 1.0),
    "subnormal-products": (6, 600, 4, 16, 2, 20, 1e-21, 0.0, 1e-21),
    "near-1e4": (7, 800, 4, 32, 2, 20, 1.0, 1e4, 1.0),
    "1e4-wide": (8, 800, 8, 16, 1, 20, 1e4, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_classes_reproduce_the_plain_count_exactly(case):
    seed, n, G, block, q_n, lanes, scale, offset, coef_scale = CASES[case]
    xs, ys = adversarial_users(seed, n, scale=scale, offset=offset)
    m = 0.01 * scale  # the cells of a single user have a width too
    rect = Rect(float(xs.min()) - m, float(ys.min()) - m, float(xs.max()) + m, float(ys.max()) + m)
    xs_s, ys_s, _order, ranks, block, _jb = _buckets(xs, ys, rect, G, block)
    boxes = grid_raycast.block_boxes(xs_s, ys_s, block)
    b = boxes.numpy()
    ax = np.concatenate([xs, b[:, 0], b[:, 2], b[:, 0], b[:, 2]])
    ay = np.concatenate([ys, b[:, 1], b[:, 3], b[:, 3], b[:, 1]])
    n_cells = int(ranks.max()) + 1
    planes = _t(ragged_cell_planes(seed + 100, q_n, n_cells, lanes, ax, ay, coef_scale))
    lens = grid_raycast.cell_list_lengths(planes)
    got, classes, inside = blocked_count(xs_s, ys_s, ranks, planes, lens, boxes)
    want = ref.grid_cells_count_batch_ref(xs_s, ys_s, ranks, planes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # each class holds for every row of its block by the plain evaluation
    cls = classes[:, :, None, :].expand_as(inside)
    assert bool(inside[cls == ref.TILE_FULL].all()) and not bool(inside[cls == ref.TILE_SKIP].any())
    # the case exercises what it is meant to: every class, cut lists, and
    # users at an exact or near edge tie
    seen = set(torch.unique(classes).tolist())
    assert {ref.TILE_SKIP, ref.TILE_TEST} <= seen
    if n >= 40 and scale * coef_scale > 1e-30:
        assert ref.TILE_FULL in seen
    assert bool((lens < lanes).any()) and bool((lens == 0).any())
    tris = planes.permute(0, 1, 4, 2, 3).reshape(-1, 3, 3).numpy()
    assert edge_tie_mask(xs_s.numpy(), ys_s.numpy(), tris).any()


def test_plain_path_ignores_lens_and_boxes():
    rng = np.random.default_rng(12)
    U = rng.random((500, 2))
    rect = Rect(0.0, 0.0, 1.0, 1.0)
    xs_s, ys_s, _o, ranks, block, _jb = _buckets(U[:, 0], U[:, 1], rect, 4, 16)
    planes = _t(ragged_cell_planes(3, 2, int(ranks.max()) + 1, 9, U[:, 0], U[:, 1], 1.0))
    base = _t(rng.integers(0, 9, (2, planes.shape[1])).astype(np.int32))
    want = ops.grid_count_cells_batch(xs_s, ys_s, ranks, base, planes, block=block)
    lens = grid_raycast.cell_list_lengths(planes)
    boxes = grid_raycast.block_boxes(xs_s, ys_s, block)
    for args in ({"lens": lens, "boxes": boxes}, {"lens": torch.zeros_like(lens)}):
        assert torch.equal(ops.grid_count_cells_batch(xs_s, ys_s, ranks, base, planes, block=block,
                                                      **args), want)
    one = ops.grid_count_cells(xs_s, ys_s, ranks, base[1], planes[1], block=block, lens=lens[1],
                               boxes=boxes)
    assert torch.equal(one, want[1])


# ---- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["none", "infzone"])
def test_grid_pallas_engines_on_the_cpu_equal_the_jax_grid_counts(strategy):
    rng = np.random.default_rng(7)
    F, U = rng.random((120, 2)), rng.random((3000, 2))
    qs = [0, 5, 17, 40]
    want = JEngine(F, U, JConfig(backend="grid", strategy=strategy, grid_g=16)).query_batch(qs, 6)
    t = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas-ref", strategy=strategy, grid_g=16),
                   device=CPU)
    dense = t.query_batch(qs, 6, backend="dense-ref")
    for name in ("grid-pallas-ref", "grid-pallas"):
        got = t.query_batch(qs, 6, backend=name)
        np.testing.assert_array_equal(got.counts, dense.counts, err_msg=name)
        for i, sc in enumerate(got.scenes):
            ok = ~edge_tie_mask(U[:, 0].astype(np.float32), U[:, 1].astype(np.float32),
                                sc.coeffs[: sc.n_tris])
            np.testing.assert_array_equal(got.counts[i][ok], want.counts[i][ok])
            np.testing.assert_array_equal(got.masks[i][ok], want.masks[i][ok])
    (_req, (buckets, _base, planes, lens), _sc), = [
        v for k, v in t._snap.batch_cache._store.items() if k[0] == "grid-pallas"]
    assert torch.equal(lens, grid_raycast.cell_list_lengths(planes))
    assert torch.equal(buckets.boxes, grid_raycast.block_boxes(buckets.xs_s, buckets.ys_s,
                                                               buckets.block))
