"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere
(marker ``cuda``).  This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ray-cast, grid and BVH counts bit-identical (kernels and plain
versions share one rounding contract, and the ray-cast kernel's tile
classes are exact); rank counts equal on users with no near-tie
competitor and within ±1 on the rest.  The adversarial ray-cast inputs
come from ``tests/_torch_parity.py``, which imports no JAX either.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.scene import build_scene
from repro_torch.core import bvh as tbvh
from repro_torch.kernels import build, bvh, grid_raycast, ops, rank_count, raycast, ref
from repro_torch.kernels.user_order import build_user_order

from _torch_parity import (
    adversarial_coeffs,
    adversarial_rank_inputs,
    adversarial_users,
    chain_tree,
    ragged_cell_planes,
    warp_walk_twin,
)

pytestmark = pytest.mark.cuda

RECT = Rect(0.0, 0.0, 1.0, 1.0)
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip: the kernels need CUDA and nvcc.  (Kept in this
    file, not imported from ``tests``: a machine with only the port's
    dependencies may have another top-level package of that name.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def non_tie_mask(U, F, q_row, eps=1e-6):
    """Users with no competitor at a near-tie distance to ``F[q_row]``
    (the rule of ``tests/_torch_parity.py``)."""
    comp = np.delete(F, q_row, axis=0)
    d2 = np.sum((U[:, None, :] - comp[None, :, :]) ** 2, axis=-1)
    d2q = np.sum((U - F[q_row]) ** 2, axis=1)
    return ~np.any(np.abs(d2 - d2q[:, None]) < eps * (1.0 + d2q[:, None]), axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_users", [1, 255, 257, 100_000])
def test_raycast_kernel_matches_plain_on_card(cuda_device, n_users):
    rng = np.random.default_rng(n_users)
    F = rng.random((300, 2))
    coeffs = np.stack([build_scene(F, qi, 8, RECT, pad_to=384).coeffs for qi in range(5)])
    U = _t(rng.random((n_users, 2)).astype(np.float32)).to(cuda_device)
    xs, ys = U[:, 0].contiguous(), U[:, 1].contiguous()
    cf = _t(coeffs).to(cuda_device)
    got = ops.raycast_count_batch(xs, ys, cf)
    assert torch.equal(got, ops.raycast_count_batch(xs, ys, cf, backend="ref"))
    assert torch.equal(got.cpu(), ops.raycast_count_batch(xs.cpu(), ys.cpu(), cf.cpu()))
    assert torch.equal(ops.raycast_count(xs, ys, cf[2]), got[2])


def test_raycast_kernel_empty_batch_launches_nothing(cuda_device):
    xs = torch.rand(10, device=cuda_device)
    before = raycast.batch_launches
    out = ops.raycast_count_batch(xs, xs, torch.zeros(0, 4, 3, 3, device=cuda_device))
    assert out.shape == (0, 10) and raycast.batch_launches == before


# (coordinate scale, offset, normal scale): unit square, near 0, products
# among the subnormals, near 1e4
SCALES = [(1.0, 0.0, 1.0), (1e-3, 0.0, 1.0), (1e-21, 0.0, 1e-21), (1.0, 1e4, 1.0)]


@pytest.mark.parametrize("n_users", [1, 1023, 1025, 20_000])
@pytest.mark.parametrize("mp", [1, 7, 128, 300])
@pytest.mark.parametrize("q_n", [1, 3, 64])
def test_raycast_tiles_kernel_matches_plain_on_adversarial_inputs(cuda_device, q_n, mp, n_users):
    for i, (scale, offset, coef_scale) in enumerate(SCALES):
        seed = n_users * 7 + mp * 3 + q_n + i
        xs, ys = adversarial_users(seed, n_users, scale=scale, offset=offset)
        xs_d, ys_d = _t(xs).to(cuda_device), _t(ys).to(cuda_device)
        order = build_user_order(xs_d, ys_d)
        b = order.boxes.cpu().numpy()
        anchors = (np.concatenate([xs, b[:, 0], b[:, 2], b[:, 0], b[:, 2]]),
                   np.concatenate([ys, b[:, 1], b[:, 3], b[:, 3], b[:, 1]]))
        cf = _t(adversarial_coeffs(seed, q_n, mp, *anchors, coef_scale=coef_scale)).to(cuda_device)
        got = ops.raycast_count_batch(xs_d, ys_d, cf, order=order)
        want = ops.raycast_count_batch(xs_d, ys_d, cf, backend="ref")
        assert got.shape == (q_n, n_users) and torch.equal(got, want), (scale, offset)
        assert torch.equal(ops.raycast_count_batch(xs_d, ys_d, cf), got)  # order built inside
        assert torch.equal(ops.raycast_count(xs_d, ys_d, cf[-1], order=order), got[-1])
        in_tiles, _, launched = raycast._launch_sorted(xs_d, ys_d, cf, order)
        assert launched == 1 and torch.equal(in_tiles, got[:, order.perm.long()])


def test_raycast_kernel_refuses_an_order_of_another_shape(cuda_device):
    xs = torch.rand(3000, device=cuda_device)
    cf = torch.zeros(1, 4, 3, 3, device=cuda_device)
    order = build_user_order(xs, xs)
    with pytest.raises(ValueError, match="order.boxes"):
        ops.raycast_count_batch(xs, xs, cf, order=order._replace(boxes=order.boxes[:-1]))
    with pytest.raises(ValueError, match="order.xs_s"):
        ops.raycast_count_batch(xs, xs, cf, order=build_user_order(xs[:10], xs[:10]))


def test_dense_engine_keeps_one_user_order_per_snapshot_on_card(cuda_device):
    rng = np.random.default_rng(8)
    F, U = rng.random((60, 2)), rng.random((5000, 2))
    eng = RkNNEngine(F, U, backend="dense", device=cuda_device)
    before = raycast.batch_launches, raycast.single_launches
    a = eng.query_batch([1, 2, 3], 5)
    one = eng.query(4, 5)
    eng.query_batch([5, 6], 5)
    keys = [k for k in eng._snap.kernel_memo._store if k[0] == "user-order"]
    assert len(keys) == 1 and eng._snap.kernel_memo.get(keys[0])[0] is eng.xs
    assert (raycast.batch_launches - before[0], raycast.single_launches - before[1]) == (2, 1)
    cpu = RkNNEngine(F, U, backend="dense", device=CPU)
    np.testing.assert_array_equal(a.counts, cpu.query_batch([1, 2, 3], 5).counts)
    np.testing.assert_array_equal(one.counts, cpu.query(4, 5).counts)


def test_rank_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(1)
    U, F = rng.random((50_000, 2)), rng.random((700, 2))
    got = ops.rank_count(_t(U).to(cuda_device), _t(F).to(cuda_device), _t(F[5]).to(cuda_device),
                         exclude=5).cpu().numpy()
    want = ops.rank_count(_t(U), _t(F), _t(F[5]), exclude=5).numpy()
    ok = non_tie_mask(U, F, 5)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert np.all(np.abs(got - want) <= 1)


# (coordinate scale, offset): unit square, squares among the subnormals,
# near 1e4
RANK_SCALES = [(1.0, 0.0), (1e-20, 0.0), (1e3, 1e4)]


@pytest.mark.parametrize("n_users", [1, 255, 257, 1025, 20_000])
@pytest.mark.parametrize("q_n", [1, 5])
def test_rank_tiles_kernel_matches_plain_bit_for_bit(cuda_device, q_n, n_users):
    """The classified kernel equals its plain version on the card bit for
    bit (one rounding contract, exact classes), ties and the excluded rows
    included; the batch rows equal single launches, and every cut of the
    facilities into splits (atomic adds) gives the same counts."""
    for i, (scale, offset) in enumerate(RANK_SCALES):
        seed = n_users * 5 + q_n + i
        U, F, Q, excl = adversarial_rank_inputs(seed, n_users, 64, max(q_n, 2),
                                                scale=scale, offset=offset)
        Q, excl = Q[:q_n], excl[:q_n]
        U_d, F_d, Q_d = (_t(a).to(cuda_device) for a in (U, F, Q))
        xs, ys = U_d[:, 0].contiguous(), U_d[:, 1].contiguous()
        order = build_user_order(xs, ys)
        got = ops.rank_count_batch(U_d, F_d, Q_d, exclude=excl, order=order)
        want = ops.rank_count_batch(U_d, F_d, Q_d, exclude=excl, backend="ref")
        assert got.shape == (q_n, n_users) and torch.equal(got, want), (scale, offset)
        assert torch.equal(got.cpu(), ops.rank_count_batch(_t(U), _t(F), _t(Q), exclude=excl))
        # the order built inside
        assert torch.equal(ops.rank_count_batch(U_d, F_d, Q_d, exclude=excl), got)
        # the users as the engine keeps them, without the [N, 2] stack
        assert torch.equal(ops.rank_count_batch_xy(xs, ys, F_d, Q_d, exclude=excl, order=order), got)
        for q in range(q_n):
            one = ops.rank_count(U_d, F_d, Q_d[q], exclude=excl[q], order=order)
            assert torch.equal(one, got[q])
            plain = ops.rank_count(U_d, F_d, Q_d[q], exclude=excl[q], backend="ref")
            assert torch.equal(one, plain)
        excl_d = torch.tensor([-1 if e is None else e for e in excl], dtype=torch.int32,
                              device=cuda_device)
        for per_split in (32, 64, 96):  # two splits of the 64 facilities, then one
            split, launched = rank_count._launch(xs, ys, F_d, Q_d, excl_d, order, per_split)
            assert launched == 1 and torch.equal(split, got)


def test_rank_kernel_counts_launches_and_refuses_bad_orders(cuda_device):
    xs = torch.rand(3000, device=cuda_device)
    F = torch.rand(40, 2, device=cuda_device)
    before = rank_count.launches, rank_count.batch_launches
    ops.rank_count(torch.stack([xs, xs], 1), F, F[0], exclude=0)
    ops.rank_count_batch(torch.stack([xs, xs], 1), F, F[:3], exclude=[0, 1, None])
    out = ops.rank_count_batch(torch.stack([xs, xs], 1), F, F[:0])
    assert out.shape == (0, 3000)
    assert (rank_count.launches - before[0], rank_count.batch_launches - before[1]) == (1, 1)
    order = build_user_order(xs, xs)
    with pytest.raises(ValueError, match="order.xs_s"):
        ops.rank_count(torch.stack([xs, xs], 1), F, F[0], order=build_user_order(xs[:9], xs[:9]))
    with pytest.raises(ValueError, match="order.perm"):
        ops.rank_count_batch(torch.stack([xs, xs], 1), F, F[:2],
                             order=order._replace(perm=order.perm[1:]))


def test_brute_engine_shares_the_dense_user_order_on_card(cuda_device):
    """The brute backend's batch launches the rank kernel once over the
    order the dense backend keeps in the snapshot memo (one entry for
    both), and equals the engine on the CPU."""
    rng = np.random.default_rng(9)
    F, U = rng.random((60, 2)), rng.random((5000, 2))
    eng = RkNNEngine(F, U, backend="dense", device=cuda_device)
    eng.query_batch([1, 2], 5)
    before = rank_count.batch_launches
    got = eng.query_batch([1, 2, 3, np.array([0.4, 0.6])], 5, backend="brute")
    assert rank_count.batch_launches - before == 1
    keys = [k for k in eng._snap.kernel_memo._store if k[0] == "user-order"]
    assert len(keys) == 1
    cpu = RkNNEngine(F, U, backend="brute", device=CPU).query_batch(
        [1, 2, 3, np.array([0.4, 0.6])], 5)
    np.testing.assert_array_equal(got.counts, cpu.counts)


def _cells(rng, n_blocks, block, lanes, q_n, n_cells=5):
    """Ragged bucketed inputs: users in the unit square with a few padding
    rows at 2e9, random cells, random edge planes (some lanes degenerate)
    and random ``base`` counts."""
    n = n_blocks * block
    xs = rng.random(n).astype(np.float32)
    ys = rng.random(n).astype(np.float32)
    xs[::7] = ys[::7] = np.float32(2e9)
    cell_map = rng.integers(0, n_cells, n_blocks).astype(np.int32)
    planes = rng.normal(size=(q_n, n_cells, 3, 3, lanes)).astype(np.float32)
    planes[..., lanes // 2 :: 3] = np.array([0.0, 0.0, -1.0], np.float32)[None, None, None, :, None]
    base = rng.integers(0, 20, (q_n, n_cells)).astype(np.int32)
    return xs, ys, cell_map, planes, base


@pytest.mark.parametrize("q_n", [1, 3])
@pytest.mark.parametrize("lanes", [1, 7, 300])
@pytest.mark.parametrize("block", [8, 128, 256])
def test_grid_kernel_matches_plain_on_card(cuda_device, block, lanes, q_n):
    rng = np.random.default_rng(block * 1000 + lanes * 10 + q_n)
    xs, ys, cm, planes, base = (_t(a).to(cuda_device) for a in _cells(rng, 37, block, lanes, q_n))
    lens = grid_raycast.cell_list_lengths(planes)
    boxes = grid_raycast.block_boxes(xs, ys, block)
    kw = {"block": block, "lens": lens, "boxes": boxes}
    got = grid_raycast.grid_raycast_cells_batch(xs, ys, cm, planes, **kw)
    want = ref.grid_cells_count_batch_ref(xs, ys, cm, planes)
    assert got.shape == (q_n, 37 * block) and torch.equal(got, want)
    with_base = grid_raycast.grid_raycast_cells_batch(xs, ys, cm, planes, base=base, **kw)
    want_base = want + base[:, cm.long().repeat_interleave(block)]
    assert torch.equal(with_base, want_base)
    assert torch.equal(ops.grid_count_cells_batch(xs, ys, cm, base, planes, **kw), want_base)
    # without lens and boxes the wrapper computes them on the card
    assert torch.equal(ops.grid_count_cells_batch(xs, ys, cm, base, planes, block=block), want_base)
    assert torch.equal(
        ops.grid_count_cells_batch(xs, ys, cm, base, planes, block=block, backend="ref"), want_base
    )
    single = grid_raycast.grid_raycast_cells(xs, ys, cm, base[0], planes[0], block=block,
                                             lens=lens[0], boxes=boxes)
    assert torch.equal(single, want_base[0])
    assert torch.equal(ops.grid_count_cells(xs, ys, cm, base[0], planes[0], block=block), single)
    # the engine's layout: clustered users in Morton order inside each cell
    # run (padding rows on their run's last user), adversarial triangles
    # through users and block corners, lists cut below L with holes
    for i, (scale, offset, coef_scale) in enumerate(SCALES):
        seed = block * 100 + lanes * 10 + q_n + i
        ux, uy = adversarial_users(seed, 40 * block, scale=scale, offset=offset)
        m = 0.01 * scale
        rect = Rect(float(ux.min()) - m, float(uy.min()) - m, float(ux.max()) + m, float(uy.max()) + m)
        xs_s, ys_s, order, cell_map, nb = grid_raycast.prepare_cell_buckets(ux, uy, rect, 4,
                                                                           block=block)
        ranks = _t(np.searchsorted(np.unique(cell_map), cell_map).astype(np.int32)).to(cuda_device)
        xs_s, ys_s, order = grid_raycast.order_cell_runs(
            _t(xs_s).to(cuda_device), _t(ys_s).to(cuda_device), _t(order).to(cuda_device),
            ranks, block, rect)
        bx = grid_raycast.block_boxes(xs_s, ys_s, block)
        b = bx.cpu().numpy()
        anchors = (np.concatenate([ux, b[:, 0], b[:, 2], b[:, 0], b[:, 2]]),
                   np.concatenate([uy, b[:, 1], b[:, 3], b[:, 3], b[:, 1]]))
        pl = _t(ragged_cell_planes(seed, q_n, int(ranks.max()) + 1, lanes, *anchors,
                                   coef_scale)).to(cuda_device)
        ln = grid_raycast.cell_list_lengths(pl)
        got = grid_raycast.grid_raycast_cells_batch(xs_s, ys_s, ranks, pl, block=block, lens=ln,
                                                    boxes=bx)
        want = ref.grid_cells_count_batch_ref(xs_s, ys_s, ranks, pl)
        assert torch.equal(got, want), (scale, offset)
        assert bool((ln < lanes).any()) or lanes == 1


def test_grid_kernel_empty_launches_nothing_and_refuses_cpu(cuda_device):
    rng = np.random.default_rng(0)
    xs, ys, cm, planes, base = (_t(a).to(cuda_device) for a in _cells(rng, 4, 8, 3, 2))
    lens = grid_raycast.cell_list_lengths(planes)
    boxes = grid_raycast.block_boxes(xs, ys, 8)
    before = grid_raycast.batch_launches
    none = ops.grid_count_cells_batch(xs[:0], ys[:0], cm[:0], base, planes, block=8)
    no_q = grid_raycast.grid_raycast_cells_batch(xs, ys, cm, planes[:0], block=8, lens=lens[:0],
                                                 boxes=boxes)
    assert none.shape == (2, 0) and no_q.shape == (0, 32)
    assert grid_raycast.batch_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        grid_raycast.grid_raycast_cells_batch(xs.cpu(), ys.cpu(), cm.cpu(), planes.cpu(), block=8,
                                              lens=lens.cpu(), boxes=boxes.cpu())
    kw = {"block": 8, "lens": lens, "boxes": boxes}
    with pytest.raises(ValueError, match="contiguous"):
        grid_raycast.grid_raycast_cells_batch(xs, ys, cm.long(), planes, **kw)
    for bad in ({"lens": lens[:, 1:]}, {"lens": lens.long()}, {"lens": lens.cpu()},
                {"boxes": boxes[:-1]}, {"boxes": boxes.double()}, {"boxes": boxes[:, :3]}):
        with pytest.raises(ValueError, match="lens|boxes"):
            grid_raycast.grid_raycast_cells_batch(xs, ys, cm, planes, **{**kw, **bad})
    with pytest.raises(ValueError, match="lens"):
        grid_raycast.grid_raycast_cells(xs, ys, cm, base[0], planes[0], block=8, lens=lens,
                                        boxes=boxes)
    assert {"raycast", "rank_count", "grid_raycast"} <= set(build.build())


@pytest.mark.parametrize(
    "backend", ["dense", "dense-ref", "grid", "grid-pallas", "grid-pallas-ref", "bvh", "brute"]
)
def test_engine_on_card_matches_engine_on_cpu(cuda_device, backend):
    rng = np.random.default_rng(3)
    F, U = rng.random((80, 2)), rng.random((3000, 2))
    qs = [int(q) for q in rng.integers(0, len(F), 5)] + [np.array([0.4, 0.6])]
    a = RkNNEngine(F, U, backend=backend, device=cuda_device).query_batch(qs, 6)
    b = RkNNEngine(F, U, backend=backend, device=CPU).query_batch(qs, 6)
    np.testing.assert_array_equal(a.masks, b.masks)
    if backend != "brute":
        np.testing.assert_array_equal(a.counts, b.counts)


def _bvh_batch(seed, q_n, m, n, *, refit=False, empty_rows=()):
    """Adversarial users (``adversarial_users``) and per-query trees whose
    triangles have users as vertices, so box edges fall exactly on users,
    with adversarial edge functions (``adversarial_coeffs``) anchored on
    the users.  ``refit``: each tree refit to its triangles moved a little;
    ``empty_rows``: queries whose scene is empty.  Returns host arrays
    ``(xs, ys, left, right, bbox, coeffs)``."""
    rng = np.random.default_rng(seed)
    xs, ys = adversarial_users(seed, n)
    coeffs = adversarial_coeffs(seed, q_n, m, xs, ys)
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    bvhs, cfs = [], []
    for q in range(q_n):
        if q in empty_rows:
            bvhs.append(tbvh.build_bvh(np.zeros((0, 3, 2))))
            cfs.append(np.zeros((0, 3, 3), np.float32))
            continue
        tris = pts[rng.integers(0, n, (m, 3))]
        tree = tbvh.build_bvh(tris)
        if refit:
            moved = tree if (r := tbvh.refit_bvh(
                tree, tris + rng.normal(0.0, 1e-3, tris.shape), max_growth=1e9)) is None else r
            tree = moved
        bvhs.append(tree)
        cfs.append(coeffs[q])
    return (xs, ys, *tbvh.stack_bvhs(bvhs, cfs))


@pytest.mark.parametrize("k", [None, 1, 3, 1000])
@pytest.mark.parametrize("q_n,m,n", [(1, 1, 1), (1, 7, 129), (3, 40, 5000), (64, 120, 20_000)])
def test_bvh_kernel_matches_plain_bit_for_bit(cuda_device, q_n, m, n, k):
    xs, ys, *tree = _bvh_batch(q_n * 7 + m, q_n, m, n, empty_rows=(1,) if q_n > 1 else ())
    d = [_t(a).to(cuda_device) for a in (xs, ys, *tree)]
    before = bvh.batch_launches
    got = ops.bvh_count_batch(*d, k=k)
    assert bvh.batch_launches == before + 1
    want = ops.bvh_count_batch(*d, k=k, backend="ref")
    cpu = ops.bvh_count_batch(*(_t(a) for a in (xs, ys, *tree)), k=k)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (q_n, n)
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    if q_n > 1:
        assert int(got[1].abs().sum()) == 0  # the empty scene


@pytest.mark.parametrize("k", [None, 2])
def test_bvh_kernel_on_refit_trees_and_single_query(cuda_device, k):
    xs, ys, *tree = _bvh_batch(5, 4, 60, 3000, refit=True)
    d = [_t(a).to(cuda_device) for a in (xs, ys, *tree)]
    got = ops.bvh_count_batch(*d, k=k)
    assert torch.equal(got, ops.bvh_count_batch(*d, k=k, backend="ref"))
    before = bvh.launches
    for q in range(4):  # every query has all 60 rows: no padding to drop
        one = ops.bvh_count(d[0], d[1], d[2][q], d[3][q], d[4][q], d[5][q], k=k)
        assert torch.equal(one, got[q])
        assert torch.equal(one, ops.bvh_count(d[0], d[1], d[2][q], d[3][q], d[4][q], d[5][q],
                                              k=k, backend="ref"))
    assert bvh.launches == before + 4


def test_bvh_kernel_pops_output_and_empty_shapes(cuda_device):
    xs, ys, left, right, bbox, coeffs = (
        _t(a).to(cuda_device) for a in _bvh_batch(9, 5, 80, 4000))
    batch = bvh.bvh_batch(left, right, bbox, coeffs, cuda_device)
    out, pops, _steps, launched = bvh._launch(xs, ys, batch, 4, None, with_pops=True)
    torch.cuda.synchronize()
    assert launched == 1 and torch.equal(out, ops.bvh_count_batch(xs, ys, left, right, bbox,
                                                                  coeffs, k=4))
    assert pops.shape == (2, 5, len(xs))
    inner, leaves = pops[0], pops[1]
    assert int(pops.min()) >= 0 and int((inner + leaves).min()) >= 1
    assert int((inner + leaves).max()) <= left.shape[1]
    assert bool((leaves >= out).all())  # every hit is a leaf the lane popped
    before = bvh.batch_launches
    assert ops.bvh_count_batch(xs, ys, left[:0], right[:0], bbox[:0], coeffs[:0],
                               k=4).shape == (0, len(xs))
    assert ops.bvh_count_batch(xs[:0], ys[:0], left, right, bbox, coeffs, k=4).shape == (5, 0)
    assert bvh.batch_launches == before


def test_bvh_kernel_refuses_deep_trees_and_bad_arguments(cuda_device):
    xs, ys, left, right, bbox, coeffs = (
        _t(a).to(cuda_device) for a in _bvh_batch(11, 2, 30, 500))
    batch = bvh.bvh_batch(left, right, bbox, coeffs, cuda_device)
    n_int = bvh.MAX_STACK  # a path of MAX_STACK + 1 levels
    chain_l = np.array([i + 1 for i in range(n_int - 1)] + [2 * n_int]
                       + [-(i + 1) for i in range(n_int + 1)], np.int32)
    chain_r = np.array([n_int + i for i in range(n_int)] + [-1] * (n_int + 1), np.int32)
    box = np.tile(np.array([-9.0, -9.0, 9.0, 9.0], np.float32), (len(chain_l), 1))
    cf = np.tile(np.array([[0.0, 0.0, 1.0]] * 3, np.float32), (n_int + 1, 1, 1))
    chain = [_t(a).to(cuda_device) for a in (chain_l, chain_r, box, cf)]
    with pytest.raises(ValueError, match="stack"):
        ops.bvh_count(xs, ys, *chain)
    with pytest.raises(ValueError, match="stack"):
        bvh.bvh_batch(*(a[None] for a in chain), cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        bvh.bvh_count_batch_kernel_call(xs.cpu(), ys.cpu(), batch, 3)
    with pytest.raises(ValueError, match="float32"):
        bvh.bvh_count_batch_kernel_call(xs.double(), ys, batch, 3)
    with pytest.raises(ValueError, match="trees"):
        bvh.bvh_count_batch_kernel_call(xs, ys, bvh.bvh_batch(left, right, bbox, coeffs, CPU), 3)
    with pytest.raises(ValueError, match="bbox"):
        bvh.bvh_batch(left, right, bbox[:, :-1], coeffs, cuda_device)
    with pytest.raises(ValueError, match="coeffs"):
        bvh.bvh_batch(left, right, bbox, coeffs[:1], cuda_device)
    with pytest.raises(ValueError, match="one tree"):
        bvh.bvh_count_kernel_call(xs, ys, batch, 3)
    with pytest.raises(ValueError, match="k_cap"):
        bvh.bvh_count_batch_kernel_call(xs, ys, batch, -1)
    # int64 ids and a box table 4 bytes off 16 are converted, not refused
    shifted = torch.empty(bbox.numel() + 1, device=cuda_device)[1:].view(bbox.shape)
    shifted.copy_(bbox)
    moved = bvh.bvh_batch(left.long(), right, shifted, coeffs, cuda_device)
    assert moved.bbox.data_ptr() % 16 == 0
    # the node arrays stay on the host; only the kernel's records go to the card
    assert moved.left.device.type == moved.bbox.device.type == "cpu"
    assert all(t.device == xs.device and t.data_ptr() % 16 == 0
               for t in (moved.nodes, moved.tris, moved.root))
    assert torch.equal(bvh.bvh_count_batch_kernel_call(xs, ys, moved, 3),
                       bvh.bvh_count_batch_kernel_call(xs, ys, batch, 3))
    assert "bvh_traverse" in build.build()


def _walk_checks(xs, ys, batch, k, order=None):
    """The serving kernel and its counting instance against the plain walk
    (counts and pops, bit for bit) and the numpy twin of the warp walk
    over spans of 32 * USERS_PER_LANE users (steps per warp); returns the
    counts."""
    k_cap = ops._bvh_k_cap(k, batch.coeffs.shape[1])
    if order is None:
        order = build_user_order(xs, ys)
    got = bvh.bvh_count_batch_kernel_call(xs, ys, batch, k_cap, order)
    want, want_pops = ops.bvh_count_stacked(xs, ys, batch, k=k, backend="ref", pops=True)
    stats = bvh.walk_stats(xs, ys, batch, k_cap, order)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(stats.counts, want)
    assert torch.equal(stats.pops, want_pops)
    perm = order.perm.long().cpu().numpy()
    twin = warp_walk_twin(order.xs_s.cpu().numpy(), order.ys_s.cpu().numpy(),
                          batch.nodes.cpu().numpy(), batch.tris.cpu().numpy(),
                          batch.root.cpu().numpy(), k_cap, warp=32 * bvh.USERS_PER_LANE)
    np.testing.assert_array_equal(twin[0], want.cpu().numpy()[:, perm])
    np.testing.assert_array_equal(stats.steps.cpu().numpy(), twin[2])
    return got


@pytest.mark.parametrize("k", [0, 1, 3, None, 1000])
@pytest.mark.parametrize("q_n,m,n", [(1, 1, 1), (2, 7, 33), (3, 40, 1001), (4, 90, 2001)])
def test_bvh_warp_walk_pops_and_steps_equal_the_plain_walk(cuda_device, q_n, m, n, k):
    """N not a multiple of 32 (ragged last warps), k = 0, and k above every
    count (1000 and None): counts and pops of every lane equal the plain
    walk's, and the steps of every warp the twin's."""
    xs, ys, *tree = _bvh_batch(q_n * 11 + m, q_n, m, n, empty_rows=(1,) if q_n > 1 else ())
    d = [_t(a).to(cuda_device) for a in (xs, ys, *tree)]
    batch = bvh.bvh_batch(*d[2:], cuda_device)
    got = _walk_checks(d[0], d[1], batch, k)
    if k == 0:
        assert int(got.abs().sum()) == 0


@pytest.mark.parametrize("leaf_side", ["left", "right"])
@pytest.mark.parametrize("depth", [33, 34, 64])
def test_bvh_warp_walk_on_deep_chains(cuda_device, depth, leaf_side):
    """Paths of depth 33, 34 and 64 (the deepest tree the kernel takes):
    with the leaves on the left the stack reaches depth - 1 entries, from
    depth 34 on into the second register slot; depth 65 is refused."""
    left, right, bbox = chain_tree(depth, leaf_side=leaf_side)
    cf = np.tile(np.array([[0.0, 0.0, 1.0]] * 3, np.float32), (depth, 1, 1))
    cf[::3, 0] = (0.0, 0.0, -1.0)  # every third triangle holds no user
    xs, ys = adversarial_users(depth, 777)
    d = [_t(a).to(cuda_device) for a in (xs, ys)]
    batch = bvh.bvh_batch(*(_t(a)[None] for a in (left, right, bbox, cf)), cuda_device)
    assert batch.depth == depth
    for k in (0, 5, depth - depth // 3, None):
        _walk_checks(d[0], d[1], batch, k)
    deeper = chain_tree(bvh.MAX_STACK + 1, leaf_side=leaf_side)
    with pytest.raises(ValueError, match="stack"):
        bvh.bvh_batch(*(_t(a)[None] for a in (*deeper, cf)), cuda_device)


# ---------------------------------------------------------------- planner
@pytest.fixture
def planner_state():
    """Restore the port's active profile (the planner's process-wide state)."""
    from repro_torch.planner import profiles

    prev = profiles.get_active_profile()
    yield profiles
    profiles.set_active_profile(prev)


@pytest.mark.parametrize("profile", ["committed", "builtin"])
def test_auto_on_card_matches_cpu_masks_without_plain_calls(cuda_device, planner_state,
                                                            monkeypatch, profile):
    """``auto`` on the card, under the committed profile of this runner class
    (loaded strictly) or the built-in prior: the same masks as on the CPU
    and as the brute oracle, through ``query_batch``, ``query``, ``stream``,
    ``query_mono`` and a single ``brute`` query (row 5's kernel), with no
    plain twin dispatched.  The only plain PyTorch that ``auto`` may run on
    the card is the ``grid`` backend's count, which has no kernel in either
    package; a batch forced over the four kernel backends runs none."""
    from repro_torch.core import RkNNConfig, get_backend
    from repro_torch.core.brute import rknn_brute_np, rknn_mono_brute_np
    from repro_torch.planner.backend import PlannerBackend

    if profile == "committed":
        prof = planner_state.load_runner_profile(planner_state.PROFILE_STORE)
        assert prof is not None, "no committed profile for this card"
        planner_state.set_active_profile(prof)
    else:
        planner_state.set_active_profile(None)
    rng = np.random.default_rng(19)
    F, U = rng.random((80, 2)), rng.random((3_000, 2))
    qs = [int(q) for q in rng.integers(0, len(F), 6)] + [np.array([0.4, 0.6])]
    k = 4
    card = RkNNEngine(F, U, RkNNConfig(backend="auto"), device=cuda_device)
    # the CPU's masks first: the CPU runs the plain versions, counted in ref.calls
    host = RkNNEngine(F, U, RkNNConfig(backend="auto"), device=CPU).query_batch(qs, k)
    ref.calls = 0
    rank_count.launches = rank_count.batch_launches = 0
    got = card.query_batch(qs, k)
    np.testing.assert_array_equal(got.masks, host.masks)
    for i, q in enumerate(qs):
        np.testing.assert_array_equal(got.masks[i], rknn_brute_np(U, F, q, k))
    one = card.query(qs[0], k)
    np.testing.assert_array_equal(one.mask, got.masks[0])
    streamed = [m for _, m in card.stream([qs[:3], qs[3:]], k)]
    np.testing.assert_array_equal(np.concatenate(streamed), got.masks)
    mono = card.query_mono(5, k)
    np.testing.assert_array_equal(mono.mask, rknn_mono_brute_np(F, 5, k))
    brute_one = card.query(qs[1], k, backend="brute")
    np.testing.assert_array_equal(brute_one.mask, got.masks[1])
    assert rank_count.launches + rank_count.batch_launches >= 1
    torch.cuda.synchronize(cuda_device)
    plans = card.explain() + card._snap._mono.explain()
    dispatched = {b for p in plans for b in p.get("decisions", {})}
    assert not [b for b in dispatched if get_backend(b).plain_twin_of]
    if "grid" not in dispatched:
        assert ref.calls == 0
    assert "dense-ref" not in get_backend("auto").candidates(device=cuda_device)

    rotation = ("dense", "grid-pallas", "bvh", "brute")
    planner_state.set_active_profile(None)  # a new epoch: no memoized plan
    monkeypatch.setattr(PlannerBackend, "rank",
                        lambda self, shape, candidates=None: [("dense", 1.0)])
    monkeypatch.setattr(PlannerBackend, "assign_batch",
                        lambda self, shapes, candidates=None: [
                            (rotation[i % 4], 1.0) for i in range(len(shapes))])
    ref.calls = 0
    mixed = card.query_batch(qs, k)
    np.testing.assert_array_equal(mixed.masks, got.masks)
    assert set(card.explain()[-1]["groups"]) == set(rotation)
    torch.cuda.synchronize(cuda_device)
    assert ref.calls == 0


def test_calibrate_on_card_names_the_card_and_skips_plain_twins(cuda_device, planner_state):
    from repro_torch.core.backends import timeable_backends
    from repro_torch.planner.calibrate import calibrate
    from repro_torch.planner.models import WorkloadShape
    from repro_torch.workloads import Scenario

    tiny = [
        Scenario("cal_a", 25, 300, 3, 2, seed=1),
        Scenario("cal_b", 60, 600, 6, 4, distribution="uniform", seed=2),
        Scenario("cal_c", 120, 400, 4, 1, distribution="clustered", seed=3),
    ]
    prof = calibrate(scenarios=tiny, repeats=1, device=cuda_device)
    assert set(prof.models) == set(timeable_backends(cuda_device)) | {"slice"}
    assert not {"dense-ref", "grid-pallas-ref"} & set(prof.models)
    assert prof.hardware["platform"] == "gpu"
    assert prof.hardware["device_kind"] == torch.cuda.get_device_name(0)
    s = WorkloadShape(1000, 1_889_815, 10, 64, cache_hit=True)
    for name in prof.models:
        t = prof.predict_s(name, s)
        assert np.isfinite(t) and t > 0


# ---------------------------------------------------------------- dynamic
#: The kernel each dynamic backend must launch for a batch, as
#: ``(module, counter)``.
_DYN_KERNEL = {
    "dense": (raycast, "batch_launches"),
    "grid-pallas": (grid_raycast, "batch_launches"),
    "bvh": (bvh, "batch_launches"),
}


@pytest.mark.parametrize("backend", ["dense", "grid-pallas", "bvh"])
def test_dynamic_engine_on_card_equals_cold_engine(cuda_device, backend):
    """A user move, a facility jitter and a churn step through the dynamic
    engine on the card: every version's batch is bit-identical to a cold
    engine's on the same snapshot, each through its backend's kernel with
    no plain call; the user scatter stays on the card, out of place."""
    from repro_torch.core import RkNNConfig
    from repro_torch.dynamic import DynamicEngine, UpdateBatch
    from repro_torch.workloads import facility_churn, facility_jitter

    rng = np.random.default_rng(23)
    F, U = rng.random((80, 2)), rng.random((20_000, 2))
    F[:4] = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]  # pin the hull
    qs, k = [5, 9, 13, 17], 6
    protect = np.concatenate([np.arange(4), qs])
    dyn = DynamicEngine(F, U, RkNNConfig(backend=backend), device=cuda_device)
    dyn.query_batch(qs, k)
    ids = rng.choice(len(U), 2_000, replace=False)
    steps = [
        UpdateBatch(user_move=(ids, np.clip(U[ids] + rng.normal(0, 0.01, (2_000, 2)), 0, 1))),
        facility_jitter(F, steps=1, frac=0.1, sigma=1e-4, seed=2, protect=protect)[0],
    ]
    module, counter = _DYN_KERNEL[backend]
    for i in range(3):
        if i == 2:  # churn ids refer to the snapshot the generator sees
            steps.append(facility_churn(dyn.facilities, steps=1, rate=0.05, seed=3,
                                        protect=protect)[0])
        old = dyn._snap
        old_xs = old.xs.clone()
        rep = dyn.apply_updates(steps[i])
        if i == 0:
            new = dyn._snap
            assert rep.users_scattered
            assert new.xs.device == cuda_device and new.xs is not old.xs
            assert torch.equal(old.xs, old_xs)  # version 0 untouched
            fresh = RkNNEngine(dyn.facilities, dyn.users, device=cuda_device)
            assert torch.equal(new.xs, fresh.xs) and torch.equal(new.ys, fresh.ys)
        setattr(module, counter, 0)
        ref.calls = 0
        got = dyn.query_batch(qs, k)
        torch.cuda.synchronize(cuda_device)
        assert getattr(module, counter) >= 1 and ref.calls == 0
        want = RkNNEngine(dyn.facilities, dyn.users, RkNNConfig(backend=backend),
                          device=cuda_device).query_batch(qs, k)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(got.masks, want.masks)
        assert got.version == i + 1
