"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere
(marker ``cuda``).  This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ray-cast, grid and BVH counts bit-identical (kernels and plain
versions share one rounding contract, and the ray-cast kernel's tile
classes are exact); rank counts equal on users with no near-tie
competitor and within ±1 on the rest; the AdamW kernels (rows 10 and 11)
bit-identical to their plain versions; rows 13 (sliding-window attention)
and 14 (the RG-LRU recurrence) against float64 per output row within
twice their plain versions' error plus one bf16 ulp of the row's scale,
as rows 7-9 and 12.  The adversarial ray-cast inputs
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


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["dense", "grid-pallas", "bvh", "brute"])
def test_sharded_engine_on_card_launches_per_shard_and_equals_meshless(cuda_device, backend,
                                                                       shards):
    """``ShardedEngine`` on one card: each shard launches its backend's
    kernel once per batch (``brute`` is not sharded: one launch), no plain
    call; masks and counts bit-identical to the meshless engine on the
    card; the reassembly on the card equal to ``assemble_counts`` of the
    per-shard slabs, and the views' tensors on the card."""
    from repro_torch.core import RkNNConfig
    from repro_torch.shard import ShardedEngine, assemble_counts

    rng = np.random.default_rng(29)
    F, U = rng.random((80, 2)), rng.random((20_000, 2))
    qs, k = [5, 9, 13, 17, 21], 6
    eng = ShardedEngine(F, U, RkNNConfig(backend=backend), shards=shards, device=cuda_device)
    module, counter = _DYN_KERNEL.get(backend, (rank_count, "batch_launches"))
    setattr(module, counter, 0)
    ref.calls = 0
    got = eng.query_batch(qs, k)
    torch.cuda.synchronize(cuda_device)
    assert getattr(module, counter) == (1 if backend == "brute" else shards)
    assert ref.calls == 0
    want = RkNNEngine(F, U, RkNNConfig(backend=backend), device=cuda_device).query_batch(qs, k)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.masks, want.masks)
    if backend == "brute":
        return
    st = eng._snap.shard_state
    assert all(v.xs.device == cuda_device and v.rows.device == cuda_device for v in st.views)
    req, (kind, payload), _ = eng._snap.batch_cache.items()[-1][1]
    b = eng.config.backend
    from repro_torch.core.backends import get_backend

    slabs = [
        (get_backend(b).count_batch_device(None, payload[i][0]) if kind == "shard"
         else get_backend(b).count_batch_device(req.dispatch._request(v), payload)).cpu().numpy()
        for i, v in enumerate(st.views)
    ]
    np.testing.assert_array_equal(got.counts, assemble_counts(slabs, st.perm, st.bounds, len(U)))


@pytest.mark.parametrize("backend", ["dense", "grid", "bvh"])
def test_engine_mesh_path_on_card_equals_meshless(cuda_device, backend):
    """The engine's ``mesh=`` path on one card (one slab), and the
    dynamic engine's scatter into it, bit-identical to the meshless
    engine."""
    from repro_torch.core import RkNNConfig
    from repro_torch.dynamic import DynamicEngine, UpdateBatch
    from repro_torch.shard import user_mesh

    rng = np.random.default_rng(31)
    F, U = rng.random((80, 2)), rng.random((20_000, 2))
    qs, k = [5, 9, 13], 6
    dyn = DynamicEngine(F, U, RkNNConfig(backend=backend), mesh=user_mesh(1),
                        device=cuda_device)
    got = dyn.query_batch(qs, k)
    want = RkNNEngine(F, U, RkNNConfig(backend=backend), device=cuda_device).query_batch(qs, k)
    np.testing.assert_array_equal(got.counts, want.counts)
    ids = rng.choice(len(U), 500, replace=False)
    dyn.apply_updates(UpdateBatch(user_move=(ids, rng.random((500, 2)))))
    assert dyn._snap.mesh_xs[0].device == cuda_device
    want = RkNNEngine(dyn.facilities, dyn.users, RkNNConfig(backend=backend),
                      device=cuda_device).query_batch(qs, k)
    np.testing.assert_array_equal(dyn.query_batch(qs, k).counts, want.counts)


@pytest.mark.parametrize("backend", ["dense", "grid-pallas", "bvh", "brute"])
def test_warm_started_engine_on_card_equals_the_saved_engine(cuda_device, backend, tmp_path):
    """``save_state`` then ``RkNNConfig(warm_store=...)`` on the card: the
    warm engine's batch is bit-identical to the saved engine's, through
    the backend's kernel (one launch), with no scene rebuilt and no plain
    call."""
    from repro_torch.core import RkNNConfig

    rng = np.random.default_rng(37)
    F, U = rng.random((80, 2)), rng.random((20_000, 2))
    qs, k = [5, 9, 13, 17], 6
    eng = RkNNEngine(F, U, RkNNConfig(backend=backend), device=cuda_device)
    want = eng.query_batch(qs, k)
    eng.save_state(str(tmp_path))
    warm = RkNNEngine(F, U, RkNNConfig(backend=backend, warm_store=str(tmp_path)),
                      device=cuda_device)
    cats = {n: st["status"] for n, st in warm.persist_info["categories"].items()}
    assert cats["dataset"] == "restored"
    if backend != "brute":
        assert cats["scenes"] == cats["indexes"] == "restored"
    if backend == "grid-pallas":
        assert cats["kernel"] == "restored"
    module, counter = _DYN_KERNEL.get(backend, (rank_count, "batch_launches"))
    setattr(module, counter, 0)
    ref.calls = 0
    got = warm.query_batch(qs, k)
    torch.cuda.synchronize(cuda_device)
    assert getattr(module, counter) == 1 and ref.calls == 0
    assert warm._snap.scene_cache.misses == 0
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.masks, want.masks)


def test_adopted_cell_buckets_on_card_equal_a_cold_bucketing(cuda_device, tmp_path):
    """The kernel category's ``CellBuckets``, uploaded to the card on
    adoption, equal the cold engine's bucketing tensor for tensor (dtype,
    device and values), and no bucketing runs on the warm engine."""
    from repro_torch.core import RkNNConfig
    from repro_torch.core.backends import CellBuckets, GridPallasBackend

    rng = np.random.default_rng(41)
    F, U = rng.random((80, 2)), rng.random((30_000, 2))
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas"), device=cuda_device)
    want = eng.query_batch([3, 7], 6)
    eng.save_state(str(tmp_path))
    warm = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", warm_store=str(tmp_path)),
                      device=cuda_device)
    real, calls = GridPallasBackend._bucket, []
    GridPallasBackend._bucket = lambda self, *a: calls.append(1) or real(self, *a)
    try:
        got = warm.query_batch([3, 7], 6)
    finally:
        GridPallasBackend._bucket = real
    assert calls == []
    np.testing.assert_array_equal(got.counts, want.counts)
    [cold] = [v[1] for key, v in eng._snap.kernel_memo.items() if key[0] == "gp-buckets"]
    [adopted] = [v[1] for key, v in warm._snap.kernel_memo.items() if key[0] == "gp-buckets"]
    for name in CellBuckets._fields:
        a, b = getattr(cold, name), getattr(adopted, name)
        if isinstance(a, torch.Tensor):
            assert b.device == a.device and b.dtype == a.dtype and torch.equal(a, b), name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


# ---- LM attention (csrc/attention.cu, rows 7 and 8) ------------------------

def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("B,S,K,G,D,causal", [
    (1, 1, 1, 1, 64, True),
    (2, 65, 2, 7, 128, True),  # S not a multiple of the 64-key tile
    (1, 130, 1, 8, 64, True),
    (1, 129, 3, 1, 128, True),  # G = 1: 128 positions a block
    (2, 200, 4, 7, 128, True),
    (1, 77, 2, 7, 128, False),
    (1, 33, 1, 16, 32, False),
    # the wgmma kernel's edges: S one below, at and one above the 128-key
    # tile, and the 18-position query block at G = 7 (128 rows)
    (1, 127, 2, 7, 128, True),
    (1, 128, 2, 7, 128, True),
    (1, 129, 2, 7, 128, True),
    (2, 17, 2, 7, 128, True),
    (2, 18, 2, 7, 128, True),
    (2, 19, 2, 7, 128, True),
    (1, 257, 2, 7, 128, False),
    # the configs' group sizes at D = 128, G = 1 at D = 64, a whole CTA of heads
    (1, 300, 4, 6, 128, True),
    (1, 300, 4, 12, 128, True),
    (1, 300, 4, 16, 128, True),
    (1, 300, 2, 1, 64, True),
    (1, 130, 1, 128, 128, True),
    (1, 200, 2, 100, 64, True),
    (1, 200, 2, 7, 96, True),  # a head dim the mma.sync kernel serves
])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, B, S, K, G, D, causal):
    from repro_torch.kernels import attention as kattn
    from _torch_parity import attention64, kernel_within_yardstick

    rng = np.random.default_rng(S * 131 + G)
    q, k, v = (_bf16(rng, (B, S, K, G, D), cuda_device), _bf16(rng, (B, S, K, D), cuda_device),
               _bf16(rng, (B, S, K, D), cuda_device))
    kattn.flash_launches = 0
    got = kattn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kattn.flash_launches == 1 and got.dtype == torch.bfloat16
    plain = ref.flash_attention_ref(q, k, v, causal, 64, 64)
    ok, err_k, err_p, worst = kernel_within_yardstick(got, plain, attention64(q, k, v, causal))
    assert ok, (err_k, err_p, worst)


def test_flash_attention_kernel_cross_lengths_on_card(cuda_device):
    from repro_torch.kernels import attention as kattn
    from _torch_parity import attention64, kernel_within_yardstick

    rng = np.random.default_rng(7)
    q = _bf16(rng, (2, 40, 2, 4, 64), cuda_device)
    k, v = _bf16(rng, (2, 150, 2, 64), cuda_device), _bf16(rng, (2, 150, 2, 64), cuda_device)
    for causal in (False, True):
        got = kattn.flash_attention(q, k, v, causal=causal)
        plain = ref.flash_attention_ref(q, k, v, causal, 40, 50)
        ok, *errs = kernel_within_yardstick(got, plain, attention64(q, k, v, causal))
        assert ok, errs


@pytest.mark.parametrize("G,D", [(1, 64), (7, 128), (8, 128), (16, 64), (6, 128), (12, 128),
                                 (16, 128), (7, 24), (3, 256)])
@pytest.mark.parametrize("pos_kind", ["zero", "last", "ragged", "split_edges"])
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, G, D, pos_kind):
    from repro_torch.kernels import attention as kattn
    from _torch_parity import decode_attention64, kernel_within_yardstick

    rng = np.random.default_rng(G * 10 + D)
    B, Smax, K = 4, 300, 2  # Smax not a multiple of a 16-slot stage
    q = _bf16(rng, (B, 1, K, G, D), cuda_device)
    kc, vc = _bf16(rng, (B, Smax, K, D), cuda_device), _bf16(rng, (B, Smax, K, D), cuda_device)
    _, split = kattn.decode_plan(cuda_device, B, K, Smax, D)
    pos = {"zero": [0] * B, "last": [Smax - 1] * B, "ragged": [0, 127, 128, 299],
           "split_edges": [split - 1, split, split + 1, min(2 * split, Smax - 1)]}[pos_kind]
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    kattn.decode_launches = 0
    got = kattn.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert kattn.decode_launches == 1 and got.shape == q.shape
    plain = ref.decode_attention_ref(q, kc, vc, pos)
    ok, *errs = kernel_within_yardstick(got, plain, decode_attention64(q, kc, vc, pos))
    assert ok, errs


@pytest.mark.parametrize("B,pos_kind", [(8, "clamped"), (8, "ragged_clamped"), (1, "clamped")])
def test_decode_attention_kernel_hybrid_ring_on_card(cuda_device, B, pos_kind):
    """recurrentgemma-9b's local-layer decode: D 256, G 16, K 1 over a
    2,048-slot ring, positions past the ring clamped to its last slot as
    the decoder clamps them (``min(pos, T - 1)``)."""
    from repro_torch.kernels import attention as kattn
    from _torch_parity import decode_attention64, kernel_within_yardstick

    rng = np.random.default_rng(256 + B)
    T, K, G, D = 2048, 1, 16, 256
    q = _bf16(rng, (B, 1, K, G, D), cuda_device)
    kc, vc = _bf16(rng, (B, T, K, D), cuda_device), _bf16(rng, (B, T, K, D), cuda_device)
    pos = {"clamped": [4096] * B,
           "ragged_clamped": [0, 1, 1023, 2046, 2047, 2048, 4095, 10000]}[pos_kind]
    pos = torch.clamp(torch.tensor(pos, dtype=torch.int32, device=cuda_device), max=T - 1)
    kattn.decode_launches = 0
    got = kattn.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert kattn.decode_launches == 1 and got.shape == q.shape
    plain = ref.decode_attention_ref(q, kc, vc, pos)
    ok, *errs = kernel_within_yardstick(got, plain, decode_attention64(q, kc, vc, pos))
    assert ok, errs


def test_decode_attention_kernel_edge_positions_on_card(cuda_device):
    """``pos`` past the end reads every slot; ``pos < 0`` masks every slot,
    and JAX's softmax then averages them all: the kernel does both as the
    plain version does."""
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(9)
    q = _bf16(rng, (2, 1, 1, 3, 64), cuda_device)
    kc, vc = _bf16(rng, (2, 140, 1, 64), cuda_device), _bf16(rng, (2, 140, 1, 64), cuda_device)
    pos = torch.tensor([500, -1], dtype=torch.int32, device=cuda_device)
    got = kattn.decode_attention(q, kc, vc, pos).float()
    want = ref.decode_attention_ref(q, kc, vc, pos).float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=2.0 ** -9)


@pytest.mark.parametrize("G,D", [(7, 128), (1, 64)])
def test_decode_attention_kernel_one_row_most_splits_on_card(cuda_device, G, D):
    """B = 1: the most splits a pair.  Positions at split edges, 0, the last
    slot and < 0 (every slot masked: the plain mean of v, as the plain
    version gives), each launched twice in a row: the merge's tickets are
    back at zero after a launch, so the second agrees bit for bit."""
    from repro_torch.kernels import attention as kattn
    from _torch_parity import decode_attention64, kernel_within_yardstick

    rng = np.random.default_rng(G + D)
    Smax, K = 2112, 4
    q = _bf16(rng, (1, 1, K, G, D), cuda_device)
    kc, vc = _bf16(rng, (1, Smax, K, D), cuda_device), _bf16(rng, (1, Smax, K, D), cuda_device)
    n_splits, split = kattn.decode_plan(cuda_device, 1, K, Smax, D)
    assert n_splits > 1
    for p in (0, split - 1, split, split + 1, 2048, Smax - 1, -1):
        pos = torch.tensor([p], dtype=torch.int32, device=cuda_device)
        kattn.decode_launches = 0
        first = kattn.decode_attention(q, kc, vc, pos)
        second = kattn.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert kattn.decode_launches == 2 and torch.equal(first, second), p
        plain = ref.decode_attention_ref(q, kc, vc, pos)
        if p < 0:
            want = vc.double().mean(1)[:, None, :, None, :].expand(q.shape)
        else:
            want = decode_attention64(q, kc, vc, pos)
        ok, *errs = kernel_within_yardstick(first, plain, want)
        assert ok, (p, errs)


def test_decode_attention_kernel_two_streams_on_card(cuda_device):
    """Launches on two streams at once, each many splits a pair, agree bit
    for bit with the same launches one after another: each stream has its
    own merge tickets."""
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(31)
    Smax, K, G, D = 2112, 4, 7, 128
    inputs = []
    for p in (2048, 1000):
        q = _bf16(rng, (1, 1, K, G, D), cuda_device)
        kc, vc = _bf16(rng, (1, Smax, K, D), cuda_device), _bf16(rng, (1, Smax, K, D), cuda_device)
        inputs.append((q, kc, vc, torch.tensor([p], dtype=torch.int32, device=cuda_device)))
    want = [kattn.decode_attention(*x) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    got = [[], []]
    for _ in range(20):
        for st, x, g in zip(streams, inputs, got):
            st.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(st):
                g.append(kattn.decode_attention(*x))
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert all(torch.equal(w, o) for o in g)


def test_decode_attention_kernel_graph_outlives_a_grown_ticket_buffer_on_card(cuda_device):
    """A CUDA graph of a decode launch, captured after one uncaptured launch
    on its stream, replays right after a launch with more (row, KV head)
    pairs than the stream's ticket buffer held made it take a larger one."""
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(32)
    Smax, K, G, D = 2112, 4, 7, 128
    q = _bf16(rng, (1, 1, K, G, D), cuda_device)
    kc, vc = _bf16(rng, (1, Smax, K, D), cuda_device), _bf16(rng, (1, Smax, K, D), cuda_device)
    pos = torch.tensor([2048], dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        want = kattn.decode_attention(q, kc, vc, pos)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = kattn.decode_attention(q, kc, vc, pos)
    key = (cuda_device.index, side.cuda_stream)
    held = kattn._tickets[key].numel()
    B = held // K + 1
    big = (_bf16(rng, (B, 1, K, G, 16), cuda_device), _bf16(rng, (B, 64, K, 16), cuda_device),
           _bf16(rng, (B, 64, K, 16), cuda_device),
           torch.full((B,), 63, dtype=torch.int32, device=cuda_device))
    with torch.cuda.stream(side):
        kattn.decode_attention(*big)
    torch.cuda.synchronize()
    assert kattn._tickets[key].numel() >= B * K > held
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_flash_attention_kernel_key_tile_edges_cross_lengths_on_card(cuda_device):
    """Key lengths one below, at and one above the 128-key tile against
    other query lengths, causal and not."""
    from repro_torch.kernels import attention as kattn
    from _torch_parity import attention64, kernel_within_yardstick

    rng = np.random.default_rng(12)
    for S, Skv in ((40, 127), (40, 128), (40, 129), (200, 129), (130, 255)):
        q = _bf16(rng, (1, S, 2, 7, 128), cuda_device)
        k, v = _bf16(rng, (1, Skv, 2, 128), cuda_device), _bf16(rng, (1, Skv, 2, 128), cuda_device)
        for causal in (False, True):
            got = kattn.flash_attention(q, k, v, causal=causal)
            plain = ref.flash_attention_ref(q, k, v, causal, 64, 64)
            ok, *errs = kernel_within_yardstick(got, plain, attention64(q, k, v, causal))
            assert ok, (S, Skv, causal, errs)


def test_attention_cpu_tensors_never_reach_the_kernels(cuda_device):
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(10)
    q = _bf16(rng, (1, 9, 1, 2, 64), CPU)
    k, v = _bf16(rng, (1, 9, 1, 64), CPU), _bf16(rng, (1, 9, 1, 64), CPU)
    kattn.flash_launches = kattn.decode_launches = 0
    kattn.flash_attention(q, k, v)
    kattn.decode_attention(q[:, :1], k, v, torch.tensor([3], dtype=torch.int32))
    assert kattn.flash_launches == 0 and kattn.decode_launches == 0


def test_attention_kernels_refuse_bad_inputs_on_card(cuda_device):
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(11)
    q = _bf16(rng, (1, 8, 1, 2, 64), cuda_device)
    k, v = _bf16(rng, (1, 8, 1, 64), cuda_device), _bf16(rng, (1, 8, 1, 64), cuda_device)
    pos = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        kattn.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.decode_attention(q[:, :1], k[:, ::2], v[:, ::2], pos)
    with pytest.raises(ValueError, match="int32"):
        kattn.decode_attention(q[:, :1], k, v, pos.long())
    with pytest.raises(ValueError, match="multiple of 16"):
        kattn.flash_attention(q[..., :40].contiguous(), k[..., :40].contiguous(),
                              v[..., :40].contiguous())


# ---- LM training attention (row 7 with lse, row 9: csrc/attention_bwd.cu) ----

@pytest.mark.parametrize("B,S,Skv,K,G,D,causal", [
    (1, 1, 1, 1, 1, 16, True),
    (2, 65, 65, 2, 7, 128, True),  # rows not a multiple of the 64-row tile
    (1, 130, 130, 1, 8, 64, True),
    (1, 129, 129, 3, 1, 128, True),
    (1, 200, 200, 2, 12, 128, True),  # starcoder2-3b's group
    (1, 77, 77, 2, 7, 80, True),  # a head dim of the mma.sync forward
    (2, 100, 100, 2, 3, 48, True),
    (1, 300, 300, 4, 6, 112, True),
    (1, 64, 64, 1, 128, 128, True),  # a whole row tile of one position's heads
    (1, 40, 150, 2, 4, 64, False),  # Skv != S
    (1, 33, 33, 1, 16, 32, False),
    (1, 150, 40, 2, 4, 128, False),
    # the wgmma kernels (D = 64, 128): S and Skv at the 128-key tile's edges
    # and a multiple of 128 plus 1, G in {1, 7, 12, 128} (128: two row tiles
    # a position), B > 1 with K > 1, chunked key tiles and their partials
    # (S = 1,000 and up), Skv != S on both sides without the mask, and the
    # lm_train microbatch
    (1, 127, 127, 2, 7, 128, True),
    (1, 128, 128, 2, 7, 128, True),
    (1, 129, 129, 2, 7, 128, True),
    (1, 257, 257, 1, 1, 64, True),
    (2, 129, 129, 3, 12, 64, True),
    (1, 257, 257, 1, 128, 128, True),
    (2, 300, 300, 2, 1, 128, True),
    (3, 385, 385, 2, 7, 64, True),
    (2, 1000, 1000, 4, 7, 64, True),
    (2, 127, 257, 2, 12, 128, False),
    (2, 257, 129, 2, 7, 64, False),
    (1, 129, 128, 3, 128, 64, False),
    (4, 2048, 2048, 2, 12, 128, True),
])
def test_flash_bwd_kernel_matches_plain_and_float64_on_card(cuda_device, B, S, Skv, K, G, D,
                                                            causal):
    """Row 7's ``lse`` and row 9's gradients against their plain versions
    and float64 (``kernel_within_yardstick`` per output row,
    ``lse_within_yardstick`` per row); two row-9 launches bit for bit; D =
    64 and 128 through the planned wgmma kernels, other head dims not."""
    from repro_torch.kernels import attention as kattn
    from _torch_parity import (
        BWD_FLOOR,
        attention64_grads,
        kernel_within_yardstick,
        lse_within_yardstick,
    )

    rng = np.random.default_rng(S * 17 + Skv + G)
    q, do = _bf16(rng, (B, S, K, G, D), cuda_device), _bf16(rng, (B, S, K, G, D), cuda_device)
    k, v = _bf16(rng, (B, Skv, K, D), cuda_device), _bf16(rng, (B, Skv, K, D), cuda_device)
    kattn.flash_launches = kattn.flash_bwd_launches = 0
    blocks = (64, 64) if S < 1024 else (512, 1024)  # the plain version's, the configs' at length
    out, lse = kattn.flash_attention_fwd(q, k, v, causal=causal)
    out_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal, *blocks)
    out64, lse64, *grads64 = attention64_grads(q, k, v, do, causal)
    assert kattn.flash_launches == 1 and lse.shape == (B, K, G, S)
    assert torch.equal(out, kattn.flash_attention(q, k, v, causal=causal))  # lse changes no out
    ok, *errs = lse_within_yardstick(lse, lse_p, lse64)
    assert ok, ("lse", errs)
    ok, *errs = kernel_within_yardstick(out, out_p, out64)
    assert ok, ("out", errs)
    got = kattn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = kattn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert kattn.flash_bwd_launches == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    planned = (cuda_device.index, B, S, Skv, K, G, causal) in kattn._bwd_plans
    assert planned == (D in kattn.BWD_WGMMA_HEAD_DIMS)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, *blocks)
    for name, g, p, w, x in zip("qkv", got, plain, grads64, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        ok, *errs = kernel_within_yardstick(g, p, w, BWD_FLOOR)
        assert ok, (f"d{name}", errs)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_kernel_replays_bit_identically_in_a_cuda_graph_on_card(cuda_device, D):
    """Row 9 captured in a CUDA graph after an uncaptured launch of its
    shape (which makes the plan) replays bit for bit what the launches
    give; a capture of a shape with no plan yet raises."""
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(14 + D)
    B, S, K, G = 2, 700, 2, 12
    q, do = _bf16(rng, (B, S, K, G, D), cuda_device), _bf16(rng, (B, S, K, G, D), cuda_device)
    k, v = _bf16(rng, (B, S, K, D), cuda_device), _bf16(rng, (B, S, K, D), cuda_device)
    out, lse = kattn.flash_attention_fwd(q, k, v)
    want = kattn.flash_attention_bwd(q, k, v, out, lse, do)
    assert kattn._bwd_plans[(cuda_device.index, B, S, S, K, G, True)][0].n_slots > 0
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        kattn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = kattn.flash_attention_bwd(q, k, v, out, lse, do)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    short = [t[:, :333].contiguous() for t in (q, out, do)]
    lse_short = lse[..., :333].contiguous()
    with pytest.raises(RuntimeError, match="uncaptured"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            kattn.flash_attention_bwd(short[0], k, v, short[1], lse_short, short[2])


def test_flash_bwd_kernel_refuses_bad_inputs_on_card(cuda_device):
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(13)
    q, do = _bf16(rng, (1, 8, 1, 2, 64), cuda_device), _bf16(rng, (1, 8, 1, 2, 64), cuda_device)
    k, v = _bf16(rng, (1, 8, 1, 64), cuda_device), _bf16(rng, (1, 8, 1, 64), cuda_device)
    out, lse = kattn.flash_attention_fwd(q, k, v)
    kattn.flash_bwd_launches = 0
    with pytest.raises(ValueError, match="lse must be"):
        kattn.flash_attention_bwd(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="lse must be"):
        kattn.flash_attention_bwd(q, k, v, out, lse.transpose(2, 3).contiguous().transpose(2, 3),
                                  do)
    with pytest.raises(ValueError, match="lse must be"):
        kattn.flash_attention_bwd(q, k, v, out, lse[..., :4], do)
    with pytest.raises(ValueError, match="bfloat16"):
        kattn.flash_attention_bwd(q, k, v, out, lse, do.float())
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_attention_bwd(q, k, v, out, lse, do.transpose(1, 3).contiguous().transpose(1, 3))
    with pytest.raises(ValueError, match="out and do"):
        kattn.flash_attention_bwd(q, k, v, out[:, :4].contiguous(), lse, do)
    with pytest.raises(ValueError, match="multiple of 16"):
        kattn.flash_attention_bwd(*(t[..., :40].contiguous() for t in (q, k, v, out)), lse,
                                  do[..., :40].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        kattn.flash_attention_bwd_kernel_call(*(t.cpu() for t in (q, k, v, out, lse, do)))
    assert kattn.flash_bwd_launches == 0


def test_decoder_kernel_gradients_stay_within_the_plain_spread_on_card(cuda_device):
    """A 4-layer reduced starcoder2-3b at bf16 compute, one loss and
    backward through rows 7 and 9, against the plain path (the plain
    versions in place of the wrappers) with the config's blocks and with
    other blocks, and a float32 plain path: each gradient leaf's distance
    to the plain path at most twice the plain paths' spread (their largest
    difference over the leaves), and the kernel path's distance to float32
    at most twice the plain path's (``chip_smoke.py``'s ``lm_train_checks``
    rule)."""
    import contextlib
    import copy
    import dataclasses
    from unittest import mock

    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels import attention as kattn
    from repro_torch.models.common import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.steps.loss import softmax_xent

    cfg = get_reduced("starcoder2_3b")
    params0 = build_model(cfg, device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(14)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(cuda_device)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(cuda_device)

    def grads(c, plain):
        p = copy.deepcopy(params0)
        stack = contextlib.ExitStack()
        if plain:
            stack.enter_context(mock.patch.object(
                kattn, "flash_attention_fwd", lambda q, k, v, *, causal, q_block, kv_block:
                ref.flash_attention_fwd_ref(q, k, v, causal, q_block, kv_block)))
            stack.enter_context(mock.patch.object(
                kattn, "flash_attention_bwd", lambda q, k, v, o, l, d, *, causal, q_block, kv_block:
                ref.flash_attention_bwd_ref(q, k, v, o, l, d, causal, q_block, kv_block)))
        kattn.flash_bwd_launches = 0
        with stack:
            logits, _ = build_model(c, device=cuda_device).forward(p, tokens, {})
            softmax_xent(logits, labels)[0].backward()
        torch.cuda.synchronize()
        assert kattn.flash_bwd_launches == (0 if plain else cfg.n_layers)
        return {n: t.grad for n, t in p.named_parameters()}

    def rel(a, b):
        return {n: float((a[n] - b[n]).abs().max()) / float(b[n].abs().max()) for n in b}

    kernel, plain = grads(cfg, False), grads(cfg, True)
    other = grads(dataclasses.replace(cfg, q_block=32, kv_block=128), True)
    compute = Policy.compute_dtype
    try:
        Policy.compute_dtype = torch.float32
        f32 = grads(cfg, True)
    finally:
        Policy.compute_dtype = compute
    kp, pp = rel(kernel, plain), rel(other, plain)
    k32, p32 = rel(kernel, f32), rel(plain, f32)
    spread = max(pp.values())
    assert 0 < spread and max(kp.values()) <= 2 * spread, (kp, pp)
    assert max(k32.values()) <= 2 * max(p32.values()), (k32, p32)


# ---- rows 10 and 11: the fused AdamW kernels ----------------------------------

ADAMW_SIZES = (1, 127, 129, (1 << 20) + 3, 4096, 8193)
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _adamw_step_tensors(dev, gen):
    """lr, bc1, bc2 and the clip's scale as the optimizer makes them: 0-d
    float32 tensors on the card (step 3 of a schedule, a clip below 1)."""
    from repro_torch.optim.adamw import AdamWConfig, step_scalars

    st = {"step": torch.full((), 2, dtype=torch.int32, device=dev)}
    lr, bc1, bc2 = step_scalars(st, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=9))
    scale = torch.rand((), generator=gen, device=dev) * 0.5 + 0.25
    return lr, bc1, bc2, scale


def _adamw_leaves(dev, gen, sizes, zero_leaf=None):
    ps, gs, ms, vs = [], [], [], []
    for i, n in enumerate(sizes):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-4
        if i == zero_leaf:
            g[: n // 2] = 0
            m[: n // 2] = 0
            v[: n // 2] = 0
        ps.append(p), gs.append(g), ms.append(m), vs.append(v)
    return ps, gs, ms, vs


def _clone(ts):
    return [t.clone() for t in ts]


@pytest.mark.parametrize("sizes", [(n,) for n in ADAMW_SIZES] + [ADAMW_SIZES])
def test_adamw_kernel_is_bit_identical_to_plain_on_card(cuda_device, sizes):
    from repro_torch.kernels import adamw as kadamw

    gen = torch.Generator(cuda_device).manual_seed(sum(sizes))
    steps = _adamw_step_tensors(cuda_device, gen)
    ps, gs, ms, vs = _adamw_leaves(cuda_device, gen, sizes, zero_leaf=len(sizes) - 1)
    kp, km, kv = _clone(ps), _clone(ms), _clone(vs)
    ref.calls = kadamw.adamw_launches = 0
    kadamw.adamw_fused(kp, gs, km, kv, *steps, **ADAMW_HYPER)
    assert kadamw.adamw_launches == 1 and ref.calls == 0
    pp, pm, pv = _clone(ps), _clone(ms), _clone(vs)
    ref.adamw_ref(pp, gs, pm, pv, *steps, **ADAMW_HYPER)
    torch.cuda.synchronize()
    for got, want in ((kp, pp), (km, pm), (kv, pv)):
        for a, b in zip(got, want):
            assert torch.equal(a, b), float((a - b).abs().max())
    # a second launch from the same inputs gives the same bits
    kp2, km2, kv2 = _clone(ps), _clone(ms), _clone(vs)
    kadamw.adamw_fused(kp2, gs, km2, kv2, *steps, **ADAMW_HYPER)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kp + km + kv, kp2 + km2 + kv2))


def test_adamw_kernel_takes_unaligned_leaves_on_card(cuda_device):
    """Leaves 4 bytes past a 16-byte boundary run the scalar path."""
    from repro_torch.kernels import adamw as kadamw

    def unaligned(t):
        return torch.empty(t.numel() + 1, device=t.device)[1:].copy_(t)

    gen = torch.Generator(cuda_device).manual_seed(5)
    steps = _adamw_step_tensors(cuda_device, gen)
    ps, gs, ms, vs = _adamw_leaves(cuda_device, gen, (10_001,))
    kp, kg, km, kv = ([unaligned(x[0])] for x in (ps, gs, ms, vs))
    assert kp[0].data_ptr() % 16
    kadamw.adamw_fused(kp, kg, km, kv, *steps, **ADAMW_HYPER)
    pp, pm, pv = _clone(ps), _clone(ms), _clone(vs)
    ref.adamw_ref(pp, gs, pm, pv, *steps, **ADAMW_HYPER)
    torch.cuda.synchronize()
    for got, want in ((kp, pp), (km, pm), (kv, pv)):
        assert torch.equal(got[0], want[0])


def _int8_states(dev, gen, sizes, zero_leaf=None):
    from repro_torch.optim.adamw8bit import quantize_blockwise

    states = []
    for i, n in enumerate(sizes):
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-4
        if i == zero_leaf:
            m[: n // 2] = 0
            v[: n // 2] = 0
        (mq, ms), (vq, vs) = quantize_blockwise(m, True), quantize_blockwise(v, False)
        states.append({"mq": mq, "ms": ms, "vq": vq, "vs": vs})
    return states


def _clone_states(states):
    return [{k: t.clone() for k, t in s.items()} for s in states]


@pytest.mark.parametrize("sizes", [(n,) for n in ADAMW_SIZES] + [ADAMW_SIZES])
def test_adamw8bit_kernel_is_bit_identical_to_plain_on_card(cuda_device, sizes):
    from repro_torch.kernels import adamw as kadamw

    gen = torch.Generator(cuda_device).manual_seed(7 + sum(sizes))
    steps = _adamw_step_tensors(cuda_device, gen)
    ps, gs, _, _ = _adamw_leaves(cuda_device, gen, sizes, zero_leaf=len(sizes) - 1)
    states = _int8_states(cuda_device, gen, sizes, zero_leaf=len(sizes) - 1)
    kp, ks = _clone(ps), _clone_states(states)
    ref.calls = kadamw.adamw8bit_launches = 0
    kadamw.adamw8bit_fused(kp, gs, ks, *steps, **ADAMW_HYPER)
    assert kadamw.adamw8bit_launches == 1 and ref.calls == 0
    pp, pst = _clone(ps), _clone_states(states)
    ref.adamw8bit_ref(pp, gs, pst, *steps, **ADAMW_HYPER)
    torch.cuda.synchronize()
    for a, b in zip(kp, pp):
        assert torch.equal(a, b), float((a - b).abs().max())
    for a, b in zip(ks, pst):
        for key in ("mq", "ms", "vq", "vs"):
            assert torch.equal(a[key], b[key]), key
    kp2, ks2 = _clone(ps), _clone_states(states)
    kadamw.adamw8bit_fused(kp2, gs, ks2, *steps, **ADAMW_HYPER)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kp, kp2))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(ks, ks2) for k in a)


def test_adamw_kernels_in_the_optimizers_on_card(cuda_device, monkeypatch):
    """``adamw_update`` and ``adamw8bit_update`` on card leaves launch their
    kernel once and no plain version, and equal the optimizers over the
    plain versions bit for bit, update after update."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import adamw as tadamw
    from repro_torch.optim import adamw8bit as t8

    gen = torch.Generator(cuda_device).manual_seed(11)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    p0 = {"a": torch.randn(3, 129, generator=gen, device=cuda_device),
          "b": torch.randn(1, generator=gen, device=cuda_device)}
    for module, init, update, counter, name, plain in (
            (tadamw, tadamw.adamw_init, tadamw.adamw_update, "adamw_launches", "adamw_fused",
             ref.adamw_ref),
            (t8, t8.adamw8bit_init, t8.adamw8bit_update, "adamw8bit_launches",
             "adamw8bit_fused", ref.adamw8bit_ref)):
        kp = {k: v.clone() for k, v in p0.items()}
        pp = {k: v.clone() for k, v in p0.items()}
        kst, pst = init(kp), init(pp)
        for i in range(3):
            g = {k: torch.randn(v.shape, generator=gen, device=cuda_device) for k, v in p0.items()}
            ref.calls = 0
            setattr(kadamw, counter, 0)
            update(kp, g, kst, cfg)
            assert getattr(kadamw, counter) == 1 and ref.calls == 0
            with monkeypatch.context() as mp:
                mp.setattr(module, name, plain)
                update(pp, g, pst, cfg)
            torch.cuda.synchronize()
            assert all(torch.equal(kp[k], pp[k]) for k in p0), (name, i)


# ---- row 12: the MoE FFN's routed experts (csrc/moe.cu) -----------------------

#: A router near-tie: the k-th and (k+1)-th logits within this (about 10
#: bf16 ulps at the reduced model's logits, which lie near 0.25), where the
#: card and the CPU may choose apart.
MOE_TIE_GAP = 0.02

# (counts [n_groups, E] of compact rows, laid out by (expert, group); d, f):
# empty experts; one expert holding all C = 480 rows; runs that are no
# multiple of a tile; B = 1 decode (6 experts of 64 with one row each) and
# B = 8 at deepseek's widths; the tiles' boundaries: the largest bound that
# runs narrow (64, one narrow tile, its columns no multiple of a wide
# item's) and the smallest that runs wide (65), an expert of exactly one
# wide tile (128 rows) and one row more, in one group and across groups
# (a tile takes an expert's rows of every group), the widest runs (480) at
# deepseek's widths; B = 1 at dbrx-132b's widths (d 6144, f 10752: the
# deepest streams of a narrow item, 96 and 168 stages)
MOE_CASES = {
    "empty_experts": ([[3, 0, 70, 0, 1], [0, 0, 2, 129, 0]], 128, 64),
    "one_expert_full": ([[0] * 7 + [480] + [0] * 8], 256, 128),
    "ragged_tiles": ([[65, 1, 130, 63], [64, 0, 127, 2]], 128, 192),
    "b1_decode": ([[1 if e in (3, 9, 17, 40, 41, 63) else 0 for e in range(64)]], 2048, 1408),
    "b8_decode": ([[(e * 7) % 3 for e in range(64)]], 2048, 1408),
    "narrow_full_tile": ([[64, 3, 0, 64]], 128, 192),
    "wide_smallest_bound": ([[65, 1, 0, 2]], 128, 192),
    "one_wide_tile": ([[128, 0, 3], [0, 128, 0]], 256, 128),
    "one_wide_tile_plus_one": ([[129, 2, 0], [0, 0, 129]], 256, 128),
    "wide_tile_across_groups": ([[100, 64, 1], [28, 65, 0]], 128, 192),
    "widest_runs": ([[480, 0, 480, 17]], 2048, 1408),
    "b1_dbrx_widths": ([[1, 1]], 6144, 10752),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_kernel_matches_plain_and_float64_on_card(cuda_device, case, act):
    from repro_torch.kernels import moe as kmoe
    from _torch_parity import kernel_within_yardstick, moe_inputs, moe_mlp64

    counts, d, f = MOE_CASES[case]
    glu = act in ("swiglu", "geglu")
    xc, offsets, w_in, w_gate, w_out = moe_inputs(
        len(case) * d, counts, d, f, glu=glu, dtype=torch.bfloat16, device=cuda_device)
    R = int(np.sum(counts))
    bound = int(np.max(counts))
    kmoe.moe_launches = 0
    ref.calls = 0
    got = kmoe.moe_expert_mlp(xc, offsets, bound, w_in, w_gate, w_out, act)
    torch.cuda.synchronize()
    assert (kmoe.moe_launches, ref.calls) == (2, 0) and got.shape == xc.shape
    # the NaN rows past the runs may be read by a tile of the last run, never stored
    assert bool(torch.isfinite(got[:R]).all())
    plain = ref.moe_expert_mlp_ref(xc, offsets, bound, w_in, w_gate, w_out, act)
    ok, err_k, err_p, worst = kernel_within_yardstick(
        got[:R], plain[:R], moe_mlp64(xc, offsets, w_in, w_gate, w_out, act)[:R])
    assert ok, (err_k, err_p, worst)
    # a larger static bound only adds blocks, or takes the other geometry
    # (a bound of 64 runs narrow, 256 wide): the same sums in the same order
    again = kmoe.moe_expert_mlp(xc, offsets, min(4 * bound, xc.shape[0]), w_in, w_gate, w_out,
                                act)
    assert torch.equal(again[:R], got[:R])


@pytest.mark.parametrize("case", ["b8_decode", "narrow_full_tile", "ragged_tiles"])
def test_moe_kernel_is_deterministic_on_card(cuda_device, case):
    """Two calls on the same inputs give the same bits (no atomics; the
    walk and every sum's order are fixed by the offsets), and a bound that
    runs narrow gives the bits of one that runs wide."""
    from repro_torch.kernels import moe as kmoe
    from _torch_parity import moe_inputs

    counts, d, f = MOE_CASES[case]
    xc, offsets, w_in, w_gate, w_out = moe_inputs(
        17 + len(case), counts, d, f, dtype=torch.bfloat16, device=cuda_device)
    R = int(np.sum(counts))
    bound = int(np.max(counts))

    def call(rows_bound):
        return kmoe.moe_expert_mlp(xc, offsets, rows_bound, w_in, w_gate, w_out, "swiglu")[:R]

    first = call(bound)
    assert torch.equal(call(bound), first)
    if bound <= kmoe.MOE_NARROW_MAX_BOUND:
        assert torch.equal(call(kmoe.MOE_NARROW_MAX_BOUND + 1), first)


def test_moe_kernel_refuses_bad_inputs_on_card(cuda_device):
    from repro_torch.kernels import moe as kmoe
    from _torch_parity import moe_inputs

    xc, offsets, w_in, w_gate, w_out = moe_inputs(3, [[2, 3]], 128, 64, dtype=torch.bfloat16,
                                                  device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        kmoe.moe_expert_mlp(xc.float(), offsets, 3, w_in, w_gate, w_out, "swiglu")
    with pytest.raises(ValueError, match="w_gate"):
        kmoe.moe_expert_mlp(xc, offsets, 3, w_in, None, w_out, "swiglu")
    with pytest.raises(ValueError, match="offsets"):
        kmoe.moe_expert_mlp(xc, offsets.long(), 3, w_in, w_gate, w_out, "swiglu")
    with pytest.raises(ValueError, match="multiple"):
        kmoe.moe_expert_mlp(xc[:, :96].contiguous(), offsets, 3, w_in[:, :96].contiguous(),
                            w_gate[:, :96].contiguous(), w_out[:, :, :96].contiguous(), "swiglu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kmoe.moe_expert_mlp(xc, offsets, 3, w_in.requires_grad_(), w_gate, w_out, "swiglu")


def test_moe_decoder_on_card_matches_the_cpu_plain_path(cuda_device):
    """A reduced deepseek-moe-16b (1 dense and 3 MoE layers) at bf16: the
    forward, prefill and 4 decode steps on the card through rows 7, 8 and
    12 against the same weights on the CPU (the plain versions).  The two
    round apart, so a token whose router logits near-tie may take another
    expert on each device, which moves its logits far more than rounding:
    such a token must have had a near-tie (its k-th and (k+1)-th router
    logits within ``MOE_TIE_GAP`` on the CPU at the first layer where the
    two choose apart), a pair dropped at the capacity on one device only
    must follow such a flip, and at most 10 % of the tokens may be either;
    every other token's logits lie within 0.05 of the scale.  6 row-12 launches a
    prefill, 6 a decode step, no plain call."""
    import copy
    from unittest import mock

    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models import ffn as tffn
    from repro_torch.models.registry import build_model

    cfg = get_reduced("deepseek_moe_16b")
    k = cfg.moe.top_k
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    params_cpu = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(5),
                                                   dtype=torch.bfloat16)
    rng = np.random.default_rng(15)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 70)))
    real_route = tffn.route

    def run(dev):
        model = build_model(cfg, device=dev)
        params = copy.deepcopy(params_cpu).to(dev)
        routes = []  # per call: each MoE layer's (sorted top-k, their keep, the logit gap)

        def route(probs, moe_cfg, capacity):
            r = real_route(probs, moe_cfg, capacity)
            top = torch.sort(probs, dim=-1, descending=True).values.reshape(-1, probs.shape[-1])
            gap = torch.log(top[:, k - 1]) - torch.log(top[:, k])
            sets, order = r.topi.reshape(-1, k).sort(-1)
            keep = torch.gather(r.keep.reshape(-1, k), 1, order)
            routes[-1].append((sets.cpu(), keep.cpu(), gap.cpu()))
            return r

        out, counted = {}, []
        with mock.patch.object(tffn, "route", route):
            routes.append([])
            out["forward"] = model.forward(params, tokens.to(dev), {})[0]
            kmoe.moe_launches = 0
            ref.calls = 0
            routes.append([])
            lp, cache = model.prefill(params, tokens[:, :66].to(dev), {}, pad_cache_to=72)
            counted.append(kmoe.moe_launches)
            out["prefill"] = lp
            for i in range(4):
                kmoe.moe_launches = 0
                routes.append([])
                out[f"decode{i}"], cache = model.decode(params, tokens[:, 66 + i:67 + i].to(dev),
                                                        cache)
                counted.append(kmoe.moe_launches)
        plain = ref.calls
        return {key: v.float().cpu() for key, v in out.items()}, routes, counted, plain

    with torch.no_grad():
        card, card_routes, card_counted, card_plain = run(cuda_device)
        cpu, cpu_routes, _, _ = run(CPU)
    assert card_counted == [2 * n_moe] * 5 and card_plain == 0
    scale = float(cpu["forward"].abs().max())
    flipped = total = 0
    for (key, got), rc, rp in zip(card.items(), card_routes, cpu_routes):
        want = cpu[key]
        n_tok = {"forward": 3 * 70, "prefill": 3 * 66}.get(key, 3)
        apart = torch.zeros(n_tok, dtype=torch.bool)
        flips = False
        for (sets_c, keep_c, _), (sets_p, keep_p, gap_p) in zip(rc, rp):
            chose = (sets_c[:n_tok] != sets_p[:n_tok]).any(-1)
            first = chose & ~apart
            assert bool((gap_p[:n_tok][first] < MOE_TIE_GAP).all()), (key, gap_p[:n_tok][first])
            flips |= bool(chose.any())
            # a flip moves the later tokens of its experts' queues: at the
            # capacity a pair may drop on one device and not on the other
            dropped = (keep_c[:n_tok] != keep_p[:n_tok]).any(-1) & ~chose
            assert flips or not bool(dropped.any()), key
            apart |= chose | dropped
        if key == "prefill":  # the last prompt position's logits
            apart = apart.view(3, 66)[:, -1]
        err = (got - want).abs().amax(-1).reshape(-1) / scale
        assert bool((err[~apart] < 0.05).all()), (key, float(err[~apart].max()))
        flipped += int(apart.sum())
        total += apart.numel()
    assert flipped <= 0.1 * total, (flipped, total)


# ---- the hybrid family: rows 13 (csrc/attention.cu, windowed) and 14 (csrc/rglru.cu) ----

@pytest.mark.parametrize("B,S,K,G,D,window", [
    (1, 1, 1, 1, 256, 4),
    (2, 100, 1, 16, 256, 32),  # recurrentgemma's heads: 8 positions a block
    (1, 300, 1, 16, 256, 64),  # S % window != 0
    (1, 130, 1, 1, 256, 50),  # 128 positions a block: late rows miss the first tile
    (1, 129, 1, 128, 32, 17),  # one position a block
    (1, 257, 2, 7, 128, 64),  # the head dims the wgmma kernel takes unwindowed
    (2, 200, 1, 4, 64, 48),
    (1, 70, 2, 3, 256, 100),  # a window past the length: causal
    (2, 96, 1, 4, 32, 64),  # get_reduced("recurrentgemma_9b")
    (1, 4096, 1, 16, 256, 2048),  # lm_hybrid_serve's prefill, one row
])
def test_local_attention_kernel_matches_plain_and_float64_on_card(cuda_device, B, S, K, G, D,
                                                                  window):
    from repro_torch.kernels import attention as kattn
    from _torch_parity import kernel_within_yardstick, local_attention64

    rng = np.random.default_rng(S * 7 + G + D)
    q, k, v = (_bf16(rng, (B, S, K, G, D), cuda_device), _bf16(rng, (B, S, K, D), cuda_device),
               _bf16(rng, (B, S, K, D), cuda_device))
    kattn.local_launches = kattn.flash_launches = 0
    got = kattn.local_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert kattn.local_launches == 1 and kattn.flash_launches == 0
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    plain = ref.local_attention_ref(q, k, v, window)
    ok, err_k, err_p, worst = kernel_within_yardstick(got, plain,
                                                      local_attention64(q, k, v, window))
    assert ok, (err_k, err_p, worst)


def test_local_attention_kernel_refuses_bad_inputs_on_card(cuda_device):
    from repro_torch.kernels import attention as kattn

    rng = np.random.default_rng(12)
    q = _bf16(rng, (1, 8, 1, 2, 256), cuda_device)
    k, v = _bf16(rng, (1, 8, 1, 256), cuda_device), _bf16(rng, (1, 8, 1, 256), cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        kattn.local_attention(q.float(), k, v, window=4)
    with pytest.raises(ValueError, match="windowed"):
        kattn.local_attention(q[..., :192].contiguous(), k[..., :192].contiguous(),
                              v[..., :192].contiguous(), window=4)
    with pytest.raises(ValueError, match="length"):
        kattn.local_attention(q, k[:, :6].contiguous(), v[:, :6].contiguous(), window=4)
    with pytest.raises(ValueError, match="window"):
        kattn.local_attention(q, k, v, window=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kattn.local_attention(q.requires_grad_(), k, v, window=4)
    with pytest.raises(ValueError, match="multiple of 16"):  # row 7 still stops at 128
        kattn.flash_attention(q.detach(), k, v)


def _rglru_inputs(seed, B, S, w, h_dtype, dev):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)  # noqa: E731
    h = torch.from_numpy(rng.standard_normal((B, S, w)).astype(np.float32)).to(dev, h_dtype)
    lam = torch.from_numpy(rng.uniform(2.2, 6.9, w).astype(np.float32)).to(dev)
    init = torch.from_numpy(rng.standard_normal((B, w)).astype(np.float32)).to(dev)
    return f(B, S, w), f(B, S, w), h, lam, init


@pytest.mark.parametrize("B,S,w,h_dtype,with_init", [
    (1, 1, 1, torch.bfloat16, False),
    (8, 1, 4096, torch.bfloat16, True),  # a decode step of lm_hybrid_serve
    (2, 37, 130, torch.float32, True),  # w not a multiple of the block's 64
    (3, 9, 128, torch.float32, False),  # S not a multiple of the 16-step unroll
    (2, 300, 4096, torch.bfloat16, False),
    (2, 4096, 4096, torch.bfloat16, True),  # lm_hybrid_serve's prefill, two rows
])
def test_rglru_kernel_matches_plain_and_float64_on_card(cuda_device, B, S, w, h_dtype,
                                                        with_init):
    from repro_torch.kernels import rglru as krglru
    from _torch_parity import kernel_within_yardstick, rglru_scan64

    r, i, h, lam, init = _rglru_inputs(S + w, B, S, w, h_dtype, cuda_device)
    init = init if with_init else None
    krglru.launches = 0
    y, state = krglru.rglru_scan(r, i, h, lam, init)
    torch.cuda.synchronize()
    assert krglru.launches == 1 and y.dtype == state.dtype == torch.float32
    assert torch.equal(state, y[:, -1])
    py, pstate = ref.rglru_scan_ref(r, i, h, lam, init)
    y64, _ = rglru_scan64(r, i, h, lam, init)
    ok, err_k, err_p, worst = kernel_within_yardstick(y, py, y64)
    assert ok, (err_k, err_p, worst)
    # float32 rounding, not bf16: within 2^-16 of each row's scale from the
    # plain version, which rounds a_t and every term as the kernel does (both
    # lie further from float64: a_t's float32 rounding is carried through up
    # to 1 / (1 - a_t) steps)
    rows = (y - py).abs().amax(-1) / py.abs().amax(-1).clamp_min(1e-30)
    assert float(rows.max()) < 2.0 ** -16, float(rows.max())


def test_rglru_kernel_refuses_bad_inputs_on_card(cuda_device):
    from repro_torch.kernels import rglru as krglru

    r, i, h, lam, init = _rglru_inputs(3, 2, 5, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        krglru.rglru_scan(r.to(torch.bfloat16), i, h, lam, init)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        krglru.rglru_scan(r, i, h.half(), lam, init)
    with pytest.raises(ValueError, match="lam"):
        krglru.rglru_scan(r, i, h, lam[:10], init)
    with pytest.raises(ValueError, match="contiguous"):
        krglru.rglru_scan(r.transpose(0, 1).contiguous().transpose(0, 1), i, h, lam, init)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        krglru.rglru_scan(r.requires_grad_(), i, h, lam, init)
    krglru.launches = 0
    ref.calls = 0
    krglru.rglru_scan(r.detach().cpu(), i.cpu(), h.cpu(), lam.cpu(), init.cpu())
    assert krglru.launches == 0 and ref.calls == 1


def test_hybrid_decoder_on_card_matches_the_cpu_plain_path(cuda_device):
    """A reduced recurrentgemma-9b (rglru, rglru, local, rglru; window 64)
    at bf16: the forward, a prefill of 96 tokens (past the window, so the
    ring is JAX's ragged one) and 4 decode steps on the card through rows
    13, 14 and 8 against the same weights on the CPU (the plain versions),
    within 0.05 of the scale (the dense families' bf16 rule); 1 row-13 and
    3 row-14 launches a prefill, 1 row-8 and 3 row-14 a step, no plain
    call."""
    import copy

    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import rglru as krglru
    from repro_torch.models.registry import build_model

    cfg = get_reduced("recurrentgemma_9b")
    params_cpu = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(6),
                                                   dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab, (3, 100)))

    def run(dev):
        model = build_model(cfg, device=dev)
        params = copy.deepcopy(params_cpu).to(dev)
        out, counted = {}, []
        out["forward"] = model.forward(params, tokens.to(dev), {})[0]
        kattn.local_launches = kattn.decode_launches = krglru.launches = ref.calls = 0
        out["prefill"], cache = model.prefill(params, tokens[:, :96].to(dev), {})
        counted.append((kattn.local_launches, kattn.decode_launches, krglru.launches))
        for s in range(4):
            kattn.local_launches = kattn.decode_launches = krglru.launches = 0
            out[f"decode{s}"], cache = model.decode(params, tokens[:, 96 + s:97 + s].to(dev),
                                                    cache)
            counted.append((kattn.local_launches, kattn.decode_launches, krglru.launches))
        return {key: v.float().cpu() for key, v in out.items()}, counted, ref.calls

    with torch.no_grad():
        card, card_counted, card_plain = run(cuda_device)
        cpu, _, _ = run(CPU)
    assert card_counted == [(1, 0, 3)] + [(0, 1, 3)] * 4 and card_plain == 0
    scale = float(cpu["forward"].abs().max())
    for key, got in card.items():
        assert bool(torch.isfinite(got).all()), key
        err = float((got - cpu[key]).abs().max()) / scale
        assert err < 0.05, (key, err)
