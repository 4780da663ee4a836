"""The rank-count kernel's tile design, on the CPU.

The kernel (``csrc/rank_count.cu``) reads the users in a spatial order
(``repro_torch/kernels/user_order.py``); each warp takes 256 of them,
computes their thresholds ``d^2(u, q)``, their least and greatest value
and their bounding box, classifies every facility on that box as SKIP
(closer to no user), FULL (closer to every user) or TEST, and tests single
users only against the TEST facilities.  The kernel runs only on the card
(``tests/test_torch_cuda.py``); here its plain twin
``ref.rank_tile_classes_ref`` (the same float32 arithmetic, no margin) is
held against the plain count: "add the FULL facilities, test only the
TEST ones" must equal ``ops.rank_count_batch``'s plain version exactly,
ties included, on inputs built to sit on or within a few ulps of a tie
and on the boxes' edges and corners.  Small sizes: each case runs in well
under a second.
"""

import numpy as np
import pytest
import torch

from repro.core.brute import rank_counts_np
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.kernels import ops as jops
from repro_torch.core import RkNNConfig, RkNNEngine
from repro_torch.kernels import ops, rank_count, ref
from repro_torch.kernels.user_order import build_user_order, tile_boxes

from tests._torch_parity import CPU, adversarial_rank_inputs, instance, non_tie_mask

SUB_TILE = 256  # users a warp of the kernel classifies for


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sq(a, b):
    d = a - b
    return d * d


def _sub_tiles(order, q_pts, tile):
    """The kernel's per-sub-tile inputs on tiles of ``tile`` sorted users:
    boxes ``[T, 4]``, thresholds in tile order ``[Q, N]``, and their least
    and greatest value per tile ``[Q, T]`` (NaN if any is NaN; the ragged
    last tile repeats its last user, which changes neither)."""
    xy_s = torch.stack([order.xs_s, order.ys_s])
    n = xy_s.shape[1]
    n_tiles = -(-n // tile)
    thr = _sq(order.xs_s[None], q_pts[:, :1]) + _sq(order.ys_s[None], q_pts[:, 1:])  # [Q, N]
    padded = torch.cat([thr, thr[:, -1:].expand(-1, n_tiles * tile - n)], dim=1)
    per_tile = padded.reshape(thr.shape[0], n_tiles, tile)
    return tile_boxes(xy_s, tile), thr, per_tile.amin(-1), per_tile.amax(-1)


def culled_count(users, fac, q_pts, exclude, tile=SUB_TILE):
    """``([Q, N] counts in the users' order, [Q, T, M] classes, closer
    [Q, N, M] in tile order)`` formed the way the kernel forms them: per
    tile, the FULL facilities plus the TEST facilities closer than the
    user's threshold; SKIP facilities and each query's excluded row add
    nothing whatever the user."""
    order = build_user_order(users[:, 0].contiguous(), users[:, 1].contiguous())
    boxes, thr, tmin, tmax = _sub_tiles(order, q_pts, tile)
    classes = ref.rank_tile_classes_ref(boxes, tmin, tmax, fac[:, 0], fac[:, 1])
    for q, e in enumerate(exclude):
        if e is not None:
            classes[q, :, e] = ref.TILE_SKIP
    tile_of = torch.arange(users.shape[0]) // tile
    per_user = classes[:, tile_of, :]  # [Q, N, M]
    d = _sq(order.xs_s[:, None], fac[None, :, 0]) + _sq(order.ys_s[:, None], fac[None, :, 1])
    closer = d[None] < thr[..., None]  # [Q, N, M]
    counts_s = ((closer & (per_user == ref.TILE_TEST)) | (per_user == ref.TILE_FULL)).sum(
        -1, dtype=torch.int32
    )
    out = torch.empty_like(counts_s)
    out[:, order.perm.long()] = counts_s
    return out, classes, closer, tile_of


# (seed, users, facilities, queries, tile, coordinate scale, offset)
CASES = {
    "unit-256": (0, 1500, 120, 4, SUB_TILE, 1.0, 0.0),
    "ragged-256": (1, 777, 64, 3, SUB_TILE, 1.0, 0.5),
    "one-tile": (2, 200, 50, 2, SUB_TILE, 1.0, 0.0),
    "tiles-of-7": (3, 300, 40, 3, 7, 1.0, 0.0),
    "tiles-of-1": (4, 90, 30, 2, 1, 1.0, 0.0),
    "tile-1024": (5, 2500, 60, 2, 1024, 1.0, 0.0),
    "large-coords": (6, 800, 60, 3, SUB_TILE, 1e3, 1e4),
    "subnormal-squares": (7, 800, 60, 3, SUB_TILE, 1e-20, 0.0),
    "normal-subnormal-edge": (8, 500, 40, 2, 32, 1e-19, 0.0),
}


def _case(name):
    seed, n, m, q_n, tile, scale, offset = CASES[name]
    U, F, Q, excl = adversarial_rank_inputs(seed, n, m, q_n, scale=scale, offset=offset)
    return _t(U), _t(F), _t(Q), excl, tile


@pytest.mark.parametrize("name", list(CASES))
def test_culled_count_equals_plain_count(name):
    """FULL added whole plus TEST-only tests equals the plain count bit for
    bit, ties and the excluded row included."""
    U, F, Q, excl, tile = _case(name)
    got, classes, _, _ = culled_count(U, F, Q, excl, tile)
    want = ops.rank_count_batch(U, F, Q, exclude=excl)
    assert torch.equal(got, want)
    # the inputs reach the classes (a one-user tile's box is its user, so
    # its classes are exact and never TEST; a single tile is rarely FULL)
    seen = {int(c) for c in classes.unique()}
    assert ref.TILE_SKIP in seen and (ref.TILE_TEST in seen) == (tile > 1)
    assert ref.TILE_FULL in seen or classes.shape[1] == 1


@pytest.mark.parametrize("name", list(CASES))
def test_classes_are_sound(name):
    """SKIP never where some user of the tile is closer, FULL never where
    some user is not."""
    U, F, Q, excl, tile = _case(name)
    _, classes, closer, tile_of = culled_count(U, F, Q, excl, tile)
    n_tiles = classes.shape[1]
    idx = tile_of[None, :, None].expand_as(closer)
    any_closer = torch.zeros(classes.shape, dtype=torch.int32).scatter_add_(
        1, idx, closer.to(torch.int32))
    users_per_tile = torch.bincount(tile_of, minlength=n_tiles)[None, :, None]
    assert not bool(((classes == ref.TILE_SKIP) & (any_closer > 0)).any())
    assert not bool(((classes == ref.TILE_FULL) & (any_closer < users_per_tile)).any())


def test_the_adversarial_inputs_hold_exact_ties():
    """Users whose rounded distance to a facility equals their threshold
    exactly (never closer: the count is strict), and users 1-3 ulps off."""
    U, F, Q, _, _ = _case("unit-256")
    d = _sq(U[:, None, 0], F[None, :, 0]) + _sq(U[:, None, 1], F[None, :, 1])
    thr = _sq(U[None, :, 0], Q[:, None, 0]) + _sq(U[None, :, 1], Q[:, None, 1])
    ties = d[None] == thr[..., None]
    assert int(ties.sum()) > 100
    near = (d[None] != thr[..., None]) & ((d[None] - thr[..., None]).abs()
                                          <= 32 * torch.finfo(torch.float32).eps * thr[..., None])
    assert int(near.sum()) > 10


def test_facilities_on_box_edges_and_corners():
    """Facilities at the corners and on the edges of every sub-tile's box
    (and at users): the nearest box point is the facility itself, so
    ``gmin = 0`` and nothing is SKIP for a positive threshold."""
    U, F, Q, excl, tile = _case("ragged-256")
    order = build_user_order(U[:, 0].contiguous(), U[:, 1].contiguous())
    boxes = tile_boxes(torch.stack([order.xs_s, order.ys_s]), tile)
    mid_x = boxes[:, 0] + (boxes[:, 2] - boxes[:, 0]) * 0.5
    corners = torch.cat([
        torch.stack([boxes[:, 0], boxes[:, 1]], 1), torch.stack([boxes[:, 2], boxes[:, 3]], 1),
        torch.stack([boxes[:, 0], boxes[:, 3]], 1), torch.stack([boxes[:, 2], boxes[:, 1]], 1),
        torch.stack([mid_x, boxes[:, 1]], 1), torch.stack([boxes[:, 0], mid_x.clamp(max=1e9)], 1),
        U[:5],
    ])
    F2 = torch.cat([F, corners]).contiguous()
    got, classes, _, _ = culled_count(U, F2, Q, excl, tile)
    assert torch.equal(got, ops.rank_count_batch(U, F2, Q, exclude=excl))
    own = classes[:, torch.arange(boxes.shape[0]), F.shape[0] + torch.arange(boxes.shape[0])]
    assert not bool((own == ref.TILE_SKIP).any())  # each box's own lower-left corner


def test_rule_boundaries_are_exact():
    """The rules' comparisons at equality: ``gmin == tmax`` is SKIP (no user
    can be strictly closer), ``gmax == tmin`` is not FULL (a user at
    ``gmax`` would not be closer).  Box [0, 1]^2, facility (2, 0):
    ``gmin = 1``, ``gmax = 4 + 1 = 5``."""
    box = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    fx, fy = torch.tensor([2.0]), torch.tensor([0.0])
    up = float(np.nextafter(np.float32(1.0), np.float32(2.0)))

    def cls(tmin, tmax):
        return int(ref.rank_tile_classes_ref(box, torch.tensor([[tmin]]), torch.tensor([[tmax]]),
                                             fx, fy)[0, 0, 0])

    assert cls(0.5, 1.0) == ref.TILE_SKIP
    assert cls(0.5, up) == ref.TILE_TEST
    assert cls(5.0, 6.0) == ref.TILE_TEST
    assert cls(float(np.nextafter(np.float32(5.0), np.float32(6.0))), 6.0) == ref.TILE_FULL


def test_non_finite_thresholds_and_facilities():
    """A NaN threshold makes its tile's classes TEST; a facility at +inf is
    SKIP on a finite box (on a box that reaches +inf, inf - inf makes it
    TEST); a user at infinity or NaN counts as the plain version counts
    it, and a NaN query point counts nothing."""
    rng = np.random.default_rng(9)
    U = rng.random((300, 2)).astype(np.float32)
    U[7] = (np.nan, 0.5)
    U[8] = (np.inf, 0.25)
    U[9] = (-np.inf, -np.inf)
    F = rng.random((40, 2)).astype(np.float32)
    F[3] = (np.inf, np.inf)
    F[4] = (-np.inf, 0.5)
    F[5] = (np.nan, 0.5)
    Q = np.array([[0.5, 0.5], [np.nan, 0.5], [np.inf, 0.0], [-np.inf, 0.3]], np.float32)
    excl = [None, 2, None, 1]
    Ut, Ft, Qt = _t(U), _t(F), _t(Q)
    for tile in (SUB_TILE, 16, 1):
        got, classes, _, _ = culled_count(Ut, Ft, Qt, excl, tile)
        assert torch.equal(got, ops.rank_count_batch(Ut, Ft, Qt, exclude=excl))
        order = build_user_order(Ut[:, 0].contiguous(), Ut[:, 1].contiguous())
        finite = tile_boxes(torch.stack([order.xs_s, order.ys_s]), tile).isfinite().all(1)
        assert bool((classes[[0, 2, 3]][:, finite, 3] == ref.TILE_SKIP).all())
        # thresholds all NaN (row 2 is the query's excluded row)
        assert bool((classes[1][:, torch.arange(F.shape[0]) != 2] == ref.TILE_TEST).all())
    want = ops.rank_count_batch(Ut, Ft, Qt, exclude=excl)
    assert int(want[1].max()) == 0


def test_duplicate_points_and_the_query_at_a_user():
    """Every user at one of a few points, the query on one of them: a
    tile may have a zero-area box and a zero threshold."""
    rng = np.random.default_rng(10)
    pts = rng.random((3, 2)).astype(np.float32)
    U = pts[rng.integers(0, 3, 600)]
    F = np.concatenate([pts, rng.random((20, 2)).astype(np.float32), pts]).astype(np.float32)
    Q = np.concatenate([pts[:2], rng.random((1, 2)).astype(np.float32)])
    excl = [0, None, None]
    for tile in (SUB_TILE, 5):
        got, _, _, _ = culled_count(_t(U), _t(F), _t(Q), excl, tile)
        assert torch.equal(got, ops.rank_count_batch(_t(U), _t(F), _t(Q), exclude=excl))


@pytest.mark.parametrize("n_users,n_fac", [(1, 2), (257, 30), (700, 80)])
def test_rank_count_with_an_order_matches_jax(n_users, n_fac):
    """The CPU path ignores the order and matches the JAX Pallas kernel
    (interpret mode) exactly off near ties, within 1 on them."""
    rng = np.random.default_rng(n_users + 7 * n_fac)
    U = rng.random((n_users, 2))
    F = rng.random((n_fac, 2))
    qi = int(rng.integers(0, n_fac))
    Ut = _t(U.astype(np.float32))
    order = build_user_order(Ut[:, 0].contiguous(), Ut[:, 1].contiguous())
    got = ops.rank_count(_t(U), _t(F), _t(F[qi]), exclude=qi, order=order).numpy()
    assert np.array_equal(got, ops.rank_count(_t(U), _t(F), _t(F[qi]), exclude=qi).numpy())
    pallas = np.asarray(jops.rank_count(U, F, F[qi], exclude=qi, backend="pallas", interpret=True))
    ok = non_tie_mask(U, F, qi)
    for other in (pallas, rank_counts_np(U, F, F[qi], exclude=qi)):
        np.testing.assert_array_equal(got[ok], other[ok])
        assert np.all(np.abs(got - other) <= 1)


def test_rank_count_batch_with_an_order_matches_jax():
    rng = np.random.default_rng(11)
    U, F = rng.random((900, 2)), rng.random((50, 2))
    q_pts = np.concatenate([F[[3, 9, 17]], rng.random((2, 2))])
    excl = [3, 9, 17, -1, None]
    Ut = _t(U.astype(np.float32))
    order = build_user_order(Ut[:, 0].contiguous(), Ut[:, 1].contiguous())
    got = ops.rank_count_batch(_t(U), _t(F), _t(q_pts), exclude=excl, order=order).numpy()
    want = np.asarray(jops.rank_count_batch(U, F, q_pts, exclude=excl))
    assert got.shape == (5, 900) and got.dtype == np.int32
    xy = ops.rank_count_batch_xy(Ut[:, 0], Ut[:, 1], _t(F), _t(q_pts), exclude=excl, order=order)
    np.testing.assert_array_equal(xy.numpy(), got)  # the same counts from strided xs, ys
    for i, qi in enumerate([3, 9, 17]):
        ok = non_tie_mask(U, F, qi)
        np.testing.assert_array_equal(got[i][ok], want[i][ok])
    assert np.all(np.abs(got - want) <= 1)
    for i in range(5):  # each batch row is the single-query count
        e = excl[i] if excl[i] is not None and excl[i] >= 0 else None
        single = ops.rank_count(_t(U), _t(F), _t(q_pts[i]), exclude=e).numpy()
        np.testing.assert_array_equal(got[i], single)


def test_exclude_rows_are_checked_alike_on_every_path():
    """``exclude`` indexes as Python does (``-1`` is the last row) for the
    single query and masks nothing below 0 for the batch; an out-of-range
    row raises before either path runs."""
    U, F = torch.rand(50, 2), torch.rand(6, 2)
    last = ops.rank_count(U, F, F[5], exclude=-1)
    assert torch.equal(last, ops.rank_count(U, F, F[5], exclude=5))
    with pytest.raises(IndexError):
        ops.rank_count(U, F, F[0], exclude=6)
    with pytest.raises(IndexError):
        ops.rank_count_batch(U, F, F[:2], exclude=[0, 6])
    with pytest.raises(ValueError, match="one entry per query"):
        ops.rank_count_batch(U, F, F[:2], exclude=[0])
    a = ops.rank_count_batch(U, F, F[:2], exclude=[-1, -3])
    assert torch.equal(a, ops.rank_count_batch(U, F, F[:2]))


def test_brute_count_batch_matches_jax_engine():
    """``BruteBackend.count_batch`` on the CPU (the engine's device users,
    no order built) equals the JAX engine's brute batch."""
    F, U, _ = instance(12, M=40, N=600)
    qs = [0, 5, np.array([0.3, 0.7]), 17]
    j = JEngine(F, U, JConfig(backend="brute")).query_batch(qs, 4)
    eng = RkNNEngine(F, U, RkNNConfig(backend="brute"), device=CPU)
    rank_count.launches = rank_count.batch_launches = 0
    t = eng.query_batch(qs, 4)
    np.testing.assert_array_equal(t.masks, j.masks)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert (rank_count.launches, rank_count.batch_launches) == (0, 0)
    assert not [k for k in eng._snap.kernel_memo._store if k[0] == "user-order"]
    s = list(eng.stream([qs[:2], qs[2:]], 4))
    np.testing.assert_array_equal(np.concatenate([m for _, m in s]), j.masks)
