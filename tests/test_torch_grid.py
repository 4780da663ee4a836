"""The port's grid family against the JAX package's, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Tolerances:

* host code (the grid index build, refit and stacking, the cell
  bucketing and the plane packers) — bit-identical;
* counts — int32, exactly equal on every user that is not at a
  rounding-level edge tie (``tests/_torch_parity.py: edge_tie_mask``):
  the JAX grid family runs jitted, so XLA contracts ``a*x + b*y + c``
  into fused multiply-adds, while the port rounds every operation (its
  one rounding contract), and at a knife-edge tie the two may split;
* within the port — the grid family's counts equal the port's
  ``dense-ref`` counts bit for bit, with no tie excluded, since all of
  them evaluate edges in one order.

Where the JAX function reaches its Pallas kernel it runs in interpret
mode on a 200-user subsample, as ``tests/test_grid_pallas.py`` does.
The CUDA kernel itself is held against its plain version by
``tests/test_torch_cuda.py`` (skips without a card) and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import grid as jgrid
from repro.core.backends import BatchRequest as JBatchRequest
from repro.core.backends import get_backend as j_get_backend
from repro.core.backends import stack_cell_planes as j_stack_cell_planes
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.core.geometry import Rect as JRect
from repro.core.geometry import edge_coeffs
from repro.core.scene import build_scene as j_build_scene
from repro.kernels import grid_raycast as jgr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.workloads import SCENARIOS
from repro_torch.core import grid as tgrid
from repro_torch.core.backends import QueryRequest, get_backend, stack_cell_planes
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.scene import scene_from_arrays
from repro_torch.kernels import build, grid_raycast, ops, ref

from tests._torch_parity import CPU, edge_tie_mask

GRID_BACKENDS = ("grid", "grid-pallas", "grid-pallas-ref")
SCALE = 0.02
UNIT = (0.0, 0.0, 1.0, 1.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _trect(r) -> Rect:
    return Rect(r.xmin, r.ymin, r.xmax, r.ymax)


def _grids(sc, G):
    """The same scene's grid index from both packages."""
    args = (sc.tris[: sc.n_tris], sc.coeffs[: sc.n_tris])
    return jgrid.build_grid(*args, sc.rect, G=G), tgrid.build_grid(*args, _trect(sc.rect), G=G)


def assert_grids_equal(a, b):
    for field in ("base", "lists", "coeffs"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype, field
    assert a.G == b.G
    assert dataclasses.astuple(a.rect) == dataclasses.astuple(b.rect)


def _nudged(sc, changed, delta=1e-7):
    """``sc`` with the triangles ``changed`` moved by ``delta`` (and their
    edge functions recomputed), the refit contract's input."""
    tris = sc.tris.copy()
    tris[changed] = (tris[changed] + delta).astype(np.float32)
    coeffs = sc.coeffs.copy()
    coeffs[changed] = edge_coeffs(tris[changed].astype(np.float64)).astype(np.float32)
    return dataclasses.replace(sc, tris=tris, coeffs=coeffs)


def _assert_off_ties(got, want, U, scenes, *, max_tie_frac=1e-2):
    """``[Q, N]`` counts (or masks) equal on every user off an edge tie of
    the query's scene; ties must stay rare."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    xs, ys = U[:, 0].astype(np.float32), U[:, 1].astype(np.float32)
    for i, sc in enumerate(scenes):
        ties = edge_tie_mask(xs, ys, sc.coeffs[: sc.n_tris])
        assert ties.mean() <= max_tie_frac
        np.testing.assert_array_equal(got[i][~ties], want[i][~ties], err_msg=f"query {i}")


# ---- host code, bit-identical ---------------------------------------------


@pytest.mark.parametrize("strategy", ["infzone", "conservative", "none"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_build_refit_stack_grid_bit_identical(scenario, strategy):
    w = SCENARIOS[scenario].generate(SCALE)
    sc = j_build_scene(w.facilities, w.qs[0], w.k, strategy=strategy, users_hint=w.users)
    changed = np.array([0, sc.n_tris - 1], np.int64)
    moved = _nudged(sc, changed)
    for G in (8, 16, 64):
        jg, tg = _grids(sc, G)
        assert_grids_equal(jg, tg)
        assert tg.occupancy() == jg.occupancy() and tg.max_list == jg.max_list
        n = sc.n_tris
        args = (sc.tris[:n], sc.coeffs[:n], moved.tris[:n], moved.coeffs[:n], changed)
        jr, tr = jgrid.refit_grid(jg, *args), tgrid.refit_grid(tg, *args)
        assert (jr is None) == (tr is None)
        if tr is not None:
            assert_grids_equal(jr, tr)
        jb, tb = jgrid.stack_grids([jg, jr or jg]), tgrid.stack_grids([tg, tr or tg])
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_shape_bucket_and_grid_from_arrays():
    for x in (0, 1, 7, 8, 9, 15, 16, 17, 100, 1000, 4097):
        for floor in (1, 8):
            assert tgrid.shape_bucket(x, floor) == jgrid.shape_bucket(x, floor)
    w = SCENARIOS["uniform_mix"].generate(SCALE)
    sc = j_build_scene(w.facilities, w.qs[1], w.k, users_hint=w.users)
    jg, tg = _grids(sc, 16)
    carried = tgrid.grid_from_arrays(jg.base, jg.lists, jg.coeffs, jg.G, jg.rect)
    assert_grids_equal(carried, tg)
    assert isinstance(carried, tgrid.OccluderGrid) and isinstance(carried.rect, Rect)
    assert carried.base is not jg.base
    with pytest.raises(ValueError, match="share G"):
        tgrid.stack_grids([tg, tgrid.build_grid(sc.tris[:0], sc.coeffs[:0], tg.rect, G=8)])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cell_bucketing_and_plane_packing_bit_identical(scenario):
    w = SCENARIOS[scenario].generate(SCALE)
    rect = JRect.from_points(w.facilities, w.users)
    xs, ys = w.users[:, 0], w.users[:, 1]
    for G in (8, 16, 64):
        assert grid_raycast.measured_pad_waste(xs, ys, _trect(rect), G) == jgr.measured_pad_waste(
            xs, ys, rect, G
        )
        for block in (None, 8, 128):
            a = jgr.prepare_cell_buckets(xs, ys, rect, G, block=block)
            b = grid_raycast.prepare_cell_buckets(xs, ys, _trect(rect), G, block=block)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype
    for n, occ in ((0, 0), (1, 1), (1200, 7), (10_000, 40), (10**6, 3)):
        assert grid_raycast.auto_cell_block(n, occ) == jgr.auto_cell_block(n, occ)

    sc = j_build_scene(w.facilities, w.qs[0], w.k, strategy="none", users_hint=w.users)
    jg, tg = _grids(sc, 16)
    # the port packs without a lane tile: JAX's unpadded (lane_pad=1) form
    planes = grid_raycast.pack_cell_coeff_planes(tg)
    np.testing.assert_array_equal(planes, jgr.pack_cell_coeff_planes(jg, lane_pad=1))
    cells = np.array([0, 5, 17, 255])
    np.testing.assert_array_equal(
        grid_raycast.repack_cell_coeff_planes(planes, tg, cells),
        jgr.repack_cell_coeff_planes(planes, jg, cells),
    )
    # heterogeneous lane widths
    small = grid_raycast.pack_cell_coeff_planes(_grids(sc, 16)[1])[:, :, :, :3]
    for stack in ([planes, small], [small, planes], [planes, planes]):
        np.testing.assert_array_equal(stack_cell_planes(stack), j_stack_cell_planes(stack))


def test_unsort_cell_counts_matches_jax():
    rng = np.random.default_rng(2)
    U = rng.random((333, 2))
    rect = JRect(*UNIT)
    _xs_s, _ys_s, order, _cm, _nb = jgr.prepare_cell_buckets(U[:, 0], U[:, 1], rect, 8, block=16)
    counts = rng.integers(0, 50, (3, len(order))).astype(np.int32)
    want = jgr.unsort_cell_counts(counts, order, len(U))
    index = _t(grid_raycast.unsort_index(order, len(U)))
    got = grid_raycast.unsort_cell_counts(_t(counts), index)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(grid_raycast.unsort_cell_counts(_t(counts[1]), index).numpy(), want[1])


# ---- counts, exact off edge ties --------------------------------------------


@pytest.mark.parametrize("scenario", ["dense_facility", "gaussian", "large_k"])
def test_grid_hit_counts_match_jnp_and_dense(scenario):
    w = SCENARIOS[scenario].generate(SCALE)
    U = w.users
    xs, ys = _t(U[:, 0].astype(np.float32)), _t(U[:, 1].astype(np.float32))
    scenes, jgs, tgs = [], [], []
    for i, strategy in enumerate(("none", "infzone", "conservative")):
        sc = j_build_scene(w.facilities, w.qs[i], w.k, strategy=strategy, users_hint=U)
        jg, tg = _grids(sc, 16)
        scenes.append(sc), jgs.append(jg), tgs.append(tg)
        got = tgrid.grid_hit_counts_torch(xs, ys, tg.base, tg.lists, tg.coeffs, tg.rect, 16)
        want = jgrid.grid_hit_counts_jnp(
            U[:, 0].astype(np.float32), U[:, 1].astype(np.float32),
            jg.base, jg.lists, jg.coeffs, jg.rect, 16,
        )
        assert got.dtype == torch.int32 and got.shape == (len(U),)
        _assert_off_ties(got.numpy(), np.asarray(want), U, [sc])
        dense = ops.raycast_count(xs, ys, _t(sc.coeffs), backend="ref")
        assert torch.equal(got, dense)
    got_b = tgrid.grid_hit_counts_batch_torch(xs, ys, *map(_t, tgrid.stack_grids(tgs)), tgs[0].rect, 16)
    want_b = jgrid.grid_hit_counts_batch_jnp(
        U[:, 0].astype(np.float32), U[:, 1].astype(np.float32), *jgrid.stack_grids(jgs), jgs[0].rect, 16
    )
    _assert_off_ties(got_b.numpy(), np.asarray(want_b), U, scenes)
    for i, tg in enumerate(tgs):
        np.testing.assert_array_equal(
            got_b[i].numpy(),
            tgrid.grid_hit_counts_torch(xs, ys, tg.base, tg.lists, tg.coeffs, tg.rect, 16).numpy(),
        )


def test_grid_hit_counts_chunked_and_occluder_free(monkeypatch):
    rng = np.random.default_rng(9)
    F, U = rng.random((120, 2)), rng.random((5000, 2)).astype(np.float32)
    sc = j_build_scene(F, 0, 6, JRect(*UNIT), strategy="none")
    _, tg = _grids(sc, 8)
    xs, ys = _t(U[:, 0]), _t(U[:, 1])
    whole = tgrid.grid_hit_counts_torch(xs, ys, tg.base, tg.lists, tg.coeffs, tg.rect, 8)
    monkeypatch.setattr(tgrid, "_GATHER_ELEMS", 9 * tg.lists.shape[1] * 700)
    chunked = tgrid.grid_hit_counts_torch(xs, ys, tg.base, tg.lists, tg.coeffs, tg.rect, 8)
    assert torch.equal(whole, chunked)
    assert torch.equal(whole, ops.raycast_count(xs, ys, _t(sc.coeffs)))
    empty = tgrid.build_grid(sc.tris[:0], sc.coeffs[:0], tg.rect, G=8)
    got = tgrid.grid_hit_counts_torch(xs, ys, empty.base, empty.lists, empty.coeffs, empty.rect, 8)
    assert torch.equal(got, torch.zeros(len(U), dtype=torch.int32))
    batch = tgrid.grid_hit_counts_batch_torch(xs, ys, *tgrid.stack_grids([empty, empty]), tg.rect, 8)
    assert batch.shape == (2, len(U)) and not batch.any()


def _cells_inputs(seed, n_fac, n_users, G, block, q_n):
    """Non-pruned scenes' grids, bucketed users and the stacked occupied
    planes, as the grid-pallas backend prepares a batch."""
    rng = np.random.default_rng(seed)
    F, U = rng.random((n_fac, 2)), rng.random((n_users, 2))
    rect = JRect(*UNIT)
    scenes = [j_build_scene(F, qi, 6, rect, strategy="none") for qi in range(q_n)]
    grids = [_grids(sc, G) for sc in scenes]
    xs_s, ys_s, order, cell_map, nb = jgr.prepare_cell_buckets(U[:, 0], U[:, 1], rect, G, block=block)
    occ = np.unique(cell_map)
    ranks = np.searchsorted(occ, cell_map).astype(np.int32)
    planes = j_stack_cell_planes([jgr.pack_cell_coeff_planes(jg, lane_pad=1)[occ] for jg, _ in grids])
    base = np.stack([jg.base[occ] for jg, _ in grids])
    return U, scenes, grids, (xs_s, ys_s, order, ranks, len(xs_s) // max(nb, 1)), base, planes


def test_grid_count_cells_batch_matches_jax_ref_and_pallas(monkeypatch):
    U, scenes, _, (xs_s, ys_s, order, ranks, block), base, planes = _cells_inputs(
        5, 90, 200, 8, None, 3
    )
    got = ops.grid_count_cells_batch(_t(xs_s), _t(ys_s), _t(ranks), _t(base), _t(planes), block=block)
    assert got.dtype == torch.int32 and got.shape == (3, len(xs_s))
    unsorted = grid_raycast.unsort_cell_counts(got, _t(grid_raycast.unsort_index(order, len(U)))).numpy()
    for backend in ("ref", "pallas"):
        want = jops.grid_count_cells_batch(
            xs_s, ys_s, ranks, base, planes, block=block, backend=backend, interpret=True
        )
        _assert_off_ties(unsorted, jgr.unsort_cell_counts(np.asarray(want), order, len(U)), U, scenes)
    for i, sc in enumerate(scenes):  # bit-identical to the port's dense count
        want_i = ops.raycast_count(
            _t(U[:, 0].astype(np.float32)), _t(U[:, 1].astype(np.float32)), _t(sc.coeffs)
        ).numpy()
        np.testing.assert_array_equal(unsorted[i], want_i)
    # block-chunked plain path == one chunk
    monkeypatch.setattr(ops, "_CELL_CHUNK_ELEMS", 3 * block * planes.shape[-1] * 2)
    chunked = ops.grid_count_cells_batch(_t(xs_s), _t(ys_s), _t(ranks), _t(base), _t(planes), block=block)
    assert torch.equal(chunked, got)
    single = ops.grid_count_cells(_t(xs_s), _t(ys_s), _t(ranks), _t(base[1]), _t(planes[1]), block=block)
    assert torch.equal(single, got[1])


@pytest.mark.parametrize("G,block", [(8, 128), (16, 128), (16, 256), (32, 128)])
def test_grid_count_cells_matches_jax_grid_raycast_cells(G, block):
    """The single-query kernel's contract (``base`` added), on the port's
    plain path, against the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(G * 1000 + block)
    F, U = rng.random((200, 2)), rng.random((1000, 2))
    sc = j_build_scene(F, 0, 10, JRect(*UNIT), strategy="none")
    jg, tg = _grids(sc, G)
    bucket = jgr.prepare_cell_buckets(U[:, 0], U[:, 1], jg.rect, G, block=block)
    xs_s, ys_s, order, cell_map, _nb = bucket
    planes = jgr.pack_cell_coeff_planes(jg)
    want = np.asarray(
        jgr.grid_raycast_cells(xs_s, ys_s, cell_map, jg.base, planes, block=block, interpret=True)
    )
    got = ops.grid_count_cells(
        _t(xs_s), _t(ys_s), _t(cell_map), _t(tg.base),
        _t(grid_raycast.pack_cell_coeff_planes(tg)), block=block,
    ).numpy()
    _assert_off_ties(
        jgr.unsort_cell_counts(got, order, len(U)), jgr.unsort_cell_counts(want, order, len(U)), U, [sc]
    )
    # JAX's planes, padded to its 128-lane tile, count the same: padded
    # lanes are degenerate
    padded = ops.grid_count_cells(
        _t(xs_s), _t(ys_s), _t(cell_map), _t(tg.base), _t(planes), block=block
    ).numpy()
    np.testing.assert_array_equal(padded, got)
    # the plain grid oracle of both packages
    x32, y32 = U[:, 0].astype(np.float32), U[:, 1].astype(np.float32)
    lo, size = (jg.rect.xmin, jg.rect.ymin), (jg.rect.width, jg.rect.height)
    j_or = np.asarray(jref.grid_raycast_ref(x32, y32, jg.base, jg.lists, jg.coeffs, lo, size, G))
    t_or = ref.grid_raycast_ref(
        _t(x32), _t(y32), _t(tg.base), _t(tg.lists), _t(tg.coeffs), lo, size, G
    ).numpy()
    _assert_off_ties(t_or, j_or, U, [sc])
    np.testing.assert_array_equal(jgr.unsort_cell_counts(got, order, len(U)), t_or)


def test_cpu_path_takes_the_plain_version_and_no_kernel():
    _U, _scenes, _g, (xs_s, ys_s, _order, ranks, block), base, planes = _cells_inputs(
        1, 30, 100, 8, 16, 2
    )
    ref.calls = grid_raycast.batch_launches = grid_raycast.single_launches = 0
    ops.grid_count_cells_batch(_t(xs_s), _t(ys_s), _t(ranks), _t(base), _t(planes), block=block)
    ops.grid_count_cells(_t(xs_s), _t(ys_s), _t(ranks), _t(base[0]), _t(planes[0]), block=block)
    ops.grid_count_cells_batch(
        _t(xs_s), _t(ys_s), _t(ranks), _t(base), _t(planes), block=block, backend="ref"
    )
    assert ref.calls == 3
    assert (grid_raycast.batch_launches, grid_raycast.single_launches) == (0, 0)
    empty = ops.grid_count_cells_batch(
        torch.zeros(0), torch.zeros(0), torch.zeros(0, dtype=torch.int32), _t(base), _t(planes), block=8
    )
    assert empty.shape == (2, 0) and empty.dtype == torch.int32 and ref.calls == 3


def test_kernel_wrappers_refuse_cpu_tensors_and_build_lists_the_source():
    x = torch.zeros(8)
    cm = torch.zeros(1, dtype=torch.int32)
    lens, boxes = torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        grid_raycast.grid_raycast_cells_batch(x, x, cm, torch.zeros(1, 1, 3, 3, 2), block=8,
                                              lens=lens, boxes=boxes)
    with pytest.raises(ValueError, match="CUDA"):
        grid_raycast.grid_raycast_cells(
            x, x, cm, torch.zeros(1, dtype=torch.int32), torch.zeros(1, 3, 3, 2), block=8,
            lens=lens[0], boxes=boxes,
        )
    with pytest.raises(ValueError, match="unknown backend"):
        ops.grid_count_cells(x, x, cm, torch.zeros(1), torch.zeros(1, 3, 3, 2), block=8,
                             backend="pallas")
    assert "grid_raycast" in build.SOURCES
    assert (build.CSRC / "grid_raycast.cu").is_file()


# ---- engine, equal masks and counts ----------------------------------------


def _carry_filter_state(j, t):
    """Feed the port engine ``t`` the scenes and grid indexes that the JAX
    engine ``j`` built, through :func:`scene_from_arrays` and
    :func:`grid_from_arrays`: their builds are held bit-identical above
    (and in ``tests/test_torch_filter.py``), so a sweep pays each host
    build once and compares the verify paths on one identical input."""
    fp = t._snap.fingerprint()
    for (_fp, q, k, rect), j_sc in j.scene_cache._store.items():
        sc = scene_from_arrays(j_sc)
        t.scene_cache._store[(fp, q, k, _trect(rect))] = sc
        store = t._snap.index_memo.store_for(sc)
        for key, g in j._snap.index_memo.store_for(j_sc).items():
            if key[0] == "grid":
                store[key] = tgrid.grid_from_arrays(g.base, g.lists, g.coeffs, g.G, g.rect)


#: The regimes with the longest cell lists: where the JAX Pallas kernel
#: also runs (interpret mode, 200-user subsample, Q = 16).
PALLAS_SCENARIOS = ("dense_facility", "large_k")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenarios_match_jax_and_the_ports_dense_count(scenario):
    """Every paper regime at Q in {64, 16, 1}: the port's three grid
    backends against the JAX engine's ``grid`` (off edge ties) and against
    the port's own ``dense-ref`` (bit for bit).  The 64 queries repeat 16
    distinct facilities (the host builds of a scene dominate this test, not
    the batch) and the Q = 64 list prefixes the others, so each scene and
    index is built once.  On :data:`PALLAS_SCENARIOS` the JAX
    ``grid-pallas`` kernel runs through its backend on the same scenes, on
    a 200-user subsample: a user's count does not depend on the other
    users.  ``tests/test_torch_engine.py`` holds each grid backend against
    the JAX engine's backend of the same name."""
    w = SCENARIOS[scenario].generate(SCALE)
    rng = np.random.default_rng(64)
    pool = rng.choice(len(w.facilities), 16, replace=False)
    qs = [int(i) for i in pool[rng.integers(0, 16, 64)]]
    j = JEngine(w.facilities, w.users, JConfig(backend="grid"))
    t = RkNNEngine(w.facilities, w.users, RkNNConfig(backend="grid"), device=CPU)
    want64 = j.query_batch(qs, w.k)
    _carry_filter_state(j, t)
    for q_n in (64, 16, 1):
        want = want64 if q_n == 64 else j.query_batch(qs[:q_n], w.k)
        dense = t.query_batch(qs[:q_n], w.k, backend="dense-ref")
        for name in GRID_BACKENDS:
            got = t.query_batch(qs[:q_n], w.k, backend=name)
            assert got.counts.dtype == np.int32 and got.backend == name
            np.testing.assert_array_equal(got.counts, dense.counts, err_msg=f"{name} {q_n}")
            np.testing.assert_array_equal(got.masks, dense.masks)
        _assert_off_ties(got.counts, want.counts, w.users, got.scenes)
        _assert_off_ties(got.masks, want.masks, w.users, got.scenes)
        if q_n == 16 and scenario in PALLAS_SCENARIOS:
            sub = w.users[:200]
            j_pallas = j_get_backend("grid-pallas")
            req = JBatchRequest(
                xs=sub[:, 0].astype(np.float32), ys=sub[:, 1].astype(np.float32), k=w.k,
                rect=want.scenes[0].rect, scenes=want.scenes,
                indexes=[j_pallas.build_index(s) for s in want.scenes],
            )
            pallas = j_pallas.count_batch(req, j_pallas.prepare_batch(req))
            _assert_off_ties(got.counts[:, :200], pallas, sub, got.scenes)
    assert t.scene_cache.misses == 0
    one = t.query(qs[0], w.k, backend="grid-pallas")
    np.testing.assert_array_equal(one.counts, dense.counts[0])


def test_empty_scene_counts_zero():
    rng = np.random.default_rng(0)
    F, U = rng.random((1, 2)), rng.random((300, 2))
    for name in GRID_BACKENDS:
        res = RkNNEngine(F, U, RkNNConfig(backend=name), device=CPU).query(0, 3)
        want = JEngine(F, U, JConfig(backend=name if name != "grid-pallas" else "grid")).query(0, 3)
        assert res.scene.n_tris == 0
        np.testing.assert_array_equal(res.counts, np.zeros(len(U), np.int32))
        np.testing.assert_array_equal(res.counts, want.counts)
        assert res.mask.all()


def test_saturated_cells_match_jax():
    rng = np.random.default_rng(3)
    F, U = rng.random((250, 2)), rng.random((800, 2))
    k = 5
    cfg = dict(strategy="none", grid_g=16)
    j = JEngine(F, U, JConfig(backend="grid", **cfg))
    t = RkNNEngine(F, U, RkNNConfig(backend="grid", **cfg), device=CPU)
    want = j.query_batch([0, 7], k)
    g = get_backend("grid").build_index(t.query_batch([0], k).scenes[0], grid_g=16)
    assert g.base.max() >= k  # the regime is actually present
    dense = t.query_batch([0, 7], k, backend="dense-ref")
    for name in GRID_BACKENDS:
        got = t.query_batch([0, 7], k, backend=name)
        np.testing.assert_array_equal(got.counts, dense.counts, err_msg=name)
        _assert_off_ties(got.counts, want.counts, U, got.scenes)
        np.testing.assert_array_equal(got.masks, want.masks)


@pytest.mark.parametrize("name", ["grid-pallas", "grid-pallas-ref"])
def test_refit_index_incremental_replane_matches_jax(name):
    rng = np.random.default_rng(11)
    F, U = rng.random((60, 2)), rng.random((500, 2))
    j_sc = j_build_scene(F, 0, 8, JRect(*UNIT), strategy="none")
    sc = scene_from_arrays(j_sc)
    backend, j_backend = get_backend(name), j_get_backend("grid-pallas-ref")
    assert j_backend.lane_pad == 1  # JAX's interpret-mode packing, the port's
    old_idx = backend.build_index(sc, grid_g=16)
    j_old = j_backend.build_index(j_sc, grid_g=16)
    assert old_idx._cell_planes is not None  # packed eagerly

    changed = np.array([2, 9], np.int64)
    new_sc, j_new_sc = scene_from_arrays(_nudged(j_sc, changed)), _nudged(j_sc, changed)
    new_idx, was_refit = backend.refit_index(old_idx, sc, new_sc, changed, grid_g=16)
    j_idx, j_refit = j_backend.refit_index(j_old, j_sc, j_new_sc, changed, grid_g=16)
    assert was_refit and j_refit
    assert_grids_equal(j_idx, new_idx)
    fresh = grid_raycast.pack_cell_coeff_planes(new_idx)
    np.testing.assert_array_equal(new_idx._cell_planes, fresh)
    np.testing.assert_array_equal(new_idx._cell_planes, j_idx._cell_planes[1])
    xs, ys = _t(U[:, 0].astype(np.float32)), _t(U[:, 1].astype(np.float32))
    req = dict(xs=xs, ys=ys, k=8, device=CPU, grid_g=16, scene=new_sc)
    got = backend.count(QueryRequest(**req, index=new_idx))
    cold = backend.count(QueryRequest(**req))
    np.testing.assert_array_equal(got, cold)
    np.testing.assert_array_equal(got, ops.raycast_count(xs, ys, _t(new_sc.coeffs)).numpy())
    # a large move overflows a saturated cell list: rebuild, still exact
    rebuilt, refit = backend.refit_index(old_idx, sc, scene_from_arrays(_nudged(j_sc, changed, 0.2)),
                                         changed, grid_g=16)
    j_rebuilt, j_refit2 = j_backend.refit_index(j_old, j_sc, _nudged(j_sc, changed, 0.2), changed,
                                                grid_g=16)
    assert refit == j_refit2
    assert_grids_equal(j_rebuilt, rebuilt)


def test_bucket_memo_reused_across_batches_and_kept_on_device():
    rng = np.random.default_rng(5)
    F, U = rng.random((30, 2)), rng.random((400, 2))
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas-ref"), device=CPU)
    first = eng.query_batch([1, 2], 4)
    memo = eng._snap.kernel_memo
    keys = [k for k in memo._store if k[0] == "gp-buckets" and k[2] == len(U)]
    assert len(keys) == 1
    entry = memo.get(keys[0])
    pinned, buckets = entry
    assert pinned is eng.xs
    assert all(isinstance(t, torch.Tensor) and t.device == CPU
               for t in (buckets.xs_s, buckets.ys_s, buckets.ranks, buckets.unsort, buckets.boxes))
    # JAX's bucketing, then the port's Morton order inside each cell run
    j = jgr.prepare_cell_buckets(U[:, 0], U[:, 1], eng.rect, 64, block=None)
    j_ranks = _t(np.searchsorted(np.unique(j[3]), j[3]).astype(np.int32))
    assert torch.equal(buckets.ranks, j_ranks) and buckets.block * j[4] == len(j[0])
    xs_s, ys_s, order = grid_raycast.order_cell_runs(_t(j[0]), _t(j[1]), _t(j[2]), j_ranks,
                                                     buckets.block, eng.rect)
    assert torch.equal(buckets.xs_s, xs_s) and torch.equal(buckets.ys_s, ys_s)
    assert torch.equal(buckets.unsort, grid_raycast.unsort_index(order, len(U)))
    assert torch.equal(buckets.boxes, grid_raycast.block_boxes(xs_s, ys_s, buckets.block))
    eng.query_batch([3, 4], 4)  # different queries, same user sort
    eng.query(5, 4)
    assert memo.get(keys[0]) is entry and len(memo) == 1
    eng.query_batch([1, 2], 4, backend="grid-pallas")  # the sibling backend shares it
    assert memo.get(keys[0]) is entry
    np.testing.assert_array_equal(first.masks, JEngine(F, U).query_batch([1, 2], 4).masks)
    # the index memo is keyed by (backend, G); the three backends share one grid build
    store = eng._snap.index_memo.store_for(first.scenes[0])
    assert ("grid-pallas-ref", 64) in store and ("grid", 64) in store
    assert store[("grid-pallas-ref", 64)] is store[("grid-pallas", 64)] is store[("grid", 64)]


def test_grid_g_reaches_the_index_and_shims():
    from repro.core.rknn import rt_rknn_query_batch as j_batch
    from repro_torch.core import rknn as trknn

    rng = np.random.default_rng(8)
    F, U = rng.random((50, 2)), rng.random((300, 2))
    for G in (8, 32):
        res = trknn.rt_rknn_query_batch(F, U, [0, 3], 4, backend="grid-pallas", grid_g=G, device=CPU)
        want = j_batch(F, U, [0, 3], 4, backend="grid", grid_g=G)
        np.testing.assert_array_equal(res.masks, want.masks)
        one = trknn.rt_rknn_query(F, U, 3, 4, backend="grid", grid_g=G, device=CPU)
        np.testing.assert_array_equal(one.counts, res.counts[1])
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", grid_g=8), device=CPU)
    res = eng.query_batch([0], 4)
    assert eng._snap.index_memo.store_for(res.scenes[0])[("grid", 8)].G == 8


def test_grid_backends_default_to_cuda_and_never_fall_back():
    rng = np.random.default_rng(1)
    F, U = rng.random((10, 2)), rng.random((20, 2))
    if torch.cuda.is_available():
        assert RkNNEngine(F, U, RkNNConfig(backend="grid-pallas")).device.type == "cuda"
        return
    for name in GRID_BACKENDS:
        with pytest.raises(RuntimeError, match="cuda"):
            RkNNEngine(F, U, RkNNConfig(backend=name))
    xs = torch.zeros(4)
    req = QueryRequest(xs=xs, ys=xs, k=1, device=torch.device("cuda"))
    req.xs = type("FakeCuda", (), {"shape": (4,), "device": torch.device("cuda")})()
    with pytest.raises(ValueError, match="host copy"):
        get_backend("grid-pallas")._buckets_for(req, Rect(*UNIT), 8)
