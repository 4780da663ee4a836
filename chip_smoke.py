#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA card at the size of the paper's
CAL road network (Table 1): 1,890,815 points, of which |F| = 1000 are
facilities and the rest users, k = 10, batches of Q = 64 facility
queries.  It builds every CUDA kernel from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, and drives
``RkNNEngine`` with the launch counters set to 0 just before each path and
read just after:

* ``main_path`` — the dense backend (``query_batch``, ``stream``,
  ``query``, ``query_mono``), its masks checked against the rank-count
  oracle at full size;
* ``grid_path`` — the same engine through ``grid-pallas`` (the
  cell-bucketed grid kernel), its masks and counts equal to the dense
  ones;
* ``grid_nonpruned`` — a second engine without pruning (``strategy=
  "none"``, one occluder per competitor: the regime the grid index is
  for) on the same Q = 64 batch, ``grid-pallas`` and ``dense`` both
  against the oracle;
* ``bvh_path`` — the main path's engine and batch through ``bvh`` (the
  paper's LBVH walk, the CUDA stack-traversal kernel with an early exit
  at k; ``query`` and ``query_mono`` too), its masks equal to the dense
  ones and its counts to ``min(dense, k)`` off edge ties;
* ``bvh_nonpruned`` — the ``grid_nonpruned`` engine's 64 scenes (999
  triangles each), reused, through ``bvh``, with the same checks;
* ``scenarios`` — each of the paper's regimes
  (``repro_torch.workloads.SCENARIOS``, at most 60,000 users) through
  ``dense``, ``grid-pallas``, ``bvh`` and ``brute``, every backend's masks
  against a float64 rank oracle that shares no code with the port;
* ``planner`` — the query planner on the main path's engine: a calibration
  on the card (``planner_calibration``: each shape's and backend's filter
  and verify seconds, the fingerprint, which must name the card), the
  committed profile of this runner class loaded strictly, the CAL batch
  priced with the fresh profile next to the observed times of the same
  batch forced through each backend (``planner_pricing``), then
  ``query_batch``, ``query``, ``stream`` and ``query_mono`` through
  ``auto``, a batch dealt over the four kernel backends and an
  online-recalibrating engine (``planner_auto``): masks against the rank
  oracle, every dispatched backend's kernel launched, no plain call;
* ``dynamic`` — the dynamic-data subsystem (``repro_torch.dynamic``): one
  ``DynamicEngine`` on the CAL users and the facilities plus four corners
  takes the bench's four update streams, 2 steps each; every version's
  batch through its backends' kernels, bit-identical to a cold engine and
  held against the rank kernel; the user scatter on the card; two
  continuous queries against the rank kernel and a cold recount (see
  :func:`_dynamic`).

Wherever the grid and dense paths both count, their counts must be equal
on every user: the port evaluates every edge with one rounding order.
The ``raycast_tiles`` line logs what the dense kernel's tile classifier
does at the main path's shapes (shares of SKIP, FULL and TEST pairs, from
its plain twin, and the operations terms of all-pairs and of TEST-only
tests), the time to build the users' spatial order at the main path's
and at the mono path's size, the verify time of the one-shot shim
``rt_rknn_query`` (a fresh engine, and so a fresh order, on every call),
and the kernel's time without the gather back to the users' order.  The
``grid_tiles`` line logs the same for the grid kernel at the grid path's
and at the non-pruned shapes: the shares of SKIP, FULL and TEST (query,
user block, listed triangle) pairs from the plain twin of its per-block
classifier, the tests that the lanes walked, the real (user, listed
triangle) pairs and the TEST pairs' users each need, with their
operations terms, and the time to order the users inside each cell run.
The rank-count kernel is the main path's exactness oracle: launched once
per query (Pallas row 5) and once over the whole batch through its query
axis (``rank_count_batch``), which must agree bit for bit.  The
``rank_tiles`` line logs what its facility classifier does (shares of
SKIP, FULL and TEST (query, sub-tile, facility) pairs from its plain twin,
at its sub-tile of 256 users, with the user tests the TEST pairs need),
and the kernel's device time alone (a CUDA graph of launches, without the
wrapper's host work) at the wrapper's cut of the facilities into splits.
The BVH kernel (one walk per warp for a span of 128 users, 4 a lane) is
held against its plain version (one walk per user) over all 64 queries
at both shapes and at Q = 1, its counts bit for bit and, from its
counting instance, each user's pops (internal nodes and leaves) equal;
the ``bvh_tiles`` line logs the nodes each user popped (mean, 99th
percentile, most), the share of users that stopped at k, the lane
efficiency, the nodes the warps took against their busiest users' pops,
and the host time of the 64 BVH builds and of their stacking.

    python3 chip_smoke.py [--seed 0]

Lines of its standard output: one per phase, then a JSON object of the
kernels' numbers, then the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the run
exits non-zero without that last line; so does a run without a card, or
one outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_POINTS = 1_890_815  # CAL, paper Table 1
N_FACILITIES = 1_000  # the paper's default |F|
K = 10
Q = 64
STREAM_BATCHES = 4
MONO_POINTS = 20_000
TIE_EPS = 1e-6  # the JAX package's near-tie rule (tests/test_kernels.py)
RANK_CHECK_QUERIES = 8  # rank kernel against its plain version
RANK_SUB_TILE = 256  # users a warp of the rank kernel classifies for
GRID_G = 64  # the engine's default grid raster
# H100 SXM peaks at the full 700 W power limit.  Bytes: the data sheet.
# Operations: the kernels keep one rounding per operation (no multiply and
# add fuse), so each FLOP takes one FP32 issue slot: 132 SMs x 128 lanes x
# 1.98 GHz, half the data sheet's 67 TFLOP/s, which counts an FMA as two.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_OPS_S = 132 * 128 * 1.98e9
# Operations the BVH walk's function needs on each node a lane pops, as
# the other rows count a triangle test: a leaf's three edges of two
# multiplies and two adds, an internal node's two child boxes of four
# compares.  The kernel counts the two kinds of pops (its pops output).
BVH_OPS_PER_LEAF = 12
BVH_OPS_PER_INNER = 8
SCENARIO_MAX_USERS = 60_000


def _log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _sync_ms(fn, reps: int, dev) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps: int, dev) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` runs captured in one
    CUDA graph and replayed, so the host's work per call is not timed."""
    import torch

    fn()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()  # warm-up on a side stream, as graph capture asks
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def _host_ms(fn, reps: int, dev) -> float:
    """Mean wall milliseconds of ``fn()`` ending in a synchronize (for work
    that blocks the host, such as a device-to-host copy)."""
    import torch

    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _tile_classes(order, coeffs, real_slots: int) -> dict:
    """Shares of SKIP / FULL / TEST (tile, triangle slot) pairs from the
    plain twin of the ray-cast kernel's classifier, over all slots and over
    the ``real_slots`` real triangles; the per-user tests the TEST pairs
    need (users of the tile per TEST pair); and the operations terms (12
    a test) of testing every (user, real triangle) and of those tests."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.user_order import TILE_USERS

    classes = ref.raycast_tile_classes_ref(order.boxes, coeffs)  # [Q, T, Mp]
    pairs = classes.numel()
    n_tiles = order.boxes.shape[0]
    users = torch.full((n_tiles,), float(TILE_USERS), dtype=torch.float64, device=coeffs.device)
    users[-1] = order.xs_s.shape[0] - (n_tiles - 1) * TILE_USERS
    test = classes == ref.TILE_TEST
    skip_n = int((classes == ref.TILE_SKIP).sum())
    full_n = int((classes == ref.TILE_FULL).sum())
    padding_pairs = (coeffs.shape[0] * coeffs.shape[1] - real_slots) * n_tiles  # always SKIP
    user_tests = float((test.to(torch.float64) * users[None, :, None]).sum())
    return {
        "pairs": pairs, "skip": skip_n / pairs, "full": full_n / pairs, "test": int(test.sum()) / pairs,
        "real_pairs": pairs - padding_pairs,
        "real_skip": (skip_n - padding_pairs) / max(pairs - padding_pairs, 1),
        "real_full": full_n / max(pairs - padding_pairs, 1),
        "real_test": int(test.sum()) / max(pairs - padding_pairs, 1),
        "user_tests": user_tests,
        "all_pairs_ops_ms": 12 * order.xs_s.shape[0] * real_slots / PEAK_FP32_OPS_S * 1e3,
        "tile_test_ops_ms": 12 * user_tests / PEAK_FP32_OPS_S * 1e3,
    }


def _rank_tiles(order, fac, q_pts, excl, q_chunk: int = 4) -> dict:
    """What the rank kernel's classifier does on this batch, from its plain
    twin (query-chunked), on its sub-tiles of ``RANK_SUB_TILE`` sorted
    users: shares of SKIP / FULL / TEST among the (query, sub-tile,
    facility) pairs (each query's excluded row left out), the user tests
    the TEST pairs need, the TEST facilities per (query, sub-tile) (mean,
    99th percentile and most: the heaviest warps), and the operations
    terms (5 a test) of testing every (user, facility) and of those
    tests."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.user_order import tile_boxes

    xy_s = torch.stack([order.xs_s, order.ys_s])
    n, m, tile = xy_s.shape[1], fac.shape[0], RANK_SUB_TILE
    n_tiles = -(-n // tile)
    boxes = tile_boxes(xy_s, tile)
    users = torch.full((n_tiles,), float(tile), dtype=torch.float64, device=fac.device)
    users[-1] = n - (n_tiles - 1) * tile
    counts = {"skip": 0, "full": 0, "test": 0}
    test_user_tests = 0.0
    per_tile = []  # TEST facilities of each (query, sub-tile)
    for q0 in range(0, q_pts.shape[0], q_chunk):
        qp = q_pts[q0 : q0 + q_chunk]
        dx, dy = xy_s[0][None] - qp[:, :1], xy_s[1][None] - qp[:, 1:]
        thr = dx * dx + dy * dy  # [q, N], the kernel's order
        tiled = torch.cat([thr, thr[:, -1:].expand(-1, n_tiles * tile - n)], 1).reshape(
            thr.shape[0], n_tiles, tile)
        classes = ref.rank_tile_classes_ref(boxes, tiled.amin(-1), tiled.amax(-1),
                                            fac[:, 0], fac[:, 1])  # [q, T, M]
        keep = torch.ones((thr.shape[0], 1, m), dtype=torch.bool, device=fac.device)
        for i, e in enumerate(excl[q0 : q0 + q_chunk]):
            keep[i, 0, e] = False
        for name, cls in (("skip", ref.TILE_SKIP), ("full", ref.TILE_FULL),
                          ("test", ref.TILE_TEST)):
            counts[name] += int(((classes == cls) & keep).sum())
        test = ((classes == ref.TILE_TEST) & keep).sum(-1).to(torch.float64)  # [q, T]
        test_user_tests += float((test * users[None]).sum())
        per_tile.append(test.flatten())
    pairs = sum(counts.values())
    per_tile = torch.cat(per_tile)
    all_tests = float(n) * (m - 1) * q_pts.shape[0]
    return {
        "tile": tile, "n_tiles": n_tiles, "pairs": pairs,
        **{k: v / max(pairs, 1) for k, v in counts.items()},
        "test_per_tile_mean": float(per_tile.mean()),
        "test_per_tile_p99": float(torch.quantile(per_tile, 0.99)),
        "test_per_tile_max": float(per_tile.max()),
        "test_user_tests": test_user_tests, "all_pairs_tests": all_tests,
        "all_pairs_ops_ms": 5 * all_tests / PEAK_FP32_OPS_S * 1e3,
        "test_user_tests_ops_ms": 5 * test_user_tests / PEAK_FP32_OPS_S * 1e3,
    }


def _rank64(users, facilities, q_row: int, chunk: int = 1 << 17):
    """Per user, in float64 on the users' device: the competitors (every
    facility row but ``q_row``) strictly closer than the query, an exact
    rank that shares no code with the rank kernel, and whether one of them
    is at a near-tie distance, where the strict-< verdict of a float32
    path may flip at the last ulp (so exactness is checked on the others:
    the JAX tests' rule, minus the query's own row, which is excluded from
    the count and always "ties")."""
    import torch

    q = facilities[q_row]
    comp = torch.cat([facilities[:q_row], facilities[q_row + 1 :]])
    ranks, ties = [], []
    for s in range(0, users.shape[0], chunk):
        u = users[s : s + chunk]
        d2q = ((u - q) ** 2).sum(1)
        d2 = ((u[:, None, :] - comp[None, :, :]) ** 2).sum(-1)
        ranks.append((d2 < d2q[:, None]).sum(1))
        ties.append(((d2 - d2q[:, None]).abs() < TIE_EPS * (1.0 + d2q[:, None])).any(1))
    return torch.cat(ranks), torch.cat(ties)


def _tie_mask(users, facilities, q_row: int, chunk: int = 1 << 17):
    """The near-tie users of :func:`_rank64`."""
    return _rank64(users, facilities, q_row, chunk)[1]


def _edge_tie_mask(xs64, ys64, coeffs, rel: float = 1e-6, chunk_elems: int = 1 << 25):
    """Users at a rounding-level tie of some triangle of ``coeffs``
    ``[M, 3, 3]``: one edge within ``rel`` of its terms' magnitude from 0
    while the other two hold, in float64 on the users' device (the rule of
    ``tests/_torch_parity.py``).  Two count paths may split only there."""
    import torch

    c = torch.as_tensor(coeffs, dtype=torch.float64, device=xs64.device)
    if c.shape[0] == 0:
        return torch.zeros(xs64.shape[0], dtype=torch.bool, device=xs64.device)
    chunk = max(1, chunk_elems // (3 * c.shape[0]))
    out = []
    for s in range(0, xs64.shape[0], chunk):
        x = xs64[s : s + chunk, None, None]
        y = ys64[s : s + chunk, None, None]
        ax, by = x * c[..., 0], y * c[..., 1]
        e = ax + by + c[..., 2]
        tol = rel * (ax.abs() + by.abs() + c[..., 2].abs())
        out.append(((e.abs() <= tol).any(-1) & (e >= -tol).all(-1)).any(-1))
    return torch.cat(out)


def _count_diffs(counts_a, counts_b, scenes, xs64, ys64) -> tuple[int, int]:
    """Two paths' ``[Q, N]`` counts compared on the card, query by query:
    ``(user-queries at an edge tie of the query's scene, user-queries whose
    counts differ)``.  The ties are a diagnostic only: both paths round
    alike, so they must agree there too."""
    import torch

    ties_n = diff_n = 0
    for i, sc in enumerate(scenes):
        ties_n += int(_edge_tie_mask(xs64, ys64, sc.coeffs[: sc.n_tris]).sum())
        a = torch.from_numpy(counts_a[i]).to(xs64.device)
        diff_n += int((a != torch.from_numpy(counts_b[i]).to(xs64.device)).sum())
    return ties_n, diff_n


def _cells_plain(xs_s, ys_s, ranks, planes, block: int):
    """``ref.grid_cells_count_batch_ref`` over chunks of user blocks (one
    call over the whole bucketing would need tens of GB of temporaries),
    with the chunk rule of ``ops.grid_count_cells_batch``'s plain path."""
    import torch

    from repro_torch.kernels import ops, ref

    q_n, lanes = planes.shape[0], planes.shape[-1]
    chunk = max(ops._CELL_CHUNK_ELEMS // max(q_n * block * lanes, 1), 1)
    return torch.cat([
        ref.grid_cells_count_batch_ref(
            xs_s[s * block : (s + chunk) * block], ys_s[s * block : (s + chunk) * block],
            ranks[s : s + chunk], planes,
        )
        for s in range(0, ranks.shape[0], chunk)
    ], dim=1)


def _degenerate(planes):
    """``[..., L]``: lanes of planes ``[..., 3, 3, L]`` that are the
    degenerate plane (padding, or a ``-1`` hole inside a list)."""
    p = planes
    return ((p[..., 0, :] == 0) & (p[..., 1, :] == 0) & (p[..., 2, :] == -1)).all(dim=-2)


def _real_lanes(planes):
    """``[Q, n_cells]``: the real listed triangles of each (query, cell)."""
    return (~_degenerate(planes)).sum(-1)


def _real_users(bkt):
    """``[n_blocks]``: the real users (not padding rows) of each user block."""
    import torch

    return torch.bincount(bkt.unsort // bkt.block, minlength=bkt.ranks.shape[0])


def _grid_bound_ms(bkt, planes, *, with_base: bool) -> tuple[float, str]:
    """Bound of the grid kernel on this bucketing: the bytes, each input read
    once and the output written once — 8 per sorted row, 4 (cell rank) + 16
    (box) per user block, 36 per real listed triangle per (query, cell) of
    the planes, 4 per (query, cell) of ``lens`` and of ``base`` where the
    kernel adds it, 4 per (query, sorted row) out.  With exact per-block
    classes the function needs no test per (user, listed triangle), so no
    operations term bounds it (the ``grid_tiles`` line logs those terms)."""
    q_n, n_cells = planes.shape[0], planes.shape[1]
    nb, n_sorted = bkt.ranks.shape[0], bkt.xs_s.shape[0]
    n_bytes = (8 * n_sorted + 20 * nb + 36 * int(_real_lanes(planes).sum()) + 4 * q_n * n_cells
               + (4 * q_n * n_cells if with_base else 0) + 4 * q_n * n_sorted)
    return _bound_ms(n_bytes, 0.0)


def _grid_tiles(bkt, planes, lens, pairs_per_chunk: int = 1 << 24) -> dict:
    """What the grid kernel's per-block classifier does on this batch, from
    its plain twin (query-chunked): shares of SKIP / FULL / TEST among the
    real listed (query, user block, triangle) pairs; the tests that walking
    every lane to the batch's L (the kernel before list lengths), the lanes
    up to each cell's length (list lengths alone, every row of the block),
    the real (user, listed triangle) pairs and the TEST pairs' real users
    need, with their operations terms (12 a test)."""
    import torch

    from repro_torch.kernels import ref

    q_n, lanes = planes.shape[0], planes.shape[-1]
    nb, n_sorted, block = bkt.ranks.shape[0], bkt.xs_s.shape[0], bkt.block
    cells = bkt.ranks.long()
    users = _real_users(bkt).to(torch.float64)  # [NB]
    real_lane = _real_lanes(planes)  # [Q, n_cells]
    counts = {"skip": 0, "full": 0, "test": 0}
    test_user_tests = 0.0
    step = max(1, pairs_per_chunk // max(nb * lanes, 1))
    for q0 in range(0, q_n, step):
        pl = planes[q0 : q0 + step]
        classes = ref.grid_block_classes_ref(bkt.boxes, bkt.ranks, pl)  # [q, NB, L]
        walked = torch.arange(lanes, device=planes.device) < lens[q0 : q0 + step][:, cells, None]
        real = walked & ~_degenerate(pl)[:, cells]  # [q, NB, L]
        for name, cls in (("skip", ref.TILE_SKIP), ("full", ref.TILE_FULL), ("test", ref.TILE_TEST)):
            counts[name] += int((real & (classes == cls)).sum())
        test = (real & (classes == ref.TILE_TEST)).sum(-1).to(torch.float64)  # [q, NB]
        test_user_tests += float((test * users[None, :]).sum())
    pairs = sum(counts.values())
    lane_tests = float(q_n * n_sorted * lanes)
    lens_tests = float(lens[:, cells].to(torch.float64).sum() * block)
    real_tests = float((real_lane[:, cells].to(torch.float64) * users[None, :]).sum())

    def ops_ms(tests: float) -> float:
        return 12 * tests / PEAK_FP32_OPS_S * 1e3

    return {
        "real_pairs": pairs, **{k: v / max(pairs, 1) for k, v in counts.items()},
        "lane_tests_walked": lane_tests, "lane_tests_ops_ms": ops_ms(lane_tests),
        "lens_tests": lens_tests, "lens_tests_ops_ms": ops_ms(lens_tests),
        "real_tests": real_tests, "real_tests_ops_ms": ops_ms(real_tests),
        "test_user_tests": test_user_tests, "test_user_tests_ops_ms": ops_ms(test_user_tests),
        "mean_len": float(lens.to(torch.float64).mean()), "L": lanes,
    }


def _grid_filter_breakdown(scenes, users, rect, dev) -> dict:
    """Host seconds of the pieces of the grid-pallas filter phase, each run
    once more on its own: the grid index builds, the per-cell plane
    packing, the user bucketing, and the stacking and upload of the
    occupied cells' planes."""
    import torch

    from repro_torch.core.backends import stack_cell_planes
    from repro_torch.core.grid import build_grid
    from repro_torch.kernels.grid_raycast import (
        block_boxes,
        order_cell_runs,
        pack_cell_coeff_planes,
        prepare_cell_buckets,
        unsort_index,
    )

    out = {}
    t0 = time.perf_counter()
    grids = [build_grid(s.tris[: s.n_tris], s.coeffs[: s.n_tris], s.rect, G=GRID_G) for s in scenes]
    out["grid_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planes = [pack_cell_coeff_planes(g) for g in grids]
    out["plane_pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    u32 = users.astype(np.float32)
    xs_s, ys_s, order, cell_map, nb = prepare_cell_buckets(u32[:, 0], u32[:, 1], rect, GRID_G,
                                                           block=None)
    occ = np.unique(cell_map)
    ranks = torch.from_numpy(np.searchsorted(occ, cell_map).astype(np.int32)).to(dev)
    block = len(xs_s) // nb
    xs_d, ys_d, order_d = order_cell_runs(torch.from_numpy(xs_s).to(dev), torch.from_numpy(ys_s).to(dev),
                                          torch.from_numpy(order).to(dev), ranks, block, rect)
    unsort_index(order_d, len(users))
    block_boxes(xs_d, ys_d, block)
    torch.cuda.synchronize(dev)
    out["bucketing_s"] = time.perf_counter() - t0  # the backend's _bucket, in-cell order included
    t0 = time.perf_counter()
    stacked = torch.from_numpy(stack_cell_planes([p[occ] for p in planes])).to(dev)
    torch.cuda.synchronize(dev)
    out["stack_upload_s"] = time.perf_counter() - t0
    out["stacked_planes_mb"] = stacked.numel() * 4 / 1e6
    return out


def _once_ms(fn, dev):
    """``(milliseconds, result)`` of one call of ``fn()`` by CUDA events
    (for the plain versions, which take seconds)."""
    import torch

    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop), out


def _saturated_diffs(res_b, res_d, xs64, ys64, k: int) -> dict:
    """A BVH batch result against the dense one on the card, query by
    query: the user-queries whose count differs from ``min(dense count,
    k)`` and those whose mask differs, each with the ones not at an edge
    tie of the query's scene (which must be none: the walk may miss a
    triangle only where rounding puts a user inside it but outside its
    box)."""
    import torch

    out = dict.fromkeys(("count_diffs", "count_diffs_off_edge_ties", "mask_diffs",
                         "mask_diffs_off_edge_ties"), 0)
    for i, sc in enumerate(res_d.scenes):
        a = torch.from_numpy(res_b.counts[i]).to(xs64.device)
        bad = a != torch.from_numpy(res_d.counts[i]).to(xs64.device).clamp(max=k)
        mbad = torch.from_numpy(res_b.masks[i] != res_d.masks[i]).to(xs64.device)
        either = bad | mbad
        if not bool(either.any()):
            continue
        ties = torch.zeros_like(either)
        ties[either] = _edge_tie_mask(xs64[either], ys64[either], sc.coeffs[: sc.n_tris])
        for name, diff in (("count_diffs", bad), ("mask_diffs", mbad)):
            out[name] += int(diff.sum())
            out[f"{name}_off_edge_ties"] += int((diff & ~ties).sum())
    return out


def _oracle_mismatches(masks, oracle, dev) -> int:
    """Users whose ``[Q, N]`` mask differs from the rank oracle's (a list of
    ``(rank < k, near ties)`` per query), off near ties."""
    import torch

    wrong = 0
    for i, (want, ties) in enumerate(oracle):
        got = torch.from_numpy(masks[i]).to(dev)
        wrong += int(((got != want) & ~ties).sum())
    return wrong


def _bvh_pops(pops, counts, k: int) -> dict:
    """Nodes popped per (query, user) lane of the BVH walk (``pops``: the
    kernel's ``[2, Q, N]``, internal nodes and leaves): the mean, 99th
    percentile and most of all pops, the sums of each kind, and the share
    of lanes that stopped at ``k``."""
    import torch

    both = pops[0] + pops[1]
    hist = torch.bincount(both.flatten().long())
    cum = torch.cumsum(hist, 0)
    lanes = int(cum[-1])
    p99 = int(torch.searchsorted(cum, torch.tensor(0.99 * lanes, device=cum.device).ceil().long()))
    inner, leaves = int(pops[0].sum(dtype=torch.int64)), int(pops[1].sum(dtype=torch.int64))
    return {"lanes": lanes, "inner_total": inner, "leaf_total": leaves,
            "pops_mean": (inner + leaves) / max(lanes, 1),
            "leaf_share": leaves / max(inner + leaves, 1),
            "pops_p99": p99, "pops_max": int(both.max()),
            "stopped_at_k": float((counts == k).sum()) / max(lanes, 1)}


def _bvh_bound_ms(n: int, batch, stats: dict) -> tuple[float, str]:
    """Bound of the BVH kernel: the bytes (8 per user, 24 per node and 36
    per triangle per query in, 4 per (query, user) out) or the operations
    on the nodes this run's lanes popped (``BVH_OPS_PER_LEAF`` a leaf,
    ``BVH_OPS_PER_INNER`` an internal node)."""
    q_n, nn = batch.left.shape
    n_bytes = 8 * n + q_n * (24 * nn + 36 * batch.coeffs.shape[1]) + 4 * q_n * n
    ops = BVH_OPS_PER_LEAF * stats["leaf_total"] + BVH_OPS_PER_INNER * stats["inner_total"]
    return _bound_ms(n_bytes, ops)


def _bvh_warps(pops, steps, perm) -> dict:
    """What the warp walk did (``pops`` ``[2, Q, N]`` in the users' order,
    ``steps`` ``[Q, n_warps]`` from the kernel's counting instance, each
    warp walking for a span of ``ceil(N / n_warps)`` consecutive sorted
    users, ``perm`` the sorted order): the lane efficiency (the users' pops
    over each warp's real users times its busiest user's pops) and the
    nodes the warps took (each warp's union of its users' nodes, counted
    by the kernel) against the sum of each warp's busiest user's pops,
    which they can never be below."""
    import torch

    both = (pops[0] + pops[1]).index_select(1, perm.long()).long()  # [Q, N], sorted
    q_n, n = both.shape
    n_warps = steps.shape[1]
    span = -(-n // n_warps)
    padded = torch.zeros((q_n, n_warps * span), dtype=torch.int64, device=both.device)
    padded[:, :n] = both
    most = padded.view(q_n, n_warps, span).amax(dim=2)
    users = torch.full((n_warps,), span, dtype=torch.int64, device=both.device)
    users[-1] = n - span * (n_warps - 1)
    if bool((steps.long() < most).any()):
        raise AssertionError("a warp took fewer nodes than its busiest user popped")
    taken, busiest = int(steps.sum(dtype=torch.int64)), int(most.sum())
    return {"warps": q_n * n_warps, "span": span,
            "lane_efficiency": int(both.sum()) / max(int((most * users).sum()), 1),
            "warp_steps": taken, "warp_most_pops": busiest,
            "steps_over_most": taken / max(busiest, 1)}


def run(dev, card: str, *, n_points: int, n_facilities: int, q_n: int, mono_points: int,
        seed: int):
    """All phases on the card ``dev``; returns the kernels' record.  Each
    counted window must show every kernel of its path launched and no
    plain version."""
    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine, rt_rknn_query
    from repro_torch.core.brute import rknn_brute_np, rknn_mono_brute_np
    from repro_torch.core.scene import pad_scene_arrays
    from repro_torch.data.spatial import facility_user_split, road_network_points
    from repro_torch.core.bvh import build_bvh, stack_bvhs
    from repro_torch.kernels import build, bvh, grid_raycast, ops, rank_count, raycast, ref
    from repro_torch.kernels.grid_raycast import order_cell_runs, prepare_cell_buckets
    from repro_torch.kernels.user_order import TILE_USERS, build_user_order

    # ---- setup ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    t_build = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in info["log"].splitlines() if "Used" in ln]
        for name, info in built.items()
    }
    _log("setup", card=card, build_s=t_build, ptxas=ptxas, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    pts = road_network_points(n_points, seed)
    F, U = facility_user_split(pts, n_facilities, seed)
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(n_facilities)
    qs = [int(i) for i in order[:q_n]]
    stream_qs = [
        [int(i) for i in order[q_n * (b + 1) : q_n * (b + 2)]] for b in range(STREAM_BATCHES)
    ]
    P = road_network_points(mono_points, seed + 2)
    _log("data", facilities=len(F), users=len(U), k=K, q=q_n, mono_points=len(P),
         seconds=time.perf_counter() - t0)

    # ---- a small instance against the numpy oracles, every backend --------
    small = np.random.default_rng(seed + 3)
    Fs, Us = small.random((60, 2)), small.random((400, 2))
    first_verify = {}  # the first query of each backend in this process
    for backend in ("dense", "dense-ref", "brute"):
        eng_s = RkNNEngine(Fs, Us, RkNNConfig(backend=backend), device=dev)
        got = eng_s.query_batch([3, 7, np.array([0.3, 0.6])], 5)
        first_verify[backend] = got.t_verify_s
        for i, qq in enumerate([3, 7, np.array([0.3, 0.6])]):
            if not np.array_equal(got.masks[i], rknn_brute_np(Us, Fs, qq, 5)):
                raise AssertionError(f"{backend}: small-instance mask {i} differs from the oracle")
        mono = eng_s.query_mono(11, 3)
        if not np.array_equal(mono.mask, rknn_mono_brute_np(Fs, 11, 3)):
            raise AssertionError(f"{backend}: small-instance mono mask differs from the oracle")
    _log("small_instance", ok=True, first_t_verify_s=first_verify)

    # ---- main path, counted --------------------------------------------
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=dev)
    eng.xs  # noqa: B018 — upload the users before the counted window
    raycast.batch_launches = raycast.single_launches = 0
    rank_count.launches = rank_count.batch_launches = 0
    ref.calls = 0

    res = eng.query_batch(qs, K)
    stream_t = time.perf_counter()
    stream_rows = 0
    for batch, masks in eng.stream(stream_qs, K):
        if masks.shape != (len(batch), len(U)):
            raise AssertionError(f"stream masks {masks.shape}")
        stream_rows += masks.shape[0]
    stream_s = time.perf_counter() - stream_t
    one = eng.query(qs[0], K)
    mono_eng = RkNNEngine(P, P, RkNNConfig(backend="dense"), device=dev)
    mono = mono_eng.query_mono(0, K)

    if res.masks.shape != (q_n, len(U)) or res.counts.dtype != np.int32:
        raise AssertionError(f"batch result {res.masks.shape} {res.counts.dtype}")
    if res.counts.min() < 0 or not np.array_equal(res.masks, res.counts < K):
        raise AssertionError("batch counts are negative or disagree with the masks")
    if not (np.array_equal(one.mask, res.masks[0]) and np.array_equal(one.counts, res.counts[0])):
        raise AssertionError("query() differs from row 0 of query_batch()")
    if stream_rows != q_n * STREAM_BATCHES:
        raise AssertionError(f"stream yielded {stream_rows} rows")

    # exactness at full size: hit-count < k  <=>  rank < k (paper Lemma 3.4)
    users_dev = torch.from_numpy(U.astype(np.float32)).to(dev)
    fac_dev = torch.from_numpy(F.astype(np.float32)).to(dev)
    u64, f64 = torch.from_numpy(U).to(dev), torch.from_numpy(F).to(dev)
    masks_dev = torch.from_numpy(res.masks).to(dev)
    n_ties = n_wrong = 0
    rank_out = []
    oracle = []  # (rank mask, near ties) per query, reused by the non-pruned phase
    # the oracle: the rank kernel over one order of the users, once per
    # query (Pallas row 5) and once for the whole batch (its query axis),
    # which must agree bit for bit
    rank_order = build_user_order(users_dev[:, 0].contiguous(), users_dev[:, 1].contiguous())
    rank_batch = ops.rank_count_batch(users_dev, fac_dev, fac_dev[qs], exclude=qs, order=rank_order)
    for i, qi in enumerate(qs):
        rc = ops.rank_count(users_dev, fac_dev, fac_dev[qi], exclude=qi, order=rank_order)
        if not torch.equal(rc, rank_batch[i]):
            raise AssertionError(f"rank_count_batch row {i} differs from the single-query launch")
        if i < RANK_CHECK_QUERIES:
            rank_out.append(rc)
        ties = _tie_mask(u64, f64, qi)
        oracle.append((rc < K, ties))
        n_ties += int(ties.sum())
        n_wrong += int(((rc < K) != masks_dev[i])[~ties].sum())
    # mono: rank among the other points, by the kernel with the query row
    # excluded and each point's own row subtracted
    p_dev = torch.from_numpy(P.astype(np.float32)).to(dev)
    mono_rank = ops.rank_count(p_dev, p_dev, p_dev[0], exclude=0) - 1
    mono_want = (mono_rank < K).cpu().numpy()
    mono_want[0] = False
    mono_ties = _tie_mask(torch.from_numpy(P).to(dev), torch.from_numpy(P).to(dev), 0).cpu().numpy()
    mono_wrong = int((mono_want != mono.mask)[~mono_ties].sum())
    torch.cuda.synchronize(dev)
    counted = {
        "raycast_count_batch": raycast.batch_launches,
        "raycast_count": raycast.single_launches,
        "rank_count": rank_count.launches,
        "rank_count_batch": rank_count.batch_launches,
    }
    plain_calls = ref.calls

    _log("main_path",
         query_batch={"t_filter_s": res.t_filter_s, "t_verify_s": res.t_verify_s,
                      "m_max": max(s.n_tris for s in res.scenes)},
         stream={"batches": STREAM_BATCHES, "wall_s": stream_s},
         query={"t_filter_s": one.t_filter_s, "t_verify_s": one.t_verify_s},
         query_mono={"points": len(P), "t_filter_s": mono.t_filter_s,
                     "t_verify_s": mono.t_verify_s},
         stats={"n_queries": eng.stats.n_queries, "n_batches": eng.stats.n_batches,
                "t_filter_s": eng.stats.t_filter_s, "t_verify_s": eng.stats.t_verify_s},
         launches=counted, plain_calls=plain_calls)
    _log("exactness", users=len(U), queries=q_n, k=K, near_tie_excluded=n_ties,
         mismatches=n_wrong, mono_near_tie_excluded=int(mono_ties.sum()),
         mono_mismatches=mono_wrong)
    if n_wrong or mono_wrong:
        raise AssertionError(f"dense masks differ from the rank oracle: {n_wrong} + {mono_wrong}")
    dispatches = 1 + STREAM_BATCHES  # query_batch + stream
    if counted["raycast_count_batch"] < dispatches or counted["raycast_count"] < 2:
        raise AssertionError(f"the main path did not go through the kernels: {counted}")
    if counted["rank_count"] < q_n or counted["rank_count_batch"] < 1 or plain_calls:
        raise AssertionError(f"oracle launches {counted}, plain calls {plain_calls}")

    # ---- grid path, full size, infzone: the same engine and scene cache --
    cells_batch, cells_one = grid_raycast.grid_raycast_cells_batch, grid_raycast.grid_raycast_cells
    grid_raycast.batch_launches = grid_raycast.single_launches = 0
    ref.calls = 0
    g_res = eng.query_batch(qs, K, backend="grid-pallas")
    g_stream_rows = 0
    for batch, masks in eng.stream(stream_qs[:1], K, backend="grid-pallas"):
        if masks.shape != (len(batch), len(U)):
            raise AssertionError(f"grid stream masks {masks.shape}")
        g_stream_rows += masks.shape[0]
    g_one = eng.query(qs[0], K, backend="grid-pallas")
    # the single-query kernel (Pallas row 4) has no engine path of its own:
    # run it on the batch's own bucketing and planes (the engine's prepared
    # batch, from its batch cache) for query 0
    _req, (bk, base_q, planes_q, lens_q), _sc = eng._snap.batch_cache.get(
        ("grid-pallas", K, tuple(qs), eng.rect))
    row4 = cells_one(bk.xs_s, bk.ys_s, bk.ranks, base_q[0], planes_q[0], block=bk.block,
                     lens=lens_q[0], boxes=bk.boxes)
    row4 = grid_raycast.unsort_cell_counts(row4, bk.unsort)
    torch.cuda.synchronize(dev)
    grid_counted = {"grid_raycast_cells_batch": grid_raycast.batch_launches,
                    "grid_raycast_cells": grid_raycast.single_launches}
    grid_plain = ref.calls

    if not np.array_equal(g_res.masks, res.masks):
        raise AssertionError(f"grid-pallas masks differ from dense: {(g_res.masks != res.masks).sum()}")
    if not (np.array_equal(g_one.counts, g_res.counts[0]) and np.array_equal(row4.cpu().numpy(), g_one.counts)):
        raise AssertionError("grid query() / single-query kernel differ from row 0 of query_batch()")
    xs64, ys64 = u64[:, 0].contiguous(), u64[:, 1].contiguous()
    g_ties, g_wrong = _count_diffs(g_res.counts, res.counts, res.scenes, xs64, ys64)
    _log("grid_path", users=len(U), queries=q_n, k=K, G=GRID_G,
         query_batch={"t_filter_s": g_res.t_filter_s, "t_verify_s": g_res.t_verify_s},
         dense_query_batch={"t_filter_s": res.t_filter_s, "t_verify_s": res.t_verify_s},
         query={"t_filter_s": g_one.t_filter_s, "t_verify_s": g_one.t_verify_s},
         stream_rows=g_stream_rows, n_occupied_cells=len(bk.occ), block=bk.block,
         L=int(planes_q.shape[-1]), n_sorted=int(bk.xs_s.shape[0]),
         edge_ties=g_ties, count_mismatches=g_wrong, launches=grid_counted,
         plain_calls=grid_plain)
    if g_wrong:
        raise AssertionError(f"grid counts differ from dense: {g_wrong}")
    _log("grid_filter_breakdown", **_grid_filter_breakdown(res.scenes, U, eng.rect, dev))
    if (grid_counted["grid_raycast_cells_batch"] < 3
            or grid_counted["grid_raycast_cells"] < 1 or grid_plain):
        raise AssertionError(f"the grid path did not go through the kernel: {grid_counted}, "
                             f"plain calls {grid_plain}")

    # ---- grid, non-pruned: one occluder per competitor ------------------
    eng_np = RkNNEngine(F, U, RkNNConfig(backend="grid-pallas", strategy="none", grid_g=GRID_G),
                        device=dev)
    qs_np = qs
    eng_np.xs  # noqa: B018 — upload the users before the counted window
    grid_raycast.batch_launches = grid_raycast.single_launches = raycast.batch_launches = 0
    ref.calls = 0
    # dense first: it builds the scenes, so the grid's t_filter_s is the
    # grid index build, the bucketing and the plane stacking alone
    np_dense = eng_np.query_batch(qs_np, K, backend="dense")
    np_grid = eng_np.query_batch(qs_np, K)
    torch.cuda.synchronize(dev)
    np_counted = {"grid_raycast_cells_batch": grid_raycast.batch_launches,
                  "raycast_count_batch": raycast.batch_launches}
    np_plain = ref.calls
    np_wrong = {"grid-pallas": 0, "dense": 0}
    np_near = 0
    for i, (want, ties) in enumerate(oracle):
        np_near += int(ties.sum())
        for name, r in (("grid-pallas", np_grid), ("dense", np_dense)):
            got = torch.from_numpy(r.masks[i]).to(dev)
            np_wrong[name] += int(((got != want) & ~ties).sum())
    np_ties, np_cwrong = _count_diffs(np_grid.counts, np_dense.counts, np_grid.scenes, xs64, ys64)
    _req2, (bk2, base_np, planes_np, lens_np), _sc2 = eng_np._snap.batch_cache.get(
        ("grid-pallas", K, tuple(qs_np), eng_np.rect))
    _log("grid_nonpruned", users=len(U), queries=len(qs_np), k=K, G=GRID_G, strategy="none",
         m_max=max(sc.n_tris for sc in np_grid.scenes),
         grid={"t_filter_s": np_grid.t_filter_s, "t_verify_s": np_grid.t_verify_s},
         dense={"t_filter_s": np_dense.t_filter_s, "t_verify_s": np_dense.t_verify_s},
         n_occupied_cells=len(bk2.occ), block=bk2.block, L=int(planes_np.shape[-1]),
         n_sorted=int(bk2.xs_s.shape[0]), near_tie_excluded=np_near, mismatches=np_wrong,
         edge_ties=np_ties, count_mismatches=np_cwrong, launches=np_counted,
         plain_calls=np_plain)
    if any(np_wrong.values()) or np_cwrong:
        raise AssertionError(f"non-pruned masks differ from the rank oracle {np_wrong} "
                             f"or grid counts from dense: {np_cwrong}")
    if (np_counted["grid_raycast_cells_batch"] < 1
            or np_counted["raycast_count_batch"] < 1 or np_plain):
        raise AssertionError(f"the non-pruned path did not go through the kernels: {np_counted}, "
                             f"plain calls {np_plain}")

    # ---- bvh path, full size, infzone: the same engine and scene cache ---
    # (scene cache hits: t_filter_s is the 64 BVH builds, the stack and the
    # upload); query() and query_mono() launch the kernel at Q = 1
    bvh.batch_launches = bvh.launches = 0
    ref.calls = 0
    b_res = eng.query_batch(qs, K, backend="bvh")
    b_one = eng.query(qs[0], K, backend="bvh")
    b_mono = mono_eng.query_mono(0, K, backend="bvh")
    torch.cuda.synchronize(dev)
    bvh_counted = {"bvh_count_batch": bvh.batch_launches, "bvh_count": bvh.launches}
    bvh_plain = ref.calls
    b_checks = {
        **_saturated_diffs(b_res, res, xs64, ys64, K),
        "oracle_mismatches": _oracle_mismatches(b_res.masks, oracle, dev),
        "mono_mismatches": int((mono_want != b_mono.mask)[~mono_ties].sum()),
    }
    _log("bvh_path", users=len(U), queries=q_n, k=K,
         query_batch={"t_filter_s": b_res.t_filter_s, "t_verify_s": b_res.t_verify_s},
         query={"t_filter_s": b_one.t_filter_s, "t_verify_s": b_one.t_verify_s},
         query_mono={"points": len(P), "t_filter_s": b_mono.t_filter_s,
                     "t_verify_s": b_mono.t_verify_s},
         near_tie_excluded=n_ties, **b_checks, launches=bvh_counted, plain_calls=bvh_plain)
    if (b_checks["count_diffs_off_edge_ties"] or b_checks["mask_diffs_off_edge_ties"]
            or b_checks["oracle_mismatches"] or b_checks["mono_mismatches"]):
        raise AssertionError(f"bvh path differs from dense or the rank oracle: {b_checks}")
    if not (np.array_equal(b_one.mask, b_res.masks[0]) and np.array_equal(b_one.counts, b_res.counts[0])):
        raise AssertionError("bvh query() differs from row 0 of query_batch()")
    if bvh_counted["bvh_count_batch"] < 1 or bvh_counted["bvh_count"] < 2 or bvh_plain:
        raise AssertionError(f"the bvh path did not go through the kernel: {bvh_counted}, "
                             f"plain calls {bvh_plain}")

    # ---- bvh, non-pruned: the grid_nonpruned engine's 64 scenes, reused ---
    bvh.batch_launches = 0
    ref.calls = 0
    np_bvh = eng_np.query_batch(qs_np, K, backend="bvh")
    torch.cuda.synchronize(dev)
    np_bvh_counted = {"bvh_count_batch": bvh.batch_launches}
    np_bvh_plain = ref.calls
    nb_checks = {
        **_saturated_diffs(np_bvh, np_dense, xs64, ys64, K),
        "oracle_mismatches": _oracle_mismatches(np_bvh.masks, oracle, dev),
    }
    _log("bvh_nonpruned", users=len(U), queries=len(qs_np), k=K, strategy="none",
         m_max=max(sc.n_tris for sc in np_bvh.scenes),
         query_batch={"t_filter_s": np_bvh.t_filter_s, "t_verify_s": np_bvh.t_verify_s},
         near_tie_excluded=np_near, **nb_checks, launches=np_bvh_counted,
         plain_calls=np_bvh_plain)
    if (nb_checks["count_diffs_off_edge_ties"] or nb_checks["mask_diffs_off_edge_ties"]
            or nb_checks["oracle_mismatches"]):
        raise AssertionError(f"non-pruned bvh differs from dense or the rank oracle: {nb_checks}")
    if np_bvh_counted["bvh_count_batch"] < 1 or np_bvh_plain:
        raise AssertionError(f"the non-pruned bvh path did not go through the kernel: "
                             f"{np_bvh_counted}, plain calls {np_bvh_plain}")

    # ---- each kernel against its plain version, at the main path's shapes --
    mp = max(128, 1 << int(np.ceil(np.log2(max(s.tris.shape[0] for s in res.scenes)))))
    stack = np.stack([
        pad_scene_arrays(s.tris[: s.n_tris], s.coeffs[: s.n_tris], s.owner[: s.n_tris], mp)[1]
        for s in res.scenes
    ])
    coeffs = torch.from_numpy(stack).to(dev)
    xs, ys = eng.xs, eng.ys
    n_u = xs.shape[0]
    real_tris = sum(s.n_tris for s in res.scenes)
    records = []

    # the kernel reads the users in the engine's spatial order: the same
    # order the dense backend built in the counted window (a stable sort)
    order_ms = _host_ms(lambda: build_user_order(xs, ys), 5, dev)
    order = build_user_order(xs, ys)
    got = ops.raycast_count_batch(xs, ys, coeffs, order=order)
    want = ops.raycast_count_batch(xs, ys, coeffs, backend="ref")
    err = int((got - want).abs().max())
    if not torch.equal(got, want) or not np.array_equal(got.cpu().numpy(), res.counts):
        raise AssertionError(f"ray-cast batch kernel differs from its plain version: {err}")

    def sorted_ms(cf) -> float:
        """The kernel alone: its store in tile order, without the wrapper's
        gather back to the users' order."""
        return _sync_ms(lambda: raycast._launch_sorted(xs, ys, cf, order)[0], 20, dev)

    def raycast_bound(q_rows) -> dict:
        """The bytes: each input once, the counts out once.  With exact tile
        classes the function needs no test per (user, triangle), so no ops
        term bounds it (the ``raycast_tiles`` line logs those terms)."""
        n_bytes = 8 * n_u + 36 * q_rows * mp + 4 * q_rows * n_u
        return {"bound_ms": n_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}

    records.append({
        "name": "raycast_count_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/raycast.cu",
        "replaces": "src/repro/kernels/raycast.py:145",
        "launches": counted["raycast_count_batch"], "max_abs_err": err,
        "ms": _sync_ms(lambda: ops.raycast_count_batch(xs, ys, coeffs, order=order), 20, dev),
        "plain_ms": _sync_ms(lambda: ops.raycast_count_batch(xs, ys, coeffs, backend="ref"), 2, dev),
        **raycast_bound(q_n), "library_ms": None,
        "shape": {"Q": q_n, "N": n_u, "Mp": mp, "real_triangles": real_tris},
    })
    d2h_ms = _host_ms(lambda: got.cpu(), 5, dev)
    pinned = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
    d2h_pinned_ms = _host_ms(lambda: pinned.copy_(got), 5, dev)

    c1 = coeffs[0]
    got1 = ops.raycast_count(xs, ys, c1, order=order)
    want1 = ops.raycast_count(xs, ys, c1, backend="ref")
    err1 = int((got1 - want1).abs().max())
    if not torch.equal(got1, want1) or not np.array_equal(got1.cpu().numpy(), one.counts):
        raise AssertionError(f"ray-cast single kernel differs from its plain version: {err1}")
    records.append({
        "name": "raycast_count", "route": "cuda",
        "source": "src/repro_torch/csrc/raycast.cu",
        "replaces": "src/repro/kernels/raycast.py:88",
        "launches": counted["raycast_count"], "max_abs_err": err1,
        "ms": _sync_ms(lambda: ops.raycast_count(xs, ys, c1, order=order), 20, dev),
        "plain_ms": _sync_ms(lambda: ops.raycast_count(xs, ys, c1, backend="ref"), 2, dev),
        **raycast_bound(1), "library_ms": None,
        "shape": {"Q": 1, "N": n_u, "Mp": mp, "real_triangles": res.scenes[0].n_tris},
    })

    # the rank kernel (Pallas row 5, and its query axis for
    # rank_count_batch): bit for bit against its plain version on the card
    err_r = 0
    for i, rc in enumerate(rank_out):
        qi = qs[i]
        want_r = ops.rank_count(users_dev, fac_dev, fac_dev[qi], exclude=qi, backend="ref")
        err_r = max(err_r, int((rc - want_r).abs().max()))

    def rank_batch_plain():
        return ops.rank_count_batch(users_dev, fac_dev, fac_dev[qs], exclude=qs, backend="ref")

    err_b = int((rank_batch - rank_batch_plain()).abs().max())  # every query's row
    if err_r or err_b:
        raise AssertionError(f"rank kernel differs from its plain version: {err_r}, {err_b}")
    q0 = qs[0]
    xs_u, ys_u = users_dev[:, 0].contiguous(), users_dev[:, 1].contiguous()
    q_one, excl_one = fac_dev[q0], torch.tensor([q0], dtype=torch.int32, device=dev)
    q_all, excl_all = fac_dev[qs], torch.tensor(qs, dtype=torch.int32, device=dev)

    def rank_bound(q_rows) -> dict:
        """The bytes: the users and the facilities in once, the counts out
        once (the kernel computes the thresholds itself).  With exact
        classes the function needs no test per (user, facility), so no
        operations term bounds it (the ``rank_tiles`` line logs those terms)."""
        n_bytes = 8 * n_u + 8 * len(F) + 12 * q_rows + 4 * q_rows * n_u
        return {"bound_ms": n_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes"}

    def rank_device(q_pts, excl) -> dict:
        """The launch's device time alone (CUDA graph, no host work) at the
        wrapper's cut of the facilities into splits."""
        per_split = rank_count.facilities_per_split(
            -(-n_u // TILE_USERS) * q_pts.shape[0], len(F), dev)
        return {"facilities_per_split": per_split, "kernel_device_ms": _graph_ms(
            lambda: rank_count._launch(xs_u, ys_u, fac_dev, q_pts, excl, rank_order),
            20 if q_pts.shape[0] == 1 else 5, dev)}

    records.append({
        "name": "rank_count", "route": "cuda",
        "source": "src/repro_torch/csrc/rank_count.cu",
        "replaces": "src/repro/kernels/rank_count.py:59",
        "launches": counted["rank_count"], "max_abs_err": err_r,
        "ms": _sync_ms(lambda: rank_count.rank_count_kernel_call(
            xs_u, ys_u, fac_dev, q_one, excl_one, rank_order), 20, dev),
        "plain_ms": _sync_ms(
            lambda: ops.rank_count(users_dev, fac_dev, fac_dev[q0], exclude=q0, backend="ref"), 2, dev),
        **rank_bound(1), "library_ms": None,
        "shape": {"Q": 1, "N": n_u, "M": len(F)},
    })
    records.append({
        "name": "rank_count_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/rank_count.cu",
        "replaces": "src/repro/kernels/ops.py:381 (jnp rank_count_batch, not a Pallas site)",
        "launches": counted["rank_count_batch"], "max_abs_err": err_b,
        "ms": _sync_ms(lambda: rank_count.rank_count_batch_kernel_call(
            xs_u, ys_u, fac_dev, q_all, excl_all, rank_order), 20, dev),
        "plain_ms": _sync_ms(rank_batch_plain, 1, dev),
        **rank_bound(q_n), "library_ms": None,
        "shape": {"Q": q_n, "N": n_u, "M": len(F)},
    })
    _log("rank_tiles", sub_tile=RANK_SUB_TILE,
         single=rank_device(q_one[None], excl_one), batch=rank_device(q_all, excl_all),
         classes_single=_rank_tiles(rank_order, fac_dev, q_one[None], [q0]),
         classes_batch=_rank_tiles(rank_order, fac_dev, q_all, qs))
    # the grid kernels: each record at the grid path's shapes (the infzone
    # batch whose launches it counts); the non-pruned batch's larger L is
    # held and timed as well, and logged beside them
    def grid_batch_check(bkt, planes, lens):
        def kernel():
            return cells_batch(bkt.xs_s, bkt.ys_s, bkt.ranks, planes, block=bkt.block, lens=lens,
                               boxes=bkt.boxes)

        got = kernel()
        want = _cells_plain(bkt.xs_s, bkt.ys_s, bkt.ranks, planes, bkt.block)
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"grid batch kernel differs from its plain version: {err}")
        b_ms, b_by = _grid_bound_ms(bkt, planes, with_base=False)
        return got, {
            "max_abs_err": err,
            "ms": _sync_ms(kernel, 20, dev),
            "plain_ms": _sync_ms(lambda: _cells_plain(bkt.xs_s, bkt.ys_s, bkt.ranks, planes,
                                                      bkt.block), 1, dev),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"Q": int(planes.shape[0]), "n_sorted": int(bkt.xs_s.shape[0]),
                      "block": bkt.block, "n_blocks": int(bkt.ranks.shape[0]),
                      "n_cells": int(planes.shape[1]), "L": int(planes.shape[-1])},
        }

    def grid_one_check(bkt, base1, planes1, lens1, batch_row):
        args = (bkt.xs_s, bkt.ys_s, bkt.ranks, base1, planes1)
        kw = {"block": bkt.block, "lens": lens1, "boxes": bkt.boxes}
        got = cells_one(*args, **kw)
        want = ops.grid_count_cells(*args, block=bkt.block, backend="ref")
        err = int((got - want).abs().max())
        with_base = batch_row + base1[bkt.ranks.long()].repeat_interleave(bkt.block)
        if not torch.equal(got, want) or not torch.equal(got, with_base):
            raise AssertionError(f"grid single-query kernel differs from its plain version: {err}")
        b_ms, b_by = _grid_bound_ms(bkt, planes1[None], with_base=True)
        return {
            "max_abs_err": err,
            "ms": _sync_ms(lambda: cells_one(*args, **kw), 20, dev),
            "plain_ms": _sync_ms(lambda: ops.grid_count_cells(*args, block=bkt.block,
                                                              backend="ref"), 2, dev),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"Q": 1, "n_sorted": int(bkt.xs_s.shape[0]), "block": bkt.block,
                      "n_cells": int(planes1.shape[0]), "L": int(planes1.shape[-1])},
        }

    grid_src, grid_rows = "src/repro_torch/csrc/grid_raycast.cu", "src/repro/kernels/grid_raycast.py"
    got_g, rec_g = grid_batch_check(bk, planes_q, lens_q)
    records.append({"name": "grid_raycast_cells_batch", "route": "cuda", "source": grid_src,
                    "replaces": f"{grid_rows}:317",
                    "launches": grid_counted["grid_raycast_cells_batch"], **rec_g})
    records.append({"name": "grid_raycast_cells", "route": "cuda", "source": grid_src,
                    "replaces": f"{grid_rows}:242",
                    "launches": grid_counted["grid_raycast_cells"],
                    **grid_one_check(bk, base_q[0], planes_q[0], lens_q[0], got_g[0])})
    got_np, rec_np = grid_batch_check(bk2, planes_np, lens_np)
    nonpruned_grid = {
        "grid_raycast_cells_batch": {"launches": np_counted["grid_raycast_cells_batch"], **rec_np},
        "grid_raycast_cells": grid_one_check(bk2, base_np[0], planes_np[0], lens_np[0], got_np[0]),
    }
    # the grid kernel's classes and tests, and the in-cell order's build
    # (on the grid path's bucketing, from the host bucketing's rows)
    u32 = U.astype(np.float32)
    hb = prepare_cell_buckets(u32[:, 0], u32[:, 1], eng.rect, GRID_G, block=None)
    host_rows = [torch.from_numpy(a).to(dev) for a in hb[:3]]
    _log("grid_tiles", block=bk.block, n_blocks=int(bk.ranks.shape[0]),
         in_cell_order_ms=_host_ms(
             lambda: order_cell_runs(*host_rows, bk.ranks, bk.block, eng.rect), 5, dev),
         grid_path=_grid_tiles(bk, planes_q, lens_q),
         grid_nonpruned=_grid_tiles(bk2, planes_np, lens_np))
    # the BVH kernel (the jnp walk of core/bvh.py, not a Pallas site): bit
    # for bit against its plain version over all 64 queries at both shapes
    # and at Q = 1; its pops per lane give the operations term of the bound
    bvh_src, bvh_rows = "src/repro_torch/csrc/bvh_traverse.cu", "src/repro/core/bvh.py"

    def bvh_host_s(scenes) -> dict:
        """Host seconds of the 64 BVH builds and of their stacking, run once
        more on their own."""
        t0 = time.perf_counter()
        trees = [build_bvh(sc.tris[: sc.n_tris]) for sc in scenes]
        t1 = time.perf_counter()
        stack_bvhs(trees, [sc.coeffs[: sc.n_tris] for sc in scenes])
        return {"build_s": t1 - t0, "stack_s": time.perf_counter() - t1}

    def bvh_walk(batch, want, want_pops, label: str) -> dict:
        """The kernel's counting instance: its counts and pops against the
        plain walk's, lane for lane, and what its warps did."""
        walk = bvh.walk_stats(xs, ys, batch, K, order)
        if not (torch.equal(walk.counts, want) and torch.equal(walk.pops, want_pops)):
            raise AssertionError(f"bvh kernel ({label}): its pops differ from the plain walk's")
        return _bvh_warps(walk.pops, walk.steps, order.perm)

    def bvh_check(batch, engine_counts, label: str):
        """The serving kernel against the plain walk (counts), its counting
        instance against the plain walk's pops lane for lane, the warps'
        steps, and the serving launch's time."""
        def kernel():
            return ops.bvh_count_stacked(xs, ys, batch, k=K, order=order)

        got = kernel()
        plain_ms, (want, want_pops) = _once_ms(
            lambda: ops.bvh_count_stacked(xs, ys, batch, k=K, backend="ref", pops=True), dev)
        err = int((got - want).abs().max())
        if not torch.equal(got, want) or not np.array_equal(got.cpu().numpy(), engine_counts):
            raise AssertionError(f"bvh kernel ({label}) differs from its plain version: {err}")
        stats = {**_bvh_pops(want_pops, got, K), **bvh_walk(batch, want, want_pops, label)}
        b_ms, b_by = _bvh_bound_ms(n_u, batch, stats)
        shape = {"Q": int(batch.left.shape[0]), "N": n_u, "Nn": int(batch.left.shape[1]),
                 "Mt": int(batch.coeffs.shape[1]), "depth": batch.depth,
                 "n_inner": int(batch.nodes.shape[1])}
        return stats, {"max_abs_err": err, "ms": _sync_ms(kernel, 10, dev), "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": shape}

    _r, b_batch, _s = eng._snap.batch_cache.get(("bvh", K, tuple(qs), eng.rect))
    _r, nb_batch, _s = eng_np._snap.batch_cache.get(("bvh", K, tuple(qs_np), eng_np.rect))
    bvh_stats, rec_b = bvh_check(b_batch, b_res.counts, "infzone")
    records.append({"name": "bvh_count_batch", "route": "cuda", "source": bvh_src,
                    "replaces": f"{bvh_rows}:302 (jnp while_loop, not a Pallas site)",
                    "launches": bvh_counted["bvh_count_batch"], **rec_b})
    np_bvh_stats, rec_nb = bvh_check(nb_batch, np_bvh.counts, "non-pruned")
    records.append({"name": "bvh_count_batch (non-pruned)", "route": "cuda", "source": bvh_src,
                    "replaces": f"{bvh_rows}:302 (jnp while_loop, not a Pallas site)",
                    "launches": np_bvh_counted["bvh_count_batch"], **rec_nb})
    # Q = 1: query 0's tree on its unpadded triangles, as BvhBackend.count
    sc0 = res.scenes[0]
    tree0 = build_bvh(sc0.tris[: sc0.n_tris])
    one_batch = bvh.bvh_batch(*(a[None] for a in (
        tree0.left, tree0.right, tree0.bbox, sc0.coeffs[: sc0.n_tris])), dev)
    depth0 = one_batch.depth
    got_b1 = bvh.bvh_count_kernel_call(xs, ys, one_batch, K, order)
    plain_b1_ms, (want_b1, want_pops1) = _once_ms(
        lambda: ops.bvh_count_stacked(xs, ys, one_batch, k=K, backend="ref", pops=True), dev)
    err_b1 = int((got_b1 - want_b1[0]).abs().max())
    if not torch.equal(got_b1, want_b1[0]) or not np.array_equal(got_b1.cpu().numpy(),
                                                                b_one.counts):
        raise AssertionError(f"bvh single-query kernel differs from its plain version: {err_b1}")
    one_stats = {**_bvh_pops(want_pops1, got_b1[None], K),
                 **bvh_walk(one_batch, want_b1, want_pops1, "Q = 1")}
    b1_ms, b1_by = _bvh_bound_ms(n_u, one_batch, one_stats)
    records.append({
        "name": "bvh_count", "route": "cuda", "source": bvh_src,
        "replaces": f"{bvh_rows}:207 (jnp while_loop, not a Pallas site)",
        "launches": bvh_counted["bvh_count"], "max_abs_err": err_b1,
        "ms": _sync_ms(lambda: bvh.bvh_count_kernel_call(xs, ys, one_batch, K, order), 20, dev),
        "plain_ms": plain_b1_ms, "bound_ms": b1_ms, "bound_by": b1_by, "library_ms": None,
        "shape": {"Q": 1, "N": n_u, "Nn": tree0.n_nodes, "Mt": sc0.n_tris, "depth": depth0},
    })
    _log("bvh_tiles", ops_per_leaf=BVH_OPS_PER_LEAF, ops_per_inner=BVH_OPS_PER_INNER,
         infzone={**bvh_stats, **rec_b["shape"], **bvh_host_s(res.scenes)},
         nonpruned={**np_bvh_stats, **rec_nb["shape"], **bvh_host_s(np_dense.scenes)},
         single={**one_stats, "depth": depth0})

    empty = ops.raycast_count_batch(xs, ys, coeffs[:0])
    if empty.shape != (0, n_u):
        raise AssertionError(f"empty batch gave {tuple(empty.shape)}")
    # the one-shot shim builds a fresh engine, and so the users' order, on
    # every call: its verify time at the mono path's user count
    shim = [rt_rknn_query(F, P, qs[0], K, backend="dense", device=dev) for _ in range(3)]
    _log("raycast_tiles", tile=TILE_USERS, n_tiles=int(order.boxes.shape[0]),
         order_build_ms=order_ms,
         order_build_ms_mono=_host_ms(lambda: build_user_order(mono_eng.xs, mono_eng.ys), 20, dev),
         shim_users=len(P), shim_t_verify_s=[r.t_verify_s for r in shim],
         shim_t_filter_s=[r.t_filter_s for r in shim],
         kernel_alone_ms_batch=sorted_ms(coeffs), kernel_alone_ms_single=sorted_ms(coeffs[:1]),
         classes_batch=_tile_classes(order, coeffs, real_tris),
         classes_single=_tile_classes(order, coeffs[:1], res.scenes[0].n_tris))
    _scenarios(dev)
    _planner(dev, eng, mono_eng, qs, stream_qs, oracle, (users_dev, fac_dev, u64, f64, rank_order),
             (mono_want, mono_ties), {"dense": res, "grid-pallas": g_res, "bvh": b_res})
    _dynamic(dev, F, U, qs)
    _log("kernels", bit_identical_raycast=True, bit_identical_grid=True, bit_identical_bvh=True,
         rank_checked_queries=len(rank_out), d2h_counts_ms=d2h_ms,
         d2h_counts_pinned_ms=d2h_pinned_ms, counts_mb=got.numel() * 4 / 1e6,
         records=records, grid_nonpruned_shapes=nonpruned_grid)
    return records


def _scenarios(dev) -> None:
    """Each of the paper's regimes (``repro_torch.workloads.SCENARIOS``) at
    scale 1 (at most ``SCENARIO_MAX_USERS`` users) through ``dense``,
    ``grid-pallas``, ``bvh`` and ``brute`` on the card, one line each, with
    every kernel's launches counted over the whole phase.  Masks: each
    backend's equal those of a float64 rank oracle (:func:`_rank64`, no
    kernel of the port) off near ties; ``grid-pallas``'s masks and counts
    equal ``dense``'s; ``bvh``'s counts equal ``min(dense, k)`` and its
    masks ``dense``'s off edge ties.  The first backend (``dense``) builds
    the scenes, the others hit the scene cache."""
    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine
    from repro_torch.kernels import bvh, grid_raycast, rank_count, raycast, ref
    from repro_torch.workloads import SCENARIOS

    raycast.batch_launches = grid_raycast.batch_launches = 0
    bvh.batch_launches = rank_count.batch_launches = 0
    ref.calls = 0
    backends = ("dense", "grid-pallas", "bvh", "brute")
    for name, sc in SCENARIOS.items():
        w = sc.generate(1.0)
        if len(w.users) > SCENARIO_MAX_USERS:
            raise AssertionError(f"{name}: {len(w.users)} users, more than {SCENARIO_MAX_USERS}")
        eng = RkNNEngine(w.facilities, w.users, RkNNConfig(backend="dense"), device=dev)
        out = {b: eng.query_batch(w.qs, w.k, backend=b) for b in backends}
        u64 = torch.from_numpy(w.users).to(dev)
        f64 = torch.from_numpy(w.facilities).to(dev)
        # the oracle in float64, independent of every backend's kernels
        # (``brute`` launches the rank kernel)
        oracle = []
        for qi in w.qs:
            rank, ties = _rank64(u64, f64, int(qi))
            oracle.append((rank < w.k, ties))
        dense = out["dense"]
        xs64, ys64 = u64[:, 0].contiguous(), u64[:, 1].contiguous()
        checks = {
            "oracle_mismatches": {b: _oracle_mismatches(r.masks, oracle, dev) for b, r in out.items()},
            "grid_mask_diffs": int((out["grid-pallas"].masks != dense.masks).sum()),
            "grid_count_diffs": int((out["grid-pallas"].counts != dense.counts).sum()),
            **_saturated_diffs(out["bvh"], dense, xs64, ys64, w.k),
        }
        _log("scenarios", name=name, distribution=sc.distribution, facilities=len(w.facilities),
             users=len(w.users), k=w.k, q=len(w.qs), m_max=max(s.n_tris for s in dense.scenes),
             near_tie_excluded=sum(int(t.sum()) for _, t in oracle),
             t_filter_s={b: r.t_filter_s for b, r in out.items()},
             t_verify_s={b: r.t_verify_s for b, r in out.items()}, **checks)
        if (any(checks["oracle_mismatches"].values()) or checks["grid_mask_diffs"]
                or checks["grid_count_diffs"] or checks["count_diffs_off_edge_ties"]
                or checks["mask_diffs_off_edge_ties"]):
            raise AssertionError(f"scenario {name}: {checks}")
    torch.cuda.synchronize(dev)
    counted = {"raycast_count_batch": raycast.batch_launches,
               "grid_raycast_cells_batch": grid_raycast.batch_launches,
               "bvh_count_batch": bvh.batch_launches, "rank_count_batch": rank_count.batch_launches}
    _log("scenarios_launches", launches=counted, plain_calls=ref.calls)
    if min(counted.values()) < len(SCENARIOS) or ref.calls:
        raise AssertionError(f"the scenarios did not go through every kernel: {counted}, "
                             f"plain calls {ref.calls}")


#: The forced mixed batch's rotation: the four kernel backends.
MIXED_ROTATION = ("dense", "grid-pallas", "bvh", "brute")
RECAL_BATCHES = 3  # batches of 8 queries through an online-recalibrating engine


def _plan_line(plan: dict) -> dict:
    """One ``explain()`` entry for the log: the per-query lists summed up."""
    return {key: plan[key] for key in ("mode", "backend", "predicted_s", "observed_s", "assignments",
                                       "candidates", "groups", "split", "amortized",
                                       "plan_cache_hit", "observed_group_s", "decisions")
            if key in plan}


def _planner(dev, eng, mono_eng, qs, stream_qs, oracle, users, mono_oracle, observed) -> None:
    """The query planner on the card: calibrate (the fast grid, ``repeats=2``),
    load the committed profile of this runner class, price the CAL batch
    with the fresh profile next to the forced backends' observed times,
    serve ``query_batch``, ``query``, ``stream`` and ``query_mono`` through
    ``auto``, force a batch mixed over the four kernel backends, and run an
    online-recalibrating engine.  Every mask is held against the rank
    oracle off near ties; over the served runs every kernel of a backend
    that ``auto`` dispatched must launch and no plain version may run.
    The active profile is restored at the end."""
    import copy

    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine, get_backend, register_backend
    from repro_torch.kernels import bvh, grid_raycast, ops, rank_count, raycast, ref
    from repro_torch.planner.backend import PlannerBackend
    from repro_torch.planner.calibrate import calibrate
    from repro_torch.planner.models import WorkloadShape
    from repro_torch.planner.profiles import (
        PROFILE_STORE, get_active_profile, load_runner_profile, runner_class,
        set_active_profile,
    )

    users_dev, fac_dev, u64, f64, rank_order = users
    mono_want, mono_ties = mono_oracle
    n_f, n_u, q_n = len(eng.facilities), len(eng.users), len(qs)
    prev_profile = get_active_profile()

    # ---- calibrate on the card -----------------------------------------
    t0 = time.perf_counter()
    fresh = calibrate(device=dev, fast=True, repeats=2)
    cal_s = time.perf_counter() - t0
    names = [sh["name"] for sh in fresh.meta["shapes"]]
    _log("planner_calibration", seconds=cal_s, hardware=fresh.hardware,
         runner_class=runner_class(fresh.hardware), backends=fresh.meta["backends"],
         shapes=fresh.meta["shapes"],
         measured={b: {name: [m["t_filter_s"][i], m["t_verify_s"][i]]
                       for i, name in enumerate(names)}
                   for b, m in fresh.meta["measured"].items()})
    card = torch.cuda.get_device_name(dev)
    if fresh.hardware.get("platform") != "gpu" or fresh.hardware.get("device_kind") != card:
        raise AssertionError(f"calibration fingerprint does not name the card: {fresh.hardware}")
    twins = [b for b in fresh.models if b != "slice" and get_backend(b).plain_twin_of]
    if twins:
        raise AssertionError(f"the card's calibration timed plain twins: {twins}")
    committed = load_runner_profile(PROFILE_STORE)
    if committed is None:
        raise AssertionError(f"no committed profile for {runner_class()} under {PROFILE_STORE}")

    # ---- price the CAL batch next to the forced backends' observed times --
    set_active_profile(fresh)
    brute_res = eng.query_batch(qs, K, backend="brute")
    observed = {**observed, "brute": brute_res}
    planner = get_backend("auto")
    cands = planner.candidates(device=dev)
    pw = eng._snap.pad_waste(eng.rect, GRID_G)
    amortized = WorkloadShape(n_f, n_u, K, q_n, cache_hit=True, pad_waste=pw)
    cold = WorkloadShape(n_f, n_u, K, q_n, cache_hit=False, pad_waste=pw)
    pricing = {}
    for name in cands:
        row = {"pred_amortized_s": fresh.predict_s(name, amortized),
               "pred_cold_s": fresh.predict_s(name, cold),
               "pred_committed_amortized_s": committed.predict_s(name, amortized)
               if name in committed.models else None}
        r = observed.get(name)
        if r is not None:
            obs = r.t_filter_s + r.t_verify_s
            row.update(obs_t_filter_s=r.t_filter_s, obs_t_verify_s=r.t_verify_s,
                       ratio_amortized=row["pred_amortized_s"] / obs,
                       ratio_cold=row["pred_cold_s"] / obs,
                       ratio_verify=fresh.models[name].verify.predict_s(amortized) / r.t_verify_s)
        pricing[name] = row
    _log("planner_pricing", users=n_u, facilities=n_f, k=K, q=q_n, pad_waste=pw,
         candidates=list(cands), ranked=planner.rank(amortized, cands), backends=pricing,
         brute_oracle_mismatches=_oracle_mismatches(brute_res.masks, oracle, dev))

    # the stream's oracle, before the counted window (it launches row 5)
    stream_batches = stream_qs[:2]
    stream_oracle = []
    for batch in stream_batches:
        rc = ops.rank_count_batch(users_dev, fac_dev, fac_dev[batch], exclude=batch, order=rank_order)
        stream_oracle.append([(rc[i] < K, _tie_mask(u64, f64, qi)) for i, qi in enumerate(batch)])

    # ---- serve through auto, counted --------------------------------------
    raycast.batch_launches = raycast.single_launches = 0
    grid_raycast.batch_launches = grid_raycast.single_launches = 0
    bvh.batch_launches = bvh.launches = 0
    rank_count.launches = rank_count.batch_launches = 0
    ref.calls = 0
    n_plans = len(eng.explain())
    a_res = eng.query_batch(qs, K, backend="auto")
    a_plan = eng.explain()[-1]
    a_one = eng.query(qs[0], K, backend="auto")
    t0 = time.perf_counter()
    a_stream = [m for _, m in eng.stream(stream_batches, K, backend="auto")]
    stream_s = time.perf_counter() - t0
    a_mono = mono_eng.query_mono(0, K, backend="auto")

    class MixedPlanner(PlannerBackend):
        """The scenes' path, then the batch dealt over the kernel backends."""

        name = "auto-mixed"

        def rank(self, shape, candidates=None):
            return [(MIXED_ROTATION[0], 1.0)]

        def assign_batch(self, shapes, candidates=None):
            return [(MIXED_ROTATION[i % len(MIXED_ROTATION)], 1.0) for i in range(len(shapes))]

    register_backend(MixedPlanner)
    set_active_profile(fresh)  # a new epoch: the auto batch's memoized plan is not reused
    mixed = eng.query_batch(qs, K, backend="auto-mixed")
    mixed_plan = eng.explain()[-1]

    set_active_profile(copy.deepcopy(fresh))  # online recalibration edits it in place
    recal_eng = RkNNEngine(eng.facilities, eng.users,
                           RkNNConfig(backend="auto", online_recalibration=True), device=dev)
    recal_rows = [list(range(8 * (i % 2), 8 * (i % 2) + 8)) for i in range(RECAL_BATCHES)]
    recal = [recal_eng.query_batch([qs[i] for i in rows], K) for rows in recal_rows]
    recal_profile = get_active_profile()
    torch.cuda.synchronize(dev)
    counted = {"raycast": raycast.batch_launches + raycast.single_launches,
               "grid_raycast": grid_raycast.batch_launches + grid_raycast.single_launches,
               "bvh": bvh.batch_launches + bvh.launches,
               "rank_count": rank_count.launches + rank_count.batch_launches}
    plain_calls = ref.calls
    set_active_profile(prev_profile)

    # ---- checks -------------------------------------------------------------
    plans = eng.explain()[n_plans:] + mono_eng.explain()[-1:] + recal_eng.explain()
    dispatched = sorted({b for p in plans for b in p.get("decisions", {})})
    kernel_of = {"dense": "raycast", "grid-pallas": "grid_raycast", "bvh": "bvh",
                 "brute": "rank_count"}
    served_twins = [b for b in dispatched if get_backend(b).plain_twin_of]
    off_ties = [~t.cpu().numpy() for _, t in oracle]
    dense_masks = observed["dense"].masks
    checks = {
        "query_batch": _oracle_mismatches(a_res.masks, oracle, dev),
        "query": _oracle_mismatches(a_one.mask[None], oracle[:1], dev),
        "stream": sum(_oracle_mismatches(m, o, dev) for m, o in zip(a_stream, stream_oracle)),
        "query_mono": int((mono_want != a_mono.mask)[~mono_ties].sum()),
        "mixed": _oracle_mismatches(mixed.masks, oracle, dev),
        "recal": sum(_oracle_mismatches(r.masks, [oracle[i] for i in rows], dev)
                     for r, rows in zip(recal, recal_rows)),
        "query_batch_vs_dense_off_near_ties": int(sum(
            ((a_res.masks[i] != dense_masks[i]) & off_ties[i]).sum() for i in range(q_n))),
        "mixed_vs_dense_off_near_ties": int(sum(
            ((mixed.masks[i] != dense_masks[i]) & off_ties[i]).sum() for i in range(q_n))),
    }
    _log("planner_auto", query_batch={"t_filter_s": a_res.t_filter_s, "t_verify_s": a_res.t_verify_s,
                                      "plan": _plan_line(a_plan)},
         query={"backend": a_one.backend, "t_filter_s": a_one.t_filter_s,
                "t_verify_s": a_one.t_verify_s, "plan": _plan_line(eng.explain()[n_plans + 1])},
         stream={"batches": len(stream_batches), "wall_s": stream_s,
                 "plans": [_plan_line(p) for p in eng.explain()[n_plans + 2: n_plans + 4]]},
         query_mono={"backend": a_mono.backend, "points": len(mono_want),
                     "plan": _plan_line(mono_eng.explain()[-1])},
         mixed={"t_filter_s": mixed.t_filter_s, "t_verify_s": mixed.t_verify_s,
                "plan": _plan_line(mixed_plan)},
         recal={"nudges": recal_eng.stats.planner_recal_nudges,
                "decisions": recal_eng.stats.planner_decisions,
                "pred_s": recal_eng.stats.planner_pred_s, "obs_s": recal_eng.stats.planner_obs_s,
                "const_drift": {b: [float(fresh.models[b].verify.coef[0]),
                                    float(recal_profile.models[b].verify.coef[0])]
                                for b in recal_eng.stats.planner_decisions}},
         stats={"planner_decisions": eng.stats.planner_decisions,
                "planner_pred_s": eng.stats.planner_pred_s,
                "planner_obs_s": eng.stats.planner_obs_s},
         dispatched=dispatched, mismatches=checks, launches=counted, plain_calls=plain_calls)
    if any(checks.values()):
        raise AssertionError(f"auto masks differ from the rank oracle or from dense: {checks}")
    if served_twins or plain_calls:
        raise AssertionError(f"auto served a plain version: {served_twins}, plain calls {plain_calls}")
    if not (set(MIXED_ROTATION) <= set(mixed_plan["groups"]) and mixed_plan["split"]):
        raise AssertionError(f"the mixed batch was not split four ways: {mixed_plan['groups']}")
    missing = [b for b in dispatched if b in kernel_of and counted[kernel_of[b]] < 1]
    if missing:
        raise AssertionError(f"auto dispatched {missing} but their kernels did not launch: {counted}")
    if recal_eng.stats.planner_recal_nudges < RECAL_BATCHES:
        raise AssertionError(f"online recalibration nudged {recal_eng.stats.planner_recal_nudges} times")


#: The dynamic phase: the bench's four update streams
#: (``benchmarks/bench_rknn.py`` ``update_throughput``), 2 steps each where
#: the bench runs 4, taken in turn by one engine, and the backends each
#: stream's versions are served through.
DYN_STEPS = 2
DYN_STREAMS = {
    "drift_lo": ("dense", "grid-pallas", "bvh"),
    "fjitter": ("dense", "grid-pallas", "bvh"),
    "drift_hi": ("dense",),
    "fchurn": ("dense",),
}
#: backend -> (kernel module name, launch counter) read in its counted window
DYN_KERNEL = {
    "dense": ("raycast", "batch_launches"),
    "grid-pallas": ("grid_raycast", "batch_launches"),
    "bvh": ("bvh", "batch_launches"),
    "brute": ("rank_count", "batch_launches"),
}


def _rank_counts_host(users, facilities, q_pt, exclude, workers: int = 8):
    """``rank_counts_np`` over the users in ``workers`` threads (numpy frees
    the interpreter lock in its loops and its matrix products).  Each
    thread takes whole chunks of ``rank_counts_np``'s own cut of the users,
    so every user's count comes from the very arithmetic of one call."""
    from repro_torch.core.brute import rank_counts_np

    chunk = max(1, int(2**24 // max(len(facilities), 1)))
    per = -(-len(users) // (chunk * workers)) * chunk
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        parts = pool.map(lambda s: rank_counts_np(users[s : s + per], facilities, q_pt, exclude),
                         range(0, len(users), per))
        return np.concatenate(list(parts))


def _dynamic(dev, F, U, qs) -> None:
    """The dynamic-data subsystem on the card at CAL size
    (``repro_torch.dynamic.DynamicEngine``).

    |F| = 1000 plus four corner facilities that pin the domain rect, as the
    bench pins them, so that interior churn keeps it; the main path's 64
    queries, shifted past the corners; k = 10.  One engine takes the four
    streams of :data:`DYN_STREAMS` in turn (each stream's deltas hold
    against the snapshot the one before left: the user streams move users
    in place, the facility streams keep |F| and protect the corners and the
    queries).  Each step: ``apply_updates``, then ``query_batch`` of the 64
    queries through each of the stream's backends, every one a counted
    window in which its kernel must launch and no plain version run, and
    its masks and counts bit-identical to a cold ``RkNNEngine`` on the same
    snapshot (for ``grid-pallas``, whose cold grid builds take seconds, on
    the stream's last step only).  On each stream's last step ``brute``
    (the rank kernel's query axis) is served too, and every backend's masks
    are held against the rank kernel off near ties.  The first ``drift_lo``
    step checks the user scatter: new tensors on the card, equal to a fresh
    upload bit for bit, the old version's untouched.  Two continuous
    queries (a facility and a point) ride ``drift_lo`` and ``fjitter``:
    then their masks are held against the rank kernel and their counts
    against a cold ``rank_counts_np``, and they are closed.  After the last
    ``fjitter`` step one facility query goes through ``dense`` and
    ``grid-pallas`` (``query``)."""
    import dataclasses

    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine
    from repro_torch.core.backends import QueryRequest, get_backend
    from repro_torch.dynamic import DynamicEngine
    from repro_torch.kernels import bvh, grid_raycast, ops, rank_count, raycast, ref
    from repro_torch.kernels.user_order import build_user_order
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.workloads import drifting_users, facility_churn, facility_jitter

    kernels = {"raycast": raycast, "grid_raycast": grid_raycast, "bvh": bvh,
               "rank_count": rank_count}
    t_phase = time.perf_counter()
    pts = np.concatenate([F, U])
    lo, hi = pts.min(0), pts.max(0)
    Fd = np.concatenate([[[lo[0], lo[1]], [lo[0], hi[1]], [hi[0], lo[1]], [hi[0], hi[1]]], F])
    qd = [q + 4 for q in qs]
    protect = np.concatenate([np.arange(4), qd])
    t0 = time.perf_counter()
    streams = {
        "drift_lo": drifting_users(U, steps=DYN_STEPS, frac=0.01, seed=0),
        "fjitter": facility_jitter(Fd, steps=DYN_STEPS, frac=0.02, seed=2, protect=protect),
        "drift_hi": drifting_users(U, steps=DYN_STEPS, frac=0.25, seed=1),
        "fchurn": facility_churn(Fd, steps=DYN_STEPS, rate=0.02, seed=3, protect=protect),
    }
    t_gen = time.perf_counter() - t0

    dyn = DynamicEngine(Fd, U, RkNNConfig(backend="dense"), device=dev)
    warm = {}
    for b in DYN_STREAMS["drift_lo"]:
        r = dyn.query_batch(qd, K, backend=b)
        warm[b] = {"t_filter_s": r.t_filter_s, "t_verify_s": r.t_verify_s}
    q_point = 0.5 * (Fd[qd[1]] + Fd[qd[2]])

    def register(q):
        t0 = time.perf_counter()
        return dyn.register_continuous(q, K), time.perf_counter() - t0

    # the two registrations are host numpy that frees the interpreter
    # lock, so they run side by side (each its own recount of all users)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        registered = list(pool.map(register, (qd[0], q_point)))
    handles = [h for h, _ in registered]
    _log("dynamic_setup", facilities=len(Fd), users=len(U), k=K, q=len(qd), steps=DYN_STEPS,
         streams={n: [len(b.user_move[0]) + len(b.facility_move[0]) + len(b.facility_delete)
                      for b in streams[n]] for n in streams},
         generate_s=t_gen, warm=warm, continuous_register_s=[t for _, t in registered],
         continuous_register_wall_s=time.perf_counter() - t0)

    def off_tie_mismatches(masks, ranks, u64, fac64, rows) -> tuple[int, int]:
        """Users whose mask differs from the rank kernel's ``rank < k``, and
        of those the ones at a float64 near tie (:func:`_rank64`, whose
        competitors are every row of ``fac64`` but ``rows[i]``); the rule
        of :func:`_oracle_mismatches`, with the near ties computed only
        where a verdict differs."""
        wrong = tied = 0
        for i, row in enumerate(rows):
            diff = torch.from_numpy(masks[i]).to(dev) != (ranks[i] < K)
            if bool(diff.any()):
                ties = _rank64(u64[diff], fac64, row)[1]
                tied += int(ties.sum())
                wrong += int((~ties).sum())
        return wrong, tied

    for name, backends in DYN_STREAMS.items():
        for step, batch in enumerate(streams[name]):
            last = step == DYN_STEPS - 1
            old = dyn._snap
            old_xs = old.xs.clone() if name == "drift_lo" else None
            # the writer's spans, summed by name: where t_update_s goes
            tracer = Tracer(capacity=1 << 14)
            prev = set_tracer(tracer)
            tracer.enable()
            try:
                rep = dyn.apply_updates(batch)
            finally:
                set_tracer(prev)
            spans = {}
            for r in tracer.records():
                spans[r["name"]] = spans.get(r["name"], 0.0) + r["t1"] - r["t0"]
            new = dyn._snap
            pol = dyn.refit_policy
            line = {"stream": name, "step": step, "t_update_s": rep.t_update_s,
                    "report": dataclasses.asdict(rep), "update_spans_s": spans,
                    "refit_policy": {"ema_refit_s": pol.ema_refit_s,
                                     "ema_rebuild_s": pol.ema_rebuild_s,
                                     "n_refit": pol.n_refit, "n_rebuild": pol.n_rebuild}}
            if old_xs is not None and step == 0:
                fresh = (torch.from_numpy(new.users[:, 0].astype(np.float32)).to(dev),
                         torch.from_numpy(new.users[:, 1].astype(np.float32)).to(dev))
                scatter = {"scattered": rep.users_scattered, "device": str(new.xs.device),
                           "new_tensor": new.xs is not old.xs and new.ys is not old.ys,
                           "equal_fresh_upload": bool(torch.equal(new.xs, fresh[0])
                                                      and torch.equal(new.ys, fresh[1])),
                           "old_unchanged": bool(torch.equal(old.xs, old_xs))}
                line["scatter"] = scatter
                if not (all(v for k_, v in scatter.items() if k_ != "device")
                        and new.xs.device == old_xs.device):
                    raise AssertionError(f"the user scatter: {scatter}")
            if batch.touches_users:
                # what the first query on the new user set rebuilds: the
                # users' order (dense, bvh, brute) and the cell buckets
                line["order_rebuild_ms"] = _once_ms(
                    lambda: build_user_order(new.xs, new.ys), dev)[0]
                if "grid-pallas" in backends:
                    req = QueryRequest(xs=new.xs, ys=new.ys, k=K, device=dev, users=new.users)
                    t0 = time.perf_counter()
                    get_backend("grid-pallas")._bucket(req, new.rect, GRID_G)
                    torch.cuda.synchronize(dev)
                    line["bucket_rebuild_s"] = time.perf_counter() - t0
            served = backends + (("brute",) if last else ())
            got, launches = {}, {}
            for b in served:
                mod, counter = DYN_KERNEL[b]
                setattr(kernels[mod], counter, 0)
                ref.calls = 0
                got[b] = dyn.query_batch(qd, K, backend=b)
                torch.cuda.synchronize(dev)
                launches[b] = getattr(kernels[mod], counter)
                if launches[b] < 1 or ref.calls:
                    raise AssertionError(f"dynamic {name} step {step}: {b} launched "
                                         f"{launches[b]} kernels, {ref.calls} plain calls")
                if got[b].version != rep.version:
                    raise AssertionError(f"{b} served version {got[b].version}, not {rep.version}")
            cold = RkNNEngine(new.facilities, new.users, RkNNConfig(backend="dense"), device=dev)
            cold_times, diffs = {}, {}
            for b in served:
                if b == "grid-pallas" and not last:
                    continue
                c = cold.query_batch(qd, K, backend=b)
                cold_times[b] = {"t_filter_s": c.t_filter_s, "t_verify_s": c.t_verify_s}
                diffs[b] = int((got[b].masks != c.masks).sum()) + int((got[b].counts != c.counts).sum())
                del c
            line.update(launches=launches, plain_calls=0, cold_diffs=diffs,
                        dynamic={b: {"t_filter_s": r.t_filter_s, "t_verify_s": r.t_verify_s}
                                 for b, r in got.items()},
                        cold=cold_times)
            if any(diffs.values()):
                raise AssertionError(f"dynamic {name} step {step} differs from a cold engine: {diffs}")
            del cold
            if last:
                # the rank kernel over the 64 queries (its query axis)
                t0 = time.perf_counter()
                users_dev = torch.stack((new.xs, new.ys), dim=1)
                fac_dev = torch.from_numpy(new.facilities.astype(np.float32)).to(dev)
                u64 = torch.from_numpy(new.users).to(dev)
                f64 = torch.from_numpy(new.facilities).to(dev)
                order = build_user_order(new.xs, new.ys)
                ranks = ops.rank_count_batch(users_dev, fac_dev, fac_dev[qd], exclude=qd,
                                             order=order)
                checked = {b: off_tie_mismatches(r.masks, ranks, u64, f64, qd)
                           for b, r in got.items()}
                line["oracle_mismatches"] = {b: w for b, (w, _t) in checked.items()}
                line["differing_at_near_ties"] = {b: t for b, (_w, t) in checked.items()}
                line["oracle_s"] = time.perf_counter() - t0
                if any(line["oracle_mismatches"].values()):
                    raise AssertionError(f"dynamic {name}: {line['oracle_mismatches']}")
            if name == "fjitter" and last:
                # the continuous handles against the rank kernel and a cold
                # rank_counts_np, then closed
                # the point handle's query is a last row of the facilities
                # that the rank kernel and _rank64 leave out of the competitors
                f_pt = torch.cat([f64, torch.from_numpy(q_point).to(dev)[None]])
                f_pt32 = torch.cat([fac_dev, torch.from_numpy(q_point.astype(np.float32))
                                    .to(dev)[None]])
                n_f = len(new.facilities)

                def recount(h):
                    t0 = time.perf_counter()
                    q_pt = new.facilities[h.q_idx] if h.q_idx is not None else q_point
                    return (_rank_counts_host(new.users, new.facilities, q_pt, h.q_idx, workers=4),
                            time.perf_counter() - t0)

                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    cold = list(pool.map(recount, handles))
                cont = []
                for h, (cold_counts, recount_s) in zip(handles, cold):
                    row, fac32, fac64 = ((h.q_idx, fac_dev, f64) if h.q_idx is not None
                                         else (n_f, f_pt32, f_pt))
                    rk = ops.rank_count(users_dev, fac32, fac32[row], exclude=row, order=order)
                    wrong, tied = off_tie_mismatches(h.mask[None], rk[None], u64, fac64, [row])
                    cont.append({"q": "facility" if h.q_idx is not None else "point",
                                 "oracle_mismatches": wrong, "differing_at_near_ties": tied,
                                 "count_diffs": int((h.counts != cold_counts).sum()),
                                 "recount_s": recount_s,
                                 "patched": h.n_patched, "skipped": h.n_skipped,
                                 "full": h.n_full, "events": h.n_events,
                                 "version": h.version})
                    h.close()
                line["continuous"] = cont
                if any(c["oracle_mismatches"] or c["count_diffs"] or c["version"] != rep.version
                       for c in cont):
                    raise AssertionError(f"continuous queries: {cont}")
                # one facility query through rows 2 and 4's paths
                raycast.single_launches = grid_raycast.batch_launches = 0
                ref.calls = 0
                one = {b: dyn.query(qd[0], K, backend=b) for b in ("dense", "grid-pallas")}
                torch.cuda.synchronize(dev)
                one_launches = {"raycast_count": raycast.single_launches,
                                "grid_raycast_cells (batch wrapper at Q = 1)":
                                    grid_raycast.batch_launches}
                line["query"] = {"launches": one_launches, "plain_calls": ref.calls,
                                 **{b: {"t_filter_s": r.t_filter_s, "t_verify_s": r.t_verify_s}
                                    for b, r in one.items()}}
                for b, r in one.items():
                    if not (np.array_equal(r.mask, got[b].masks[0])
                            and np.array_equal(r.counts, got[b].counts[0])):
                        raise AssertionError(f"dynamic query() through {b} differs from row 0")
                if min(one_launches.values()) < 1 or ref.calls:
                    raise AssertionError(f"dynamic query(): {one_launches}, plain {ref.calls}")
            _log("dynamic", **line)
            del got
    st = dyn.update_stats
    _log("dynamic_summary", seconds=time.perf_counter() - t_phase, version=dyn.version,
         update_stats=dataclasses.asdict(st), continuous_pruned=dyn.stats.continuous_pruned,
         writer_throttle_duty=dyn.metrics.snapshot().get("mvcc.writer_throttle_duty"))
    if dyn.stats.continuous_pruned != len(handles):
        raise AssertionError(f"closed handles pruned: {dyn.stats.continuous_pruned}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    records = run(dev, card, n_points=N_POINTS, n_facilities=N_FACILITIES, q_n=Q,
                  mono_points=MONO_POINTS, seed=args.seed)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "shape"} for r in records
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
