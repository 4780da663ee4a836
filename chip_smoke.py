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
  for) on the first ``NONPRUNED_Q`` = 32 queries of the main batch,
  ``grid-pallas`` and ``dense`` both against the oracle;
* ``bvh_path`` — the main path's engine and batch through ``bvh`` (the
  paper's LBVH walk, the CUDA stack-traversal kernel with an early exit
  at k; ``query`` and ``query_mono`` too), its masks equal to the dense
  ones and its counts to ``min(dense, k)`` off edge ties;
* ``bvh_nonpruned`` — the ``grid_nonpruned`` engine's 32 scenes (999
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
  takes the bench's four update streams, 1 step each; every version's
  batch through its backends' kernels, bit-identical to a cold engine and
  held against the rank kernel; the user scatter on the card; two
  continuous queries against the rank kernel and a cold recount (see
  :func:`_dynamic`);
* ``shard`` — sharded serving (``repro_torch.shard``): a ``ShardedEngine``
  at 2 and 4 shards on the one card takes the main path's batch through
  ``dense``, ``grid-pallas``, ``bvh`` and ``brute`` (not sharded), each
  kernel launched once per shard, masks and counts bit-identical to the
  meshless engine, then a user-move and a facility-jitter step against a
  cold engine; the engine's own ``mesh=`` path and the ``RkNNServer``
  alias (see :func:`_shard`);
* ``persist`` — persistence (``repro_torch.persist``): the main path's
  engine saved (``rknn-store/1``) and warm-constructed, every stored
  category restored, the batch through ``dense``, ``grid-pallas``,
  ``bvh`` and ``brute`` on the warm engine bit-identical with no scene
  rebuilt, ``python -m repro_torch.persist --verify`` in a fresh
  interpreter, a hot adopt under a reader (version N+1), and the 4-shard
  engine saved and warm-constructed (see :func:`_persist`);
* ``ops`` — the ops layer (``repro_torch.obs``): every live endpoint
  scraped while a stream runs, and a flight bundle written for a failing
  query and digested by ``python -m repro_torch.obs --postmortem`` (see
  :func:`_ops`);
* ``lm_serve`` — the LM substrate's serving path: qwen2-7b at the
  published widths and full depth, bf16 weights from the port's ``init``,
  8 prompts of 2,048 tokens through ``make_prefill_step`` (28 launches of
  the flash attention kernel) and 64 greedy ``make_decode_step`` steps
  (1,792 launches of the decode attention kernel), both kernels held
  against their plain versions and float64, the forward against prefill
  and decode, and the kernel path against plain and float32 paths, and
  the two kernels' wrapper times beside their device times alone (a CUDA
  graph of launches; the ``lm_serve_times`` line; see :func:`_lm_serve`);
* ``lm_moe_serve`` — the MoE serving path: deepseek-moe-16b at the
  published widths and full depth (1 dense and 27 MoE layers of 64 routed
  experts top-6 and 2 shared), bf16 weights from the port's ``init``, 8
  prompts of 2,048 tokens through ``make_prefill_step`` (54 launches of
  row 12, the routed experts' kernel, beside 28 of the flash kernel) and
  64 greedy ``make_decode_step`` steps (64 x 54 row-12 launches), then
  decode at B = 1; row 12 held against its plain version and float64 at
  the phase's prefill and decode shapes and awkward ones, the forward
  against prefill and decode (drop-free capacity), the kernel path
  against plain paths and, at the first ``LM_MOE_F32_LAYERS`` layers, a
  float32 path; row 12's times beside the padded ``torch.bmm`` MLP, the
  experts each layer touches, and profiled prefill and decode windows
  (see :func:`_lm_moe_serve`);
* ``lm_hybrid_serve`` — the hybrid family's serving path: recurrentgemma-9b
  at the published widths and full depth (26 RG-LRU and 12 local-attention
  layers, window 2,048), bf16 weights from the port's ``init``, 8 prompts
  of 4,096 tokens through ``make_prefill_step`` without padding (12 launches
  of row 13, the flash kernel with a window, and 26 of row 14, the RG-LRU
  recurrence) and 64 greedy decode steps (12 row-8 and 26 row-14 launches
  a step), then decode at B = 1; rows 13 and 14 held against their plain
  versions and float64 at the phase's inputs and awkward ones, the forward
  against prefill and decode, the kernel path against two plain paths and
  a float32 path, rows 13 and 14's times beside SDPA with a band mask, and
  profiled prefill and decode windows (see :func:`_lm_hybrid_serve`);
* ``lm_train`` — the LM substrate's training step: starcoder2-3b at the
  published widths and full depth, float32 master parameters from the
  port's ``init``, bf16 compute with per-layer remat, 4 AdamW steps of
  8 x 2,048 tokens in 2 microbatches through ``make_train_step`` (120
  launches of the flash kernel with its log-sum-exp, 60 of the backward
  kernel and one of the AdamW kernel a step), a profiled step by kind of
  kernel, and the AdamW kernel alone over every leaf beside its plain
  version and ``torch.optim.AdamW(fused=True)``; the same four steps from
  the same seed and batches with the backward's partials summed in
  another order, and with the plain versions of the three kernels at two
  blocks, the loss curves side by side (``lm_train_curves``); the
  backward kernel and the log-sum-exp held
  against their plain versions and float64, the backward's device time by
  pass, its plan and its kernels' registers (``lm_train_kernels``), and
  one step of a 2-layer model through the kernels against plain and
  float32 paths (``lm_train_checks``; see :func:`_lm_train`);
* ``lm_driver`` — the training launcher: starcoder2-3b at the published
  widths, 2 layers deep, 80 steps through ``train_main`` with two
  checkpoints in a temporary directory (the free disk logged first), the
  loss finite and falling; the same run with a transient failure and a
  device loss injected between the checkpoints, whose restarted steps
  repeat the first run's losses bit for bit (both under
  ``torch.use_deterministic_algorithms(True)``); the AdamW kernels with
  float32 and 8-bit moments bit-identical to their plain versions over 3
  updates of the model's real gradients, and the 8-bit one timed at the
  full model's leaves (see :func:`_lm_driver`).

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
held against its plain version (one walk per user) over all the queries
of both paths (64 and 32) and at Q = 1, its counts bit for bit and, from its
counting instance, each user's pops (internal nodes and leaves) equal;
the ``bvh_tiles`` line logs the nodes each user popped (mean, 99th
percentile, most), the share of users that stopped at k, the lane
efficiency, the nodes the warps took against their busiest users' pops,
and the host time of the BVH builds and of their stacking.

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
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
N_POINTS = 1_890_815  # CAL, paper Table 1
N_FACILITIES = 1_000  # the paper's default |F|
K = 10
Q = 64
STREAM_BATCHES = 4
# queries of the non-pruned paths (999 triangles a scene): the first 32 of
# the main batch (64 before the hybrid serving phase needed the time)
NONPRUNED_Q = 32
# the planner's calibration on the card keeps the best of this many runs
# of each shape (2 before the hybrid serving phase needed the time)
PLANNER_REPEATS = 1
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
# nvcc's output for each library built by this run (``-Xptxas -v``)
BUILD_LOGS: dict = {}


_T0 = time.perf_counter()


def _log(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _T0, **fields}), flush=True)


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
    with torch.cuda.graph(graph, stream=side):  # the warmed-up stream
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


def build_kernels() -> tuple[dict, float]:
    """Every kernel library built from the checkout's sources (one ``nvcc``
    a source, all at once), nvcc's output kept in ``BUILD_LOGS``; the build's
    result and seconds.  A script that runs one phase alone calls it first."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    BUILD_LOGS.update({name: info["log"] for name, info in built.items()})
    return built, time.perf_counter() - t0


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
    from repro_torch.kernels import bvh, grid_raycast, ops, rank_count, raycast, ref
    from repro_torch.kernels.grid_raycast import order_cell_runs, prepare_cell_buckets
    from repro_torch.kernels.user_order import TILE_USERS, build_user_order

    # ---- setup ------------------------------------------------------------
    built, t_build = build_kernels()
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
    # the ops phase's stream: as many new batches, after the main path's
    ops_qs = [[int(i) for i in order[q_n * (b + 1 + STREAM_BATCHES) : q_n * (b + 2 + STREAM_BATCHES)]]
              for b in range(STREAM_BATCHES)]
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
    qs_np = qs[:NONPRUNED_Q]
    oracle_np = oracle[:NONPRUNED_Q]
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
    for i, (want, ties) in enumerate(oracle_np):
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

    # ---- bvh, non-pruned: the grid_nonpruned engine's scenes, reused ------
    bvh.batch_launches = 0
    ref.calls = 0
    np_bvh = eng_np.query_batch(qs_np, K, backend="bvh")
    torch.cuda.synchronize(dev)
    np_bvh_counted = {"bvh_count_batch": bvh.batch_launches}
    np_bvh_plain = ref.calls
    nb_checks = {
        **_saturated_diffs(np_bvh, np_dense, xs64, ys64, K),
        "oracle_mismatches": _oracle_mismatches(np_bvh.masks, oracle_np, dev),
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
    # for bit against its plain version over every query at both shapes
    # and at Q = 1; its pops per lane give the operations term of the bound
    bvh_src, bvh_rows = "src/repro_torch/csrc/bvh_traverse.cu", "src/repro/core/bvh.py"

    def bvh_host_s(scenes) -> dict:
        """Host seconds of the batch's BVH builds and of their stacking, run
        once more on their own."""
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
    sharded = _shard(dev, F, U, qs, eng, {"dense": res, "grid-pallas": g_res, "bvh": b_res})
    _persist(dev, qs, eng, sharded, {"dense": res, "grid-pallas": g_res, "bvh": b_res})
    del sharded
    _ops(dev, eng, ops_qs, stream_s)
    del eng, mono_eng
    records += _lm_serve(dev, seed)
    moe_records, moe_launches = _lm_moe_serve(dev, seed)
    for r in records:  # rows 7 and 8 count lm_moe_serve's windows too
        r["launches"] += moe_launches.get(r["name"], 0)
    records += moe_records
    hybrid_records, hybrid_launches = _lm_hybrid_serve(dev, seed)
    for r in records:  # row 8 counts lm_hybrid_serve's decode window too
        r["launches"] += hybrid_launches.get(r["name"], 0)
    records += hybrid_records
    records += _lm_train(dev, seed)
    driver_records, driver_launches = _lm_driver(dev, seed)
    for r in records:  # rows 7, 9 and 10 count lm_train's and lm_driver's windows
        r["launches"] += driver_launches.get(r["name"], 0)
    records += driver_records
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
    """The query planner on the card: calibrate (the fast grid,
    ``repeats=PLANNER_REPEATS``),
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
    fresh = calibrate(device=dev, fast=True, repeats=PLANNER_REPEATS)
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
    # ``grid`` has no kernel: its count is plain PyTorch on the card (the JAX
    # package's jnp), ``ref.grid_raycast_ref``, which ``auto`` may route to
    # (the card tests' rule too); its calls are counted apart, so that
    # ``plain_calls`` counts the plain versions of the kernels alone
    grid_calls = [0]
    grid_ref_fn = ref.grid_raycast_ref

    def grid_counted(*args, **kwargs):
        grid_calls[0] += 1
        return grid_ref_fn(*args, **kwargs)

    ref.grid_raycast_ref = grid_counted
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
    ref.grid_raycast_ref = grid_ref_fn
    plain_calls = ref.calls - grid_calls[0]
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
         dispatched=dispatched, mismatches=checks, launches=counted, plain_calls=plain_calls,
         grid_backend_calls=grid_calls[0])
    if any(checks.values()):
        raise AssertionError(f"auto masks differ from the rank oracle or from dense: {checks}")
    if served_twins or plain_calls or (grid_calls[0] and "grid" not in dispatched):
        raise AssertionError(f"auto served a plain version: {served_twins}, plain calls {plain_calls}")
    if not (set(MIXED_ROTATION) <= set(mixed_plan["groups"]) and mixed_plan["split"]):
        raise AssertionError(f"the mixed batch was not split four ways: {mixed_plan['groups']}")
    missing = [b for b in dispatched if b in kernel_of and counted[kernel_of[b]] < 1]
    if missing:
        raise AssertionError(f"auto dispatched {missing} but their kernels did not launch: {counted}")
    if recal_eng.stats.planner_recal_nudges < RECAL_BATCHES:
        raise AssertionError(f"online recalibration nudged {recal_eng.stats.planner_recal_nudges} times")


#: The dynamic phase: the bench's four update streams
#: (``benchmarks/bench_rknn.py`` ``update_throughput``), 1 step each where
#: the bench runs 4 (2 before the hybrid serving phase needed the time),
#: taken in turn by one engine, and the backends each stream's versions
#: are served through.
DYN_STEPS = 1
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


#: The shard counts of the ``shard`` phase (one card serves every count)
#: and its backends: ``brute`` is not sharded (one rank launch).
SHARD_COUNTS = (2, 4)
SHARD_BACKENDS = ("dense", "grid-pallas", "bvh", "brute")


def _shard(dev, F, U, qs, eng, meshless):
    """Sharded serving on the card at CAL size (``repro_torch.shard``).

    A ``ShardedEngine`` at each of :data:`SHARD_COUNTS` shards on ``dev``
    (one engine per count, its scenes and grids built once) takes the main
    path's Q = 64 batch through :data:`SHARD_BACKENDS`, each a counted
    window: the backend's kernel launches once per shard (once for
    ``brute``) and no plain version runs; masks and counts are
    bit-identical to the main path's meshless engine (``meshless``, its
    results; ``brute`` served by ``eng`` here); the psum-reduced result
    sizes equal the masks' row sums; every view carries the snapshot's
    version; the counts are copied back once.  One line per (backend,
    shards) with the filter and verify seconds, the per-shard users and
    verify seconds, ``shard.imbalance``, the reassembly and copy-back
    milliseconds (the ``shard-reassemble`` and ``shard-copy`` spans) and
    the meshless ``t_verify_s``.  Then the 4-shard engine takes one
    ``drift_lo`` step (1 % of the users move) and one ``fjitter`` step
    (2 % of the facilities jitter), every backend bit-identical to a cold
    meshless engine after each: moved views get new tensors, the others
    (all of them on the facility step) are carried by reference.  Last
    the engine's own ``mesh=`` path at ``user_mesh(1)`` through ``bvh``
    and ``grid``, and ``RkNNServer(F, U).query_batch``, against the
    meshless engine.  Returns the 4-shard engine after its updates (the
    ``persist`` phase saves it)."""
    import warnings

    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine
    from repro_torch.kernels import bvh, grid_raycast, rank_count, raycast, ref
    from repro_torch.launch.serve import RkNNServer
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.shard import ShardedEngine, user_mesh
    from repro_torch.workloads import drifting_users, facility_jitter

    kernels = {"dense": raycast, "grid-pallas": grid_raycast, "bvh": bvh, "brute": rank_count}
    t_phase = time.perf_counter()
    meshless = dict(meshless, brute=eng.query_batch(qs, K, backend="brute"))

    def served(sh, b, want, shards) -> dict:
        """One counted, traced batch of ``sh`` through ``b``, checked
        against ``want`` (a meshless result); returns its line."""
        kernels[b].batch_launches = 0
        ref.calls = 0
        tracer = Tracer(capacity=1 << 12)
        prev = set_tracer(tracer)
        tracer.enable()
        try:
            r = sh.query_batch(qs, K, backend=b)
            torch.cuda.synchronize(dev)
        finally:
            set_tracer(prev)
        launches = kernels[b].batch_launches
        spans: dict = {}
        for rec in tracer.records():
            spans.setdefault(rec["name"], []).append(rec["t1"] - rec["t0"])
        diffs = (int((r.masks != want.masks).sum()), int((r.counts != want.counts).sum()))
        snap = sh._snap
        line = {"backend": b, "shards": shards, "version": r.version,
                "t_filter_s": r.t_filter_s, "t_verify_s": r.t_verify_s,
                "meshless_t_verify_s": want.t_verify_s, "launches": launches,
                "plain_calls": ref.calls, "mask_diffs": diffs[0], "count_diffs": diffs[1]}
        bad = diffs[0] or diffs[1] or ref.calls or launches != (1 if b == "brute" else shards)
        if b != "brute":
            st = snap.shard_state
            rec = [e for e in sh.explain() if e.get("mode") == "shard-batch"][-1]
            copies = len(spans.get("shard-copy", ()))
            line.update(
                per_shard_users=rec["per_shard_users"],
                per_shard_verify_s=rec["per_shard_verify_s"],
                imbalance=sh.stats.shard_imbalance,
                reassembly_ms=1e3 * sum(spans.get("shard-reassemble", ())),
                copy_back_ms=1e3 * sum(spans.get("shard-copy", ())),
                copies_back=copies,
                result_sizes_equal=rec["result_sizes"] == [int(m.sum()) for m in r.masks],
                views_in_lockstep=st.version == snap.version
                and all(v.version == snap.version for v in st.views),
                view_devices=sorted({str(v.xs.device) for v in st.views}),
            )
            bad = (bad or copies != 1 or not line["result_sizes_equal"]
                   or not line["views_in_lockstep"] or rec["version"] != snap.version)
        _log("shard", **line)
        if bad:
            raise AssertionError(f"shard {b} at {shards} shards: {line}")
        return r

    engines = {}
    for shards in SHARD_COUNTS:
        t0 = time.perf_counter()
        sh = ShardedEngine(F, U, RkNNConfig(backend="dense"), shards=shards, device=dev)
        for b in SHARD_BACKENDS:
            served(sh, b, meshless[b], shards)
        engines[shards] = sh
        _log("shard_engine", shards=shards, seconds=time.perf_counter() - t0,
             partition=sh._snap.shard_state.summary()["shards"])
    for shards in SHARD_COUNTS[:-1]:
        del engines[shards]

    # updates on the last engine, each held against a cold meshless engine
    shards = SHARD_COUNTS[-1]
    sh = engines.pop(shards)
    steps = (("drift_lo", drifting_users(U, steps=1, frac=0.01, seed=0)[0]),
             ("fjitter", facility_jitter(F, steps=1, frac=0.02, seed=2,
                                         protect=np.asarray(qs))[0]))
    for name, batch in steps:
        old = sh._snap.shard_state
        rep = sh.apply_updates(batch)
        new = sh._snap.shard_state
        moved_shards = set()
        if batch.touches_users:
            pos = old.pos[np.asarray(batch.user_move[0], np.int64)]
            moved_shards = set(int(s) for s in np.searchsorted(old.bounds, pos, "right") - 1)
        views = [{"shard": a.index, "moved": a.index in moved_shards,
                  "new_tensors": b.xs is not a.xs and b.ys is not a.ys,
                  "carried": b.xs is a.xs and b.ys is a.ys and b.memo is a.memo}
                 for a, b in zip(old.views, new.views)]
        cold = RkNNEngine(sh.facilities, sh.users, RkNNConfig(backend="dense"), device=dev)
        _log("shard_update", stream=name, t_update_s=rep.t_update_s,
             users_moved=len(batch.user_move[0]), facilities_moved=len(batch.facility_move[0]),
             rect_changed=rep.rect_changed, views=views)
        if new is None or any(v["new_tensors"] != v["moved"] or v["carried"] == v["moved"]
                              for v in views):
            raise AssertionError(f"shard views after {name}: {views}")
        for b in SHARD_BACKENDS:
            served(sh, b, cold.query_batch(qs, K, backend=b), shards)
        del cold

    # the engine's own mesh= path (one slab on the card) and the alias
    mesh_eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), mesh=user_mesh(1, devices=[dev]),
                          device=dev)
    mesh_line = {}
    for b in ("bvh", "grid"):
        got = mesh_eng.query_batch(qs, K, backend=b)
        want = meshless["bvh"] if b == "bvh" else eng.query_batch(qs, K, backend="grid")
        req = mesh_eng._snap.batch_cache.items()[-1][1][0]
        mesh_line[b] = {"t_filter_s": got.t_filter_s, "t_verify_s": got.t_verify_s,
                        "meshless_t_verify_s": want.t_verify_s,
                        "dispatch": req.dispatch is not None,
                        "mask_diffs": int((got.masks != want.masks).sum()),
                        "count_diffs": int((got.counts != want.counts).sum())}
        del got, want
    del mesh_eng
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        server = RkNNServer(F, U, device=dev)
    t0 = time.perf_counter()
    alias_masks = server.query_batch(qs, K)
    alias = {"seconds": time.perf_counter() - t0, "backend": server.engine.config.backend,
             "mask_diffs": int((alias_masks != meshless["dense"].masks).sum())}
    del server, alias_masks
    _log("shard_mesh", mesh={"devices": 1, **mesh_line}, alias=alias,
         seconds=time.perf_counter() - t_phase)
    if (any(v["mask_diffs"] or v["count_diffs"] or not v["dispatch"] for v in mesh_line.values())
            or alias["mask_diffs"]):
        raise AssertionError(f"mesh path {mesh_line}, alias {alias}")
    return sh


PERSIST_BACKENDS = ("dense", "grid-pallas", "bvh", "brute")


def _store_bytes(info: dict) -> dict:
    """Bytes per category of a persist report."""
    return {name: st.get("bytes") for name, st in info["categories"].items()}


def _persist(dev, qs, eng, sharded, cold) -> None:
    """Persistence on the card at CAL size (``repro_torch.persist``).

    The main path's engine ``eng`` (by now it has served ``dense``,
    ``grid-pallas``, ``bvh`` and ``brute``), with the committed profile of
    this runner class active, is saved under a temporary directory
    (``keep=1``); a new ``RkNNEngine`` is warm-constructed from it
    (``warm_store=``; config backend ``grid-pallas``) with no profile
    active (so before each adoption below), so every stored category must
    read ``restored``.  The warm
    engine serves the main path's Q = 64 batch through
    :data:`PERSIST_BACKENDS`, each a counted window: one launch of the
    backend's kernel, no plain call, no scene miss, masks and counts
    bit-identical to the saved engine's; its ``t_filter_s`` and
    ``t_verify_s`` sit beside the cold ones of the earlier phases
    (``cold``: the main, grid and BVH paths' results).  The warm engine is
    then saved over the store (step 1; ``keep=1`` drops step 0) and
    ``python -m repro_torch.persist --verify`` replays the store's queries
    cold against warm in a fresh interpreter on the card (through
    ``grid-pallas``, the stored config's backend).  Next the store is
    hot-adopted into ``eng`` by ``restore`` while a reader thread serves
    the batch: the version advances by exactly one and every reader batch
    is bit-identical.  Last the 4-shard engine of the ``shard`` phase
    (``sharded``) is saved and warm-constructed: its ``shards`` category
    restored, each batch 4 launches (1 for ``brute``) and bit-identical.
    The stores are deleted at the end."""
    import os
    import tempfile
    import threading

    import torch

    from repro_torch.core import RkNNConfig, RkNNEngine
    from repro_torch.kernels import bvh, grid_raycast, rank_count, raycast, ref
    from repro_torch.planner.profiles import (
        PROFILE_STORE, get_active_profile, load_runner_profile, set_active_profile,
    )
    from repro_torch.shard import ShardedEngine

    kernels = {"dense": raycast, "grid-pallas": grid_raycast, "bvh": bvh, "brute": rank_count}
    t_phase = time.perf_counter()
    prev_profile = get_active_profile()
    profile = load_runner_profile(str(PROFILE_STORE))
    if profile is None:
        raise AssertionError(f"no committed planner profile of this runner class in {PROFILE_STORE}")

    def restored(info: dict, what: str) -> dict:
        """Each category's status and restore seconds; every category in
        the store must read ``restored``."""
        cats = info.get("categories", {})
        bad = {n: st for n, st in cats.items() if st["status"] not in ("restored", "absent")}
        if "error" in info or bad or cats.get("dataset", {}).get("status") != "restored":
            raise AssertionError(f"{what}: categories not restored: {info}")
        return {n: {"status": st["status"], "seconds": st.get("seconds"), "items": st.get("items")}
                for n, st in cats.items()}

    def serve(engine, b, want, launches) -> dict:
        """One counted batch of ``engine`` through ``b``, held bit for bit
        against ``want``; returns its numbers."""
        kernels[b].batch_launches = 0
        ref.calls = 0
        misses = engine._snap.scene_cache.misses
        r = engine.query_batch(qs, K, backend=b)
        torch.cuda.synchronize(dev)
        line = {"t_filter_s": r.t_filter_s, "t_verify_s": r.t_verify_s,
                "launches": kernels[b].batch_launches, "plain_calls": ref.calls,
                "scene_misses": engine._snap.scene_cache.misses - misses,
                "mask_diffs": int((r.masks != want.masks).sum()),
                "count_diffs": int((r.counts != want.counts).sum())}
        if (line["launches"] != launches or line["plain_calls"] or line["scene_misses"]
                or line["mask_diffs"] or line["count_diffs"]):
            raise AssertionError(f"warm {b}: {line}")
        return line

    with tempfile.TemporaryDirectory(prefix="rknn-store-") as tmp:
        store = os.path.join(tmp, "main")
        saved = {b: eng.query_batch(qs, K, backend=b) for b in PERSIST_BACKENDS}
        set_active_profile(profile)
        t0 = time.perf_counter()
        eng.save_state(store, keep=1)
        save_s = time.perf_counter() - t0
        save_info = eng.persist_info
        set_active_profile(None)
        t0 = time.perf_counter()
        warm = RkNNEngine(eng.facilities, eng.users,
                          RkNNConfig(backend="grid-pallas", warm_store=store), device=dev)
        construct_s = time.perf_counter() - t0
        warm_cats = restored(warm.persist_info, "warm construct")
        active = get_active_profile()
        if "planner" in warm_cats and (active is None or active.to_json() != profile.to_json()):
            raise AssertionError("the restored planner profile differs from the saved one")
        backends = {}
        for b in PERSIST_BACKENDS:
            backends[b] = serve(warm, b, saved[b], 1)
            if b in cold:
                backends[b].update(cold_t_filter_s=cold[b].t_filter_s,
                                   cold_t_verify_s=cold[b].t_verify_s)
        t0 = time.perf_counter()
        warm.save_state(store, keep=1)
        resave_s = time.perf_counter() - t0
        steps = sorted(os.listdir(store))
        _log("persist", users=len(eng.users), facilities=len(eng.facilities), queries=len(qs),
             k=K, save_s=save_s, save_bytes=_store_bytes(save_info),
             save_total_bytes=sum(v or 0 for v in _store_bytes(save_info).values()),
             construct_s=construct_s, restore=warm_cats, backends=backends,
             resave_s=resave_s, steps_kept=steps)
        if steps != ["step_000000000001"]:
            raise AssertionError(f"keep=1 left {steps}")
        del warm

        # the CLI in a fresh interpreter on the card: cold against warm
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "repro_torch.persist", "--verify", store],
                             capture_output=True, text=True, env=env, timeout=900)
        cli_s = time.perf_counter() - t0
        first = [ln for ln in cli.stdout.splitlines() if ln.startswith("warm engine:")]
        _log("persist_verify", returncode=cli.returncode, wall_s=cli_s,
             first_answer=first[0] if first else None,
             last_lines=cli.stdout.splitlines()[-2:], stderr=cli.stderr[-2000:])
        if cli.returncode != 0 or "bit-identical" not in cli.stdout:
            raise AssertionError(f"persist --verify failed: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")

        # hot adopt into the live engine while a reader serves the batch
        v0 = eng._snap.version
        stop = threading.Event()
        reads: list = []
        errors: list = []

        def reader() -> None:
            try:
                while not stop.is_set() or len({v for v, _ in reads}) < 2:
                    r = eng.query_batch(qs, K)
                    same = (np.array_equal(r.masks, saved["dense"].masks)
                            and np.array_equal(r.counts, saved["dense"].counts))
                    reads.append((r.version, same))
                    if len(reads) > 200:
                        break
            except Exception as e:  # surfaced below
                errors.append(e)

        set_active_profile(None)  # the store's profile is adopted, not skipped
        th = threading.Thread(target=reader, name="persist-reader")
        th.start()
        while not reads and th.is_alive():
            time.sleep(0.01)
        t0 = time.perf_counter()
        adopt = eng.restore(store)
        adopt_s = time.perf_counter() - t0
        stop.set()
        th.join()
        adopt_cats = restored(adopt, "hot adopt")
        versions = sorted({v for v, _ in reads})
        hot = {"seconds": adopt_s, "version_before": v0, "version_after": eng._snap.version,
               "reader_batches": len(reads),
               "reader_batches_per_version": {str(v): sum(1 for w, _ in reads if w == v)
                                              for v in versions},
               "reader_mismatches": sum(1 for _, same in reads if not same),
               "restore": adopt_cats}
        _log("persist_hot_adopt", **hot)
        if (errors or eng._snap.version != v0 + 1 or hot["reader_mismatches"]
                or versions != [v0, v0 + 1]):
            raise AssertionError(f"hot adopt: {hot}, reader errors {errors}")

        # the 4-shard engine: its partition restored, S launches a batch
        shards = sharded.n_shards
        want = {b: sharded.query_batch(qs, K, backend=b) for b in PERSIST_BACKENDS}
        sh_store = os.path.join(tmp, "sharded")
        t0 = time.perf_counter()
        sharded.save_state(sh_store, keep=1)
        sh_save_s = time.perf_counter() - t0
        sh_bytes = _store_bytes(sharded.persist_info)
        set_active_profile(None)
        t0 = time.perf_counter()
        sh_warm = ShardedEngine(sharded.facilities, sharded.users,
                                RkNNConfig(backend="dense", warm_store=sh_store),
                                shards=shards, device=dev)
        sh_construct_s = time.perf_counter() - t0
        sh_cats = restored(sh_warm.persist_info, "sharded warm construct")
        if sh_cats.get("shards", {}).get("status") != "restored":
            raise AssertionError(f"the shards category was not restored: {sh_cats}")
        sh_lines = {b: serve(sh_warm, b, want[b], 1 if b == "brute" else shards)
                    for b in PERSIST_BACKENDS}
        partition = sh_warm._snap.shard_state
        same_partition = (np.array_equal(partition.perm, sharded._snap.shard_state.perm)
                          and np.array_equal(partition.bounds, sharded._snap.shard_state.bounds)
                          and all(v.xs.device == dev for v in partition.views))
        _log("persist_sharded", shards=shards, save_s=sh_save_s, save_bytes=sh_bytes,
             construct_s=sh_construct_s, restore=sh_cats, backends=sh_lines,
             same_partition=same_partition, seconds=time.perf_counter() - t_phase)
        if not same_partition:
            raise AssertionError("the restored partition differs from the saved one")
        del sh_warm, want
    set_active_profile(prev_profile)


def _ops(dev, eng, batches, main_stream_s: float) -> None:
    """The ops layer on the card (``repro_torch.obs``), on the main path's
    engine after its hot adopt: ``serve_obs(port=0)``; a thread runs
    ``stream`` over ``batches`` (new facility queries, so their scenes are
    built cold as the main path's stream's were) while the main thread
    scrapes ``/metrics``, ``/snapshot``, ``/spans``, ``/explain`` and
    ``/healthz`` in turn, with span tracing on.  Logs each route's scrape
    latency (p50, max), the stream's wall time beside the main path's
    (``main_stream_s``) and ``/snapshot``'s ``device_bytes.total`` beside
    ``torch.cuda.memory_allocated()``.  Then, under a ``FlightRecorder``
    used as a context manager, a query of an out-of-range facility id
    must write one ``rknn-flight/1`` bundle (``exception:query``), which
    ``python -m repro_torch.obs --postmortem`` digests with exit 0."""
    import http.client
    import os
    import tempfile
    import threading

    import torch

    from repro_torch.kernels import raycast, ref
    from repro_torch.obs import FlightRecorder, Tracer, set_tracer

    if not batches or not all(batches):
        raise AssertionError(f"the ops stream needs non-empty batches: {batches}")
    routes = ("/metrics", "/snapshot", "/spans?n=64", "/explain", "/healthz")
    tracer = Tracer(capacity=1 << 14)
    prev = set_tracer(tracer)
    tracer.enable()
    srv = eng.serve_obs(port=0)
    try:
        raycast.batch_launches = 0
        ref.calls = 0
        done = threading.Event()
        result: dict = {}

        def streamer() -> None:
            try:
                t0 = time.perf_counter()
                result["rows"] = sum(m.shape[0] for _, m in eng.stream(batches, K))
                result["wall_s"] = time.perf_counter() - t0
            except Exception as e:  # surfaced below
                result["error"] = e
            finally:
                done.set()

        lat: dict = {r: [] for r in routes}
        codes: dict = {r: set() for r in routes}
        snapshot = None
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        th = threading.Thread(target=streamer, name="ops-stream")
        th.start()
        while not done.is_set():
            for route in routes:
                t0 = time.perf_counter()
                conn.request("GET", route)
                resp = conn.getresponse()
                body = resp.read()
                lat[route].append(time.perf_counter() - t0)
                codes[route].add(resp.status)
                if route == "/snapshot" and resp.status == 200:
                    snapshot = json.loads(body)
        th.join()
        conn.close()
        torch.cuda.synchronize(dev)
        if "error" in result:
            raise result["error"]
        scrape = {r: {"n": len(v), "p50_ms": 1e3 * float(np.median(v)),
                      "max_ms": 1e3 * max(v), "codes": sorted(codes[r])}
                  for r, v in lat.items()}
        line = {"stream_wall_s": result["wall_s"], "main_path_stream_wall_s": main_stream_s,
                "rows": result["rows"], "launches": raycast.batch_launches,
                "plain_calls": ref.calls, "scrape": scrape,
                "snapshot_version": snapshot and snapshot["version"],
                "device_bytes": snapshot and snapshot["device_bytes"],
                "memory_allocated": torch.cuda.memory_allocated(dev),
                "spans_recorded": sum(1 for _ in tracer.records())}
        bad_routes = [r for r, c in codes.items()
                      if not c or not c <= ({200, 503} if r == "/healthz" else {200})]
        if (bad_routes or snapshot is None or line["launches"] != len(batches)
                or line["plain_calls"] or result["rows"] != sum(len(b) for b in batches)):
            _log("ops", **line)
            raise AssertionError(f"ops: routes {bad_routes}, {line}")

        # the flight recorder around a failing query, at CAL size
        with tempfile.TemporaryDirectory(prefix="rknn-flight-") as tmp:
            t0 = time.perf_counter()
            try:
                with FlightRecorder(eng, dir=tmp):
                    eng.query(len(eng.facilities) + 7, K)
                raise AssertionError("a query of an out-of-range facility id did not raise")
            except IndexError:
                pass
            dump_s = time.perf_counter() - t0
            bundles = sorted(os.listdir(tmp))
            if len(bundles) != 1:
                raise AssertionError(f"flight bundles written: {bundles}")
            path = os.path.join(tmp, bundles[0])
            with open(path) as fh:
                bundle = json.load(fh)
            env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
            pm = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--postmortem", path],
                                capture_output=True, text=True, env=env, timeout=300)
            line.update(flight={"schema": bundle["schema"], "reason": bundle["reason"],
                                "bytes": os.path.getsize(path), "dump_s": dump_s,
                                "spans": len(bundle["spans"]),
                                "postmortem_returncode": pm.returncode,
                                "postmortem_head": pm.stdout.splitlines()[:2]})
        _log("ops", **line)
        if (bundle["schema"] != "rknn-flight/1" or bundle["reason"] != "exception:query"
                or pm.returncode != 0 or eng.flight is not None):
            raise AssertionError(f"flight recorder: {line['flight']} {pm.stderr[-2000:]}")
    finally:
        srv.close()
        set_tracer(prev)


# ---- the LM substrate's serving path (lm_serve) ------------------------------

LM_ARCH = "qwen2_7b"
LM_BATCH = 8
LM_PROMPT = 2048
LM_DECODE = 64
LM_CHECK_ROWS = 2  # prompts of the forward check (f32 logits of 2 x 2049 x V: 2.5 GB)
LM_B1_STEPS = 16  # decode steps timed at B = 1
# decode steps of check 3's teacher-forced paths (the counted decode runs
# LM_DECODE): cut from 64 to keep the script inside its time limit
LM_CHECK_STEPS = 16
LM_PROFILE_STEPS = 3
# Kernel path against plain path end to end: two plain paths that differ
# only in the order of the prefill's f32 sums already differ by 0.034 of
# max |logits| after 28 bf16 layers (on an H100, PERF.md), so the rule is
# relative: the kernel path's distance to the plain path at most twice that
# spread, and its distance to a float32 path at most twice the plain path's.
LM_E2E_FACTOR = 2.0
LM_FWD_REL = 0.05  # tests/test_models.py's forward-against-prefill-and-decode rule
# H100 SXM, bf16 dense tensor cores at the full 700 W (data sheet)
PEAK_BF16_TC_S = 989e12
# awkward shapes for the kernels beside the phase's own: (B, S, K, G, D)
LM_FLASH_SHAPES = ((8, 1, 4, 7, 128), (2, 2049, 4, 7, 128), (1, 4097, 4, 7, 128),
                   (2, 1000, 4, 1, 128), (2, 1000, 4, 8, 128), (2, 1000, 4, 7, 64))
# (B, Smax, K, G, D) with their positions
LM_DECODE_SHAPES = ((4, 1000, 4, 1, 128), (4, 1000, 4, 8, 128), (4, 1000, 4, 7, 64))


def _attention64(q, k, v, causal: bool):
    """Float64 attention in the JAX GQA layout, one row at a time: the
    yardstick of row 7 and its plain version (shares no code with the
    port)."""
    import torch

    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
    for b in range(B):
        s = torch.einsum("qkgd,skd->kgqs", q[b].double(), k[b].double()) * D ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        del s
        out[b] = torch.einsum("kgqs,skd->qkgd", p, v[b].double())
    return out


def _decode64(q, k_cache, v_cache, pos):
    """Float64 one-token attention over slots ``s <= pos[b]``: row 8's
    yardstick."""
    import torch

    Smax, D = k_cache.shape[1], q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.double(), k_cache.double()) * D ** -0.5
    valid = torch.arange(Smax, device=q.device)[None, :] <= pos.long()[:, None]
    p = torch.softmax(s.masked_fill(~valid[:, None, None, None, :], float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.double())


def _yardstick(kernel, plain, want64, floor: float = 0.0) -> dict:
    """Row by row (every index but the last, the head dimension): the
    kernel's max abs error against float64 must be at most twice the plain
    version's on that row plus one bf16 ulp at the row's own max |out|
    (plus ``floor`` times the largest |out| of the whole tensor, where a
    caller states one).  Logs the largest errors over all rows and the row
    nearest its limit."""
    import torch

    err_k = (kernel.double() - want64).abs().amax(-1)
    err_p = (plain.double() - want64).abs().amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(want64.abs().amax(-1).clamp_min(1e-30))) - 7)
    excess = err_k - (2 * err_p + ulp + floor * float(want64.abs().max()))
    i = int(excess.argmax())
    out = {"err_kernel": float(err_k.max()), "err_plain": float(err_p.max()),
           "kernel_vs_plain": float((kernel.float() - plain.float()).abs().max()),
           "rows": excess.numel(), "rows_over": int((excess > 0).sum()),
           "worst_row": {"index": [int(j) for j in np.unravel_index(i, tuple(err_k.shape))],
                         "err_kernel": float(err_k.flatten()[i]),
                         "err_plain": float(err_p.flatten()[i]),
                         "bf16_ulp": float(ulp.flatten()[i])}}
    if out["rows_over"]:
        raise AssertionError(f"kernel outside 2 x plain error + 1 ulp against float64: {out}")
    return out


def _flash_bound(B, S, K, G, D) -> tuple[float, str]:
    t_ops = 4 * B * K * G * D * S * S / 2 / PEAK_BF16_TC_S
    t_bytes = 2 * (2 * B * S * K * G * D + 2 * B * S * K * D) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _decode_bound(pos, B, K, G, D, Smax) -> tuple[float, str]:
    slots = sum(min(int(p) + 1, Smax) for p in pos)
    n_bytes = 2 * slots * K * D * 2 + 2 * (2 * B * K * G * D)
    return n_bytes / PEAK_BYTES_S * 1e3, "bytes"


def _kernel_device_ms(prof) -> dict:
    """Device milliseconds of a profiled window by kind of kernel: the
    attention kernels, the AdamW kernels, matrix products (cuBLAS), and
    everything else (elementwise, norms, RoPE, embedding, argmax, copies)."""
    import torch

    kinds = {"flash_fwd": 0.0, "flash_bwd": 0.0, "decode_attn": 0.0, "adamw": 0.0, "moe": 0.0,
             "rglru": 0.0, "matmul": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        # the device's own events only: an operator's self device time
        # repeats the time of the kernels it launched
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if not us or us <= 0:
            continue
        name = evt.key
        # csrc/attention.cu: flash_fwd_wgmma_kernel (D = 64, 128) and
        # flash_fwd_mma_kernel (other head dims); decode_attn_kernel;
        # csrc/attention_bwd.cu: flash_bwd_{delta,dkdv,reduce,dq}_kernel
        # (D = 64, 128) and flash_bwd_mma_{delta,dkdv,dq}_kernel
        if "flash_fwd" in name:
            kinds["flash_fwd"] += us / 1e3
        elif "flash_bwd" in name:
            kinds["flash_bwd"] += us / 1e3
        elif "decode_attn_kernel" in name:
            kinds["decode_attn"] += us / 1e3
        elif "adamw_" in name:  # csrc/adamw.cu: adamw_f32_kernel, adamw_int8_kernel
            kinds["adamw"] += us / 1e3
        elif "moe_up_kernel" in name or "moe_down_kernel" in name:  # csrc/moe.cu, row 12
            kinds["moe"] += us / 1e3
        elif "rglru_scan_kernel" in name:  # csrc/rglru.cu, row 14
            kinds["rglru"] += us / 1e3
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
            kinds["matmul"] += us / 1e3
        else:
            kinds["other"] += us / 1e3
    return kinds


def _device_kernels_ms(prof, top: int = 12) -> dict:
    """The ``top`` kernels of a profiled window by device milliseconds,
    their names cut to 60 characters (row 9's four passes are
    ``flash_bwd_{delta,dkdv,reduce,dq}_kernel``)."""
    import torch

    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us and us > 0:
            out[evt.key[:60]] = out.get(evt.key[:60], 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def _start_profiler(notes: dict):
    """A started ``torch.profiler`` over the host and the card, or None
    (the error noted) where it cannot start: the profile is a diagnostic."""
    try:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        notes["error"] = repr(exc)
        return None
    return prof


def _lm_serve(dev, seed: int) -> list:
    """qwen2-7b at the published widths and full depth on the card through
    ``build_model`` / ``make_prefill_step`` / ``make_decode_step``: 8
    prompts of 2,048 tokens from the token pipeline, prefill with the cache
    padded to 2,048 + 64, then 64 greedy decode steps.  Checks: rows 7 and
    8 against their plain versions and float64 at the phase's shapes and
    awkward ones; the forward against prefill and the first decode step on
    2 prompts (0.05 of max |logits|) with ``pos == 2049``; the kernel path
    against the plain path teacher-forced with the kernel path's tokens
    (within twice the spread of two plain paths, and within twice the plain
    path's distance to a float32 path: ``LM_E2E_FACTOR``); 28 flash
    launches in the prefill and 64 x 28 decode launches in the decode, with
    no plain call.  Returns rows 7 and 8's records."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ref
    from repro_torch.models import decoder as dec
    from repro_torch.models.common import Policy, rope_tables, take_embedding
    from repro_torch.models.registry import build_model
    from repro_torch.steps.train import make_decode_step, make_prefill_step

    def plain_attention():
        """The plain versions in place of the kernels' wrappers while the
        plain paths of check 3 run (the decoder calls the wrappers through
        ``repro_torch.kernels.attention``)."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            kattn, "flash_attention", lambda q, k, v, *, causal=True, q_block=512, kv_block=1024:
            ref.flash_attention_ref(q, k, v, causal, q_block, kv_block)))
        stack.enter_context(mock.patch.object(kattn, "decode_attention", ref.decode_attention_ref))
        return stack

    # float32 products in full float32 (PyTorch's default, stated): the plain
    # versions and the yardsticks must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros((), device=dev)  # the card's allocator is up before its stats are read
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(LM_ARCH)
    G = cfg.n_heads // cfg.n_kv_heads
    smax = LM_PROMPT + LM_DECODE

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed), dtype=Policy.compute_dtype)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config counts {cfg.param_count()}")
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    t0 = time.perf_counter()
    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT, global_batch=LM_BATCH, seed=seed))
    prompts = torch.from_numpy(pipe.batch_at(0)["tokens"]).long().to(dev)
    data_s = time.perf_counter() - t0
    prefill = make_prefill_step(model, pad_cache_to=smax)
    decode = make_decode_step(model)

    # warm-up (cuBLAS handles, the kernels' first launches), not counted
    _, wc = make_prefill_step(model, pad_cache_to=80)(params, prompts[:1, :64], {})
    decode(params, prompts[:1, 64:65], wc)
    del wc
    torch.cuda.synchronize(dev)

    # ---- counted prefill -----------------------------------------------------
    kattn.flash_launches = kattn.decode_launches = 0
    ref.calls = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, {})
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_counted = {"flash_fwd": kattn.flash_launches, "decode_attn": kattn.decode_launches,
                       "plain_calls": ref.calls}
    if prefill_counted != {"flash_fwd": cfg.n_layers, "decode_attn": 0, "plain_calls": 0}:
        raise AssertionError(f"prefill window: {prefill_counted}, want {cfg.n_layers} flash")
    prefill_logits = logits

    # ---- counted decode: 64 greedy steps -------------------------------------
    tok = logits.argmax(dim=-1, keepdim=True)
    tokens, step_logits = [tok], []
    kattn.flash_launches = kattn.decode_launches = 0
    ref.calls = 0
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        logits, cache = decode(params, tok, cache)
        if i == 0:
            pos_after_first = cache["pos"].clone()
        tok = logits.argmax(dim=-1, keepdim=True)
        step_logits.append(logits)
        tokens.append(tok)
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t0
    decode_counted = {"flash_fwd": kattn.flash_launches, "decode_attn": kattn.decode_launches,
                      "plain_calls": ref.calls}
    if decode_counted != {"flash_fwd": 0, "decode_attn": LM_DECODE * cfg.n_layers,
                          "plain_calls": 0}:
        raise AssertionError(f"decode window: {decode_counted}, want "
                             f"{LM_DECODE * cfg.n_layers} decode")
    gen = torch.cat(tokens, dim=1)  # [B, 65]: tok0 from the prefill, then one a step
    if int(cache["pos"].min()) != smax or not bool(torch.isfinite(torch.stack(step_logits)).all()):
        raise AssertionError(f"decode ended at pos {cache['pos'].tolist()} or non-finite logits")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    _log("lm_serve", arch=cfg.name, describe=cfg.describe(), params=n_params,
         weight_gb=weight_bytes / 1e9, batch=LM_BATCH, prompt=LM_PROMPT, decode_steps=LM_DECODE,
         cache_slots=smax, init_s=init_s, data_s=data_s, prefill_s=prefill_s,
         prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_s, decode_ms_step=decode_s * 1e3 / LM_DECODE,
         decode_tok_s=LM_BATCH * LM_DECODE / decode_s, serving_max_memory_allocated_gb=peak_gb,
         memory_before_gb=mem_before / 1e9, prefill_counted=prefill_counted,
         decode_counted=decode_counted, first_tokens=gen[:, :8].tolist())

    failures = []  # raised at the end, after every reading is logged
    # ---- check 2: forward against prefill and the first decode step ------------
    rows = LM_CHECK_ROWS
    fwd_tokens = torch.cat([prompts[:rows], gen[:rows, :1]], dim=1)  # 2,049 tokens
    fwd, _ = model.forward(params, fwd_tokens, {})
    scale = float(fwd.abs().max())
    fwd_check = {
        "prefill_rel": float((prefill_logits[:rows] - fwd[:, LM_PROMPT - 1]).abs().max()) / scale,
        "decode_rel": float((step_logits[0][:rows] - fwd[:, LM_PROMPT]).abs().max()) / scale,
        "pos_after_first": pos_after_first.tolist(), "scale": scale}
    del fwd
    torch.cuda.empty_cache()
    if (fwd_check["prefill_rel"] >= LM_FWD_REL or fwd_check["decode_rel"] >= LM_FWD_REL
            or any(p != LM_PROMPT + 1 for p in fwd_check["pos_after_first"])):
        raise AssertionError(f"forward against prefill and decode: {fwd_check}")

    # ---- check 1: rows 7 and 8 against their plain versions and float64 --------
    layer0 = params.groups[0]["p0"][0]
    positions = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev)[None].expand(LM_BATCH, -1)
    x0 = take_embedding(params.embed, prompts)
    q, k, v = dec._qkv(layer0.attn, dec._norm(cfg, x0, layer0.norm1),
                       rope_tables(positions, cfg.hd, cfg.rope_theta), cfg)
    del x0
    flash_checks = {"phase": _yardstick(
        kattn.flash_attention(q, k, v, causal=True),
        ref.flash_attention_ref(q, k, v, True, cfg.q_block, cfg.kv_block),
        _attention64(q, k, v, True))}
    gen_rng = torch.Generator(dev).manual_seed(seed + 23)

    def randn(*shape):
        return torch.randn(shape, generator=gen_rng, device=dev).to(torch.bfloat16)

    for B, S, K, Gs, D in LM_FLASH_SHAPES:
        qa, ka, va = randn(B, S, K, Gs, D), randn(B, S, K, D), randn(B, S, K, D)
        flash_checks[f"{B}x{S}x{K}x{Gs}x{D}"] = _yardstick(
            kattn.flash_attention(qa, ka, va), ref.flash_attention_ref(qa, ka, va, True, 512, 1024),
            _attention64(qa, ka, va, True))
    qa, ka, va = randn(2, 300, 4, 7, 128), randn(2, 700, 4, 128), randn(2, 700, 4, 128)
    flash_checks["2x300x700 non-causal"] = _yardstick(
        kattn.flash_attention(qa, ka, va, causal=False),
        ref.flash_attention_ref(qa, ka, va, False, 512, 1024), _attention64(qa, ka, va, False))
    del qa, ka, va

    kc, vc = cache["groups"][0]["p0"]["k"][0], cache["groups"][0]["p0"]["v"][0]  # layer 0
    qd = q[:, -1:].contiguous()  # layer 0's query at the last prompt position
    pos_sets = {"equal": [LM_PROMPT] * LM_BATCH,
                "ragged": [i * (smax - 1) // (LM_BATCH - 1) for i in range(LM_BATCH)],
                "one_zero": [0] + [LM_PROMPT] * (LM_BATCH - 1)}
    decode_checks = {}
    for name, pos_list in pos_sets.items():
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        decode_checks[name] = _yardstick(
            kattn.decode_attention(qd, kc, vc, pos), ref.decode_attention_ref(qd, kc, vc, pos),
            _decode64(qd, kc, vc, pos))
    # B = 1, the most splits a pair (a plan of its own): row 0 of layer 0's
    # cache at the first decode step's and the last slot's positions, at a
    # split's edges, 0, and < 0 (every slot masked: the mean of v over them)
    qd1, kc1, vc1 = qd[:1], kc[:1], vc[:1]
    b1_splits, b1_len = kattn.decode_plan(dev, 1, cfg.n_kv_heads, smax, cfg.hd)
    for p in (LM_PROMPT, smax - 1, b1_len - 1, b1_len, 0, -1):
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        want64 = (_decode64(qd1, kc1, vc1, pos) if p >= 0 else
                  vc1.double().mean(1)[:, None, :, None, :].expand(qd1.shape))
        decode_checks[f"b1_pos{p}"] = _yardstick(
            kattn.decode_attention(qd1, kc1, vc1, pos),
            ref.decode_attention_ref(qd1, kc1, vc1, pos), want64)
    for B, Smax, K, Gs, D in LM_DECODE_SHAPES:
        qa, ka, va = randn(B, 1, K, Gs, D), randn(B, Smax, K, D), randn(B, Smax, K, D)
        pos = torch.tensor([0, Smax // 3, Smax - 2, Smax - 1][:B], dtype=torch.int32, device=dev)
        decode_checks[f"{B}x{Smax}x{K}x{Gs}x{D}"] = _yardstick(
            kattn.decode_attention(qa, ka, va, pos), ref.decode_attention_ref(qa, ka, va, pos),
            _decode64(qa, ka, va, pos))
    _log("lm_serve_kernels", flash=flash_checks, decode=decode_checks,
         decode_b1_plan={"n_splits": b1_splits, "split_len": b1_len})

    # ---- check 3: kernel path against plain path, teacher-forced ---------------
    def teacher_forced(mdl):
        """Logits of the prefill and of the first ``LM_CHECK_STEPS`` steps,
        fed the kernel path's tokens: ``[1 + LM_CHECK_STEPS, B, V]`` f32."""
        lg, c = make_prefill_step(mdl, pad_cache_to=smax)(params, prompts, {})
        out = [lg]
        step = make_decode_step(mdl)
        for i in range(LM_CHECK_STEPS):
            lg, c = step(params, gen[:, i:i + 1], c)
            out.append(lg)
        return torch.stack(out)

    kernel_path = torch.cat([prefill_logits[None], torch.stack(step_logits[:LM_CHECK_STEPS])])
    kattn.flash_launches = kattn.decode_launches = 0
    ref.calls = 0
    t0 = time.perf_counter()
    with plain_attention():
        plain_path = teacher_forced(model)
    torch.cuda.synchronize(dev)
    plain_path_s = time.perf_counter() - t0
    plain_counted = {"flash_fwd": kattn.flash_launches, "decode_attn": kattn.decode_launches,
                     "plain_calls": ref.calls}
    # the spread of two plain paths that differ only in the prefill's blocks
    # (another order of the f32 sums), and a float32 path (the weights
    # upcast exactly, float32 compute, plain attention): what bf16 rounding
    # alone makes of 28 layers
    other_blocks = dataclasses.replace(cfg, q_block=256, kv_block=256)
    compute = Policy.compute_dtype
    with plain_attention():
        plain_other = teacher_forced(build_model(other_blocks, device=dev))
        try:
            params.float()
            Policy.compute_dtype = torch.float32
            f32_path = teacher_forced(model)
        finally:
            Policy.compute_dtype = compute
            params.to(torch.bfloat16)  # exact: the values came from bf16
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).tolist()

    def argmax_share(a, b):
        return float((a.argmax(-1) != b.argmax(-1)).float().mean())

    def argmax_steps(a, b):  # share of steps with any row's argmax apart
        return float((a.argmax(-1) != b.argmax(-1)).any(dim=1).float().mean())

    kp, pp = rel(kernel_path, plain_path), rel(plain_other, plain_path)
    k32, p32 = rel(kernel_path, f32_path), rel(plain_path, f32_path)
    e2e = {"kernel_vs_plain_max": max(kp), "kernel_vs_plain_prefill": kp[0],
           "plain_blocks_vs_plain_max": max(pp), "kernel_vs_f32_max": max(k32),
           "plain_vs_f32_max": max(p32),
           "argmax_differs_share": {"kernel_vs_plain": argmax_share(kernel_path, plain_path),
                                    "plain_blocks_vs_plain": argmax_share(plain_other, plain_path),
                                    "kernel_vs_f32": argmax_share(kernel_path, f32_path),
                                    "plain_vs_f32": argmax_share(plain_path, f32_path)},
           "argmax_differs_steps_share": argmax_steps(kernel_path, plain_path),
           "per_step": {"kernel_vs_plain": kp, "plain_blocks_vs_plain": pp,
                        "kernel_vs_f32": k32, "plain_vs_f32": p32},
           "plain_path_s": plain_path_s, "plain_counted": plain_counted}
    del kernel_path, plain_path, plain_other, f32_path
    _log("lm_serve_checks", forward=fwd_check, e2e=e2e)
    if plain_counted["flash_fwd"] or plain_counted["decode_attn"]:
        raise AssertionError(f"the plain path launched a kernel: {plain_counted}")
    if max(kp) > LM_E2E_FACTOR * max(pp):
        failures.append(f"kernel path against plain path {max(kp)} > {LM_E2E_FACTOR} x the "
                        f"plain paths' spread {max(pp)}")
    if max(k32) > LM_E2E_FACTOR * max(p32):
        failures.append(f"kernel path against float32 {max(k32)} > {LM_E2E_FACTOR} x the plain "
                        f"path's {max(p32)}")

    # ---- times of rows 7 and 8 at the phase's shapes ---------------------------
    import torch.nn.functional as F

    B, S, K, D = LM_BATCH, LM_PROMPT, cfg.n_kv_heads, cfg.hd
    H = cfg.n_heads
    q_sdpa = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    k_sdpa, v_sdpa = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    flash_ms = _sync_ms(lambda: kattn.flash_attention(q, k, v), 10, dev)
    flash_device_ms = _graph_ms(lambda: kattn.flash_attention(q, k, v), 10, dev)
    flash_plain_ms = _sync_ms(
        lambda: ref.flash_attention_ref(q, k, v, True, cfg.q_block, cfg.kv_block), 2, dev)
    flash_lib_ms = _sync_ms(lambda: F.scaled_dot_product_attention(
        q_sdpa, k_sdpa, v_sdpa, is_causal=True, enable_gqa=True), 10, dev)
    del q_sdpa, k_sdpa, v_sdpa
    pos = torch.full((B,), LM_PROMPT, dtype=torch.int32, device=dev)  # the first decode step
    qd_sdpa = qd.reshape(B, 1, H, D).transpose(1, 2).contiguous()
    kc_sdpa, vc_sdpa = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(smax, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    decode_ms = _sync_ms(lambda: kattn.decode_attention(qd, kc, vc, pos), 50, dev)
    decode_device_ms = _graph_ms(lambda: kattn.decode_attention(qd, kc, vc, pos), 50, dev)
    decode_splits = kattn.decode_plan(dev, B, K, smax, D)
    decode_plain_ms = _sync_ms(lambda: ref.decode_attention_ref(qd, kc, vc, pos), 20, dev)
    decode_lib_ms = _sync_ms(lambda: F.scaled_dot_product_attention(
        qd_sdpa, kc_sdpa, vc_sdpa, attn_mask=mask, enable_gqa=True), 50, dev)
    del qd_sdpa, kc_sdpa, vc_sdpa, q, k, v
    # the device's time alone (a CUDA graph of the launches), beside the
    # wrapper's in the kernels line (CUDA events around back-to-back calls:
    # bound by the host's work per call where that exceeds the kernel's)
    _log("lm_serve_times", flash_device_ms=flash_device_ms, decode_device_ms=decode_device_ms,
         decode_splits={"n_splits": decode_splits[0], "split_len": decode_splits[1]})

    # ---- decode at B = 1, and a profiled window of B = 1 and B = 8 -------------
    del cache  # full: the profiled B = 8 steps take a fresh one, inside its slots
    _, c1 = prefill(params, prompts[:1], {})
    tok1 = gen[:1, :1]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(LM_B1_STEPS):
        l1, c1 = decode(params, tok1, c1)
        tok1 = l1.argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize(dev)
    b1_ms = (time.perf_counter() - t0) * 1e3 / LM_B1_STEPS
    _, c8 = prefill(params, prompts, {})
    profiles = {}
    # B = 1 at pos 2,064 on, B = 8 at pos 2,048 on: both inside the cache
    steps = {"b1": (c1, tok1, b1_ms), "b8": (c8, gen[:, :1], decode_s * 1e3 / LM_DECODE)}
    for name, (c, t, step_ms) in steps.items():
        for _ in range(2):  # the first profiled window pays the profiler's start
            torch.cuda.synchronize(dev)
            prof = _start_profiler(profiles)
            if prof is None:
                break
            for _ in range(LM_PROFILE_STEPS):
                _, c = decode(params, t, c)
            torch.cuda.synchronize(dev)
            prof.stop()
        if prof is None:
            break
        kinds = {k2: v2 / LM_PROFILE_STEPS for k2, v2 in _kernel_device_ms(prof).items()}
        busy = sum(kinds.values())
        # against the unprofiled step's wall time (the profiler slows the host)
        profiles[name] = {"device_ms_step": kinds, "device_busy_ms_step": busy,
                          "unprofiled_ms_step": step_ms,
                          "idle_share": 1 - busy / step_ms if busy else None}
    _log("lm_serve_decode", b1_ms_step=b1_ms, b1_tok_s=1e3 / b1_ms,
         b8_ms_step=decode_s * 1e3 / LM_DECODE, b8_tok_s=LM_BATCH * LM_DECODE / decode_s,
         profiled_steps=LM_PROFILE_STEPS, profiles=profiles,
         phase_max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del c1, c8, params
    torch.cuda.empty_cache()

    if failures:
        raise AssertionError("; ".join(failures))
    src = "src/repro_torch/csrc/attention.cu"
    flash_bound, flash_by = _flash_bound(B, S, K, G, D)
    decode_bound, decode_by = _decode_bound(pos.tolist(), B, K, G, D, smax)
    return [
        {"name": "flash_fwd", "route": "cuda", "source": src,
         "replaces": "src/repro/models/attention.py:59", "launches": prefill_counted["flash_fwd"],
         "max_abs_err": flash_checks["phase"]["kernel_vs_plain"], "ms": flash_ms,
         "plain_ms": flash_plain_ms, "bound_ms": flash_bound, "bound_by": flash_by,
         "library_ms": flash_lib_ms, "shape": {"B": B, "S": S, "K": K, "G": G, "D": D}},
        {"name": "decode_attn", "route": "cuda", "source": src,
         "replaces": "src/repro/models/attention.py:344",
         "launches": decode_counted["decode_attn"],
         "max_abs_err": decode_checks["equal"]["kernel_vs_plain"], "ms": decode_ms,
         "plain_ms": decode_plain_ms, "bound_ms": decode_bound, "bound_by": decode_by,
         "library_ms": decode_lib_ms,
         "shape": {"B": B, "Smax": smax, "pos": LM_PROMPT, "K": K, "G": G, "D": D}},
    ]


# ---- the MoE serving path (lm_moe_serve) --------------------------------------

LM_MOE_ARCH = "deepseek_moe_16b"
# check 2's prompts (f32 logits of 4 x 2,049 x 102,400: 3.4 GB)
LM_MOE_CHECK_ROWS = 4
# a router near-tie at deepseek's logits (about 1 in magnitude): the k-th
# and (k+1)-th within 8 bf16 ulps, where two passes that round apart (the
# forward and the decode step) may choose apart; with random weights the
# router's probabilities are near-uniform and 27 MoE layers meet many
LM_MOE_TIE_GAP = 0.0625
# check 3's float32 leg: the first 6 layers (1 dense, 5 MoE); float32
# copies of all 28 would take 65.5 GB beside the 32.8 GB of bf16 weights
LM_MOE_F32_LAYERS = 6
# row 12 at deepseek's widths beside the phase's own shapes: compact runs
# of each (expert, group), [n_groups][64] counts
LM_MOE_AWKWARD = {
    "empty_experts": [[37 if e % 4 == 0 else 0 for e in range(64)]],
    "one_expert_full": [[480 if e == 7 else 0 for e in range(64)]],
    "ragged_tiles": [[(65, 1, 127, 130, 0, 64)[e % 6] for e in range(64)],
                     [(0, 129, 2, 63)[e % 4] for e in range(64)]],
    "b1": [[1 if e in (3, 9, 17, 40, 41, 63) else 0 for e in range(64)]],
    # the tiles' edges: a narrow tile's 64 rows and 65, a wide tile's 128 and 129
    "tile_edges": [[(128, 129, 64, 65, 0)[e % 5] for e in range(64)]],
}


def _route_recorder(tffn, k: int, store: list):
    """A patch of ``repro_torch.models.ffn.route`` that appends each MoE
    layer's sorted top-k, its k-th minus (k+1)-th router logit (the
    probabilities' log ratio) and its probabilities ``[tokens, E]`` to
    ``store``, one entry a layer in order."""
    import torch

    real = tffn.route

    def route(probs, moe_cfg, capacity):
        r = real(probs, moe_cfg, capacity)
        flat = probs.reshape(-1, probs.shape[-1])
        top = torch.sort(flat, dim=-1, descending=True).values
        store.append((r.topi.reshape(-1, k).sort(-1).values,
                      torch.log(top[:, k - 1]) - torch.log(top[:, k]), flat))
        return r

    return mock.patch.object(tffn, "route", route)


def _routes_apart(want: list, got: list, want_tok: int, got_tok: int):
    """``(layer, gap, probs_rel)``: the first MoE layer where token
    ``got_tok`` of one pass takes other experts than token ``want_tok`` of
    another (None where they agree in every layer), the logit gap there in
    ``want``, and the largest difference of the two tokens' router
    probabilities over the layers before it, over their max."""
    rel = 0.0
    for layer, ((sets_w, gap_w, p_w), (sets_g, _, p_g)) in enumerate(zip(want, got)):
        if bool((sets_w[want_tok] != sets_g[got_tok]).any()):
            return layer, float(gap_w[want_tok]), rel
        rel = max(rel, float((p_w[want_tok] - p_g[got_tok]).abs().max() / p_w[want_tok].max()))
    return None, None, rel


def _moe_mlp64(xc, offsets, w_in, w_gate, w_out):
    """Float64 swiglu expert MLP over each compact run, unrounded: row 12's
    yardstick (shares no code with the port)."""
    import torch

    off = offsets.tolist()
    n = (len(off) - 1) // w_in.shape[0]  # runs in (expert, group) order
    out = torch.zeros((xc.shape[0], w_out.shape[2]), dtype=torch.float64, device=xc.device)
    for q in range(len(off) - 1):
        a, b = off[q], off[q + 1]
        if a == b:
            continue
        e = q // n
        x = xc[a:b].double()
        g = x @ w_gate[e].double()
        out[a:b] = ((x @ w_in[e].double()) * g * torch.sigmoid(g)) @ w_out[e].double()
    return out


def _moe_bound(offsets, E: int, d: int, f: int) -> tuple[float, str, dict]:
    """Row 12's least time: the touched experts' weights (3 d f bf16 each)
    and the rows in and out over the HBM rate, or 6 R d f over the bf16
    tensor-core rate, for these runs."""
    runs = (offsets[1:] - offsets[:-1]).view(E, -1)  # [E, n_groups]
    rows = int(offsets[-1])
    touched = int((runs.sum(1) > 0).sum())
    n_bytes = touched * 3 * d * f * 2 + 2 * rows * d * 2
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, 6 * rows * d * f / PEAK_BF16_TC_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            {"rows": rows, "touched_experts": touched, "groups": runs.shape[1]})


def _moe_seen(kmoe, E: int, prefill, decode, params, prompts, tok) -> dict:
    """Row 12's inputs ``(xc, offsets, rows_bound)`` at the first MoE layer
    of a prefill of ``prompts``, of a decode step at their batch and of one
    at B = 1 (``tok [B, 1]`` the next tokens), captured by patching
    ``kernels.moe.moe_expert_mlp``; and the experts each layer touched, by
    label ``prefill``, ``decode_b8``, ``decode_b1``."""
    import torch

    real = kmoe.moe_expert_mlp
    seen: dict = {}

    def recorder(label):
        def call(xc, offsets, rows_bound, w_in, w_gate, w_out, act):
            runs = (offsets[1:] - offsets[:-1]).view(E, -1)  # [E, n_groups]
            seen.setdefault(label, {"touched": [], "first": None})
            seen[label]["touched"].append((runs > 0).sum(0))
            if seen[label]["first"] is None:
                seen[label]["first"] = (xc.clone(), offsets.clone(), rows_bound)
            return real(xc, offsets, rows_bound, w_in, w_gate, w_out, act)
        return call

    with mock.patch.object(kmoe, "moe_expert_mlp", recorder("prefill")):
        _, c8 = prefill(params, prompts, {})
    with mock.patch.object(kmoe, "moe_expert_mlp", recorder("decode_b8")):
        decode(params, tok, c8)
    del c8
    _, c1 = prefill(params, prompts[:1], {})
    with mock.patch.object(kmoe, "moe_expert_mlp", recorder("decode_b1")):
        decode(params, tok[:1], c1)
    del c1
    torch.cuda.synchronize()
    return seen


def _row12_times(dev, cfg, layer1, seen) -> dict:
    """Row 12 at the three shapes ``seen`` holds (:func:`_moe_seen`), with
    the first MoE layer's weights ``layer1``: the wrapper's ms (CUDA
    events), its device ms (a CUDA graph), the plain version's ms, JAX's
    padded form as one ``torch.bmm`` MLP over ``[E, n C, d]`` (C the
    capacity: 480 at the prefill, the pairs of a decode step), the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe as kmoe
    from repro_torch.kernels import ref

    E, k, d, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.moe.d_ff_expert
    wts = (layer1.w_in, layer1.w_gate, layer1.w_out)

    def padded(xc, offsets, cap):
        """JAX's capacity-padded expert buffer [E, n * cap, d] of the runs."""
        n = (offsets.numel() - 1) // E
        rows = int(offsets[-1])
        r = torch.arange(rows, device=dev)
        q = torch.searchsorted(offsets[1:], r.to(torch.int32), right=True)  # (expert, group)
        xe = torch.zeros((E, n * cap, d), dtype=xc.dtype, device=dev)
        xe[q // n, (q % n) * cap + (r - offsets[q])] = xc[:rows]
        return xe

    def library(xe):
        return torch.bmm(torch.bmm(xe, layer1.w_in) * F.silu(torch.bmm(xe, layer1.w_gate)),
                         layer1.w_out)

    times = {}
    caps = {"prefill": max(1, int(cfg.moe.capacity_factor * 4096 * k / E)),
            "decode_b8": LM_BATCH * k, "decode_b1": k}
    for label in ("prefill", "decode_b8", "decode_b1"):
        xc, offsets, bound = seen[label]["first"]
        reps = 10 if label == "prefill" else 50

        def kernel():
            return kmoe.moe_expert_mlp(xc, offsets, bound, *wts[:2], wts[2], "swiglu")
        xe = padded(xc, offsets, caps[label])
        b_ms, b_by, b_shape = _moe_bound(offsets, E, d, f)
        times[label] = {
            "ms": _sync_ms(kernel, reps, dev), "device_ms": _graph_ms(kernel, reps, dev),
            "plain_ms": _sync_ms(lambda: ref.moe_expert_mlp_ref(xc, offsets, bound, *wts,
                                                                 "swiglu"), 3, dev),
            "library_ms": _sync_ms(lambda: library(xe), reps, dev), "bound_ms": b_ms,
            "bound_by": b_by, "padded_rows": E * xe.shape[1], **b_shape}
        del xe
    return times


def _lm_moe_serve(dev, seed: int) -> tuple[list, dict]:
    """deepseek-moe-16b at the published widths and full depth (28 layers:
    1 dense, 27 MoE of 64 routed experts top-6 and 2 shared) on the card
    through ``build_model`` / ``make_prefill_step`` / ``make_decode_step``:
    8 prompts of 2,048 tokens from the token pipeline, prefill with the
    cache padded to 2,112, 64 greedy decode steps at B = 8, then decode at
    B = 1.  Checks: row 12 against its plain version and float64 at the
    phase's prefill and decode shapes and awkward ones; the forward against
    prefill and the first decode step on ``LM_MOE_CHECK_ROWS`` prompts with
    drop-free capacity (0.05 of max |logits|); the kernel path against the
    plain path teacher-forced (``LM_E2E_FACTOR``), and against a float32
    path at the first ``LM_MOE_F32_LAYERS`` layers; 54 row-12 launches a
    prefill and 64 x 54 in the decode, no plain call.  Random weights make
    the router's probabilities near-uniform, and a near-tie at one of 27
    layers sends a token to another expert wherever two passes round apart
    (forward and decode; kernel and plain): check 2 then holds the token's
    router probabilities before that layer within 0.05 of their max and
    the tie within ``LM_MOE_TIE_GAP``, in place of its logits; check 3's
    paths diverge so at every layer, and its rule compares like with like.
    Returns row 12's record and the phase's launches of rows 7 and 8."""
    import copy

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import moe as kmoe
    from repro_torch.kernels import ref
    from repro_torch.models import ffn as tffn
    from repro_torch.models.common import Policy
    from repro_torch.models.decoder import Decoder
    from repro_torch.models.registry import build_model
    from repro_torch.steps.train import make_decode_step, make_prefill_step

    def plain_kernels():
        """The plain versions of rows 7, 8 and 12 in place of their wrappers."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            kattn, "flash_attention", lambda q, k, v, *, causal=True, q_block=512, kv_block=1024:
            ref.flash_attention_ref(q, k, v, causal, q_block, kv_block)))
        stack.enter_context(mock.patch.object(kattn, "decode_attention", ref.decode_attention_ref))
        stack.enter_context(mock.patch.object(kmoe, "moe_expert_mlp", ref.moe_expert_mlp_ref))
        return stack

    def counts():
        return {"flash_fwd": kattn.flash_launches, "decode_attn": kattn.decode_launches,
                "moe": kmoe.moe_launches, "plain_calls": ref.calls}

    def reset():
        kattn.flash_launches = kattn.decode_launches = kmoe.moe_launches = ref.calls = 0

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros((), device=dev)
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(LM_MOE_ARCH)
    E, k, d, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.moe.d_ff_expert
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    smax = LM_PROMPT + LM_DECODE

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed), dtype=Policy.compute_dtype)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config counts {cfg.param_count()}")
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    layer1 = params.groups[1]["p0"][0].moe  # the first MoE layer's experts

    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT, global_batch=LM_BATCH, seed=seed))
    prompts = torch.from_numpy(pipe.batch_at(0)["tokens"]).long().to(dev)
    prefill = make_prefill_step(model, pad_cache_to=smax)
    decode = make_decode_step(model)

    _, wc = make_prefill_step(model, pad_cache_to=80)(params, prompts[:1, :64], {})
    decode(params, prompts[:1, 64:65], wc)
    del wc
    torch.cuda.synchronize(dev)

    # ---- counted prefill and 64 greedy decode steps ----------------------------
    reset()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, {})
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_counted = counts()
    want = {"flash_fwd": cfg.n_layers, "decode_attn": 0, "moe": 2 * n_moe, "plain_calls": 0}
    if prefill_counted != want:
        raise AssertionError(f"prefill window: {prefill_counted}, want {want}")
    prefill_logits = logits
    tok = logits.argmax(dim=-1, keepdim=True)
    tokens, step_logits = [tok], []
    reset()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(dim=-1, keepdim=True)
        step_logits.append(logits)
        tokens.append(tok)
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t0
    decode_counted = counts()
    want = {"flash_fwd": 0, "decode_attn": LM_DECODE * cfg.n_layers,
            "moe": LM_DECODE * 2 * n_moe, "plain_calls": 0}
    if decode_counted != want:
        raise AssertionError(f"decode window: {decode_counted}, want {want}")
    gen = torch.cat(tokens, dim=1)
    if int(cache["pos"].min()) != smax or not bool(torch.isfinite(torch.stack(step_logits)).all()):
        raise AssertionError(f"decode ended at pos {cache['pos'].tolist()} or non-finite logits")
    del cache
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    _log("lm_moe_serve", arch=cfg.name, describe=cfg.describe(), params=n_params,
         weight_gb=weight_bytes / 1e9, batch=LM_BATCH, prompt=LM_PROMPT, decode_steps=LM_DECODE,
         cache_slots=smax, init_s=init_s, prefill_s=prefill_s,
         prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_s, decode_ms_step=decode_s * 1e3 / LM_DECODE,
         decode_tok_s=LM_BATCH * LM_DECODE / decode_s, serving_max_memory_allocated_gb=peak_gb,
         memory_before_gb=mem_before / 1e9, prefill_counted=prefill_counted,
         decode_counted=decode_counted, first_tokens=gen[:, :8].tolist())

    failures = []
    # ---- the phase's row-12 inputs, and the experts each layer touches ---------
    seen = _moe_seen(kmoe, E, prefill, decode, params, prompts, gen[:, :1])
    touched = {label: torch.stack(v["touched"]).tolist() for label, v in seen.items()}

    # ---- check 1: row 12 against its plain version and float64 -----------------
    wts = (layer1.w_in, layer1.w_gate, layer1.w_out)
    gen_rng = torch.Generator(dev).manual_seed(seed + 29)
    row12 = {}

    def check(name, xc, offsets, bound):
        rows = int(offsets[-1])
        got = kmoe.moe_expert_mlp(xc, offsets, bound, *wts[:2], wts[2], "swiglu")
        torch.cuda.synchronize(dev)
        if not bool(torch.isfinite(got[:rows]).all()):
            raise AssertionError(f"row 12 {name}: non-finite rows")
        row12[name] = _yardstick(got[:rows], ref.moe_expert_mlp_ref(xc, offsets, bound, *wts,
                                                                     "swiglu")[:rows],
                                 _moe_mlp64(xc, offsets, *wts)[:rows])
        row12[name]["rows"] = rows

    for label in ("prefill", "decode_b8", "decode_b1"):
        check(label, *seen[label]["first"])
    for name, runs in LM_MOE_AWKWARD.items():
        c = torch.tensor(runs, dtype=torch.int64).t().reshape(-1)  # (expert, group) order
        offsets = torch.zeros(c.numel() + 1, dtype=torch.int32)
        offsets[1:] = torch.cumsum(c, 0)
        rows = int(offsets[-1])
        xc = torch.randn((rows + 3, d), generator=gen_rng, device=dev).to(torch.bfloat16)
        xc[rows:] = float("nan")  # past the runs: may be read, never stored
        check(name, xc, offsets.to(dev), int(c.max()))
    _log("lm_moe_serve_kernels", row12=row12, touched_experts=touched)

    # ---- check 2: forward against prefill and the first decode step ------------
    rows = LM_MOE_CHECK_ROWS
    free_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(E)))
    free = build_model(free_cfg, device=dev)
    fwd_tokens = torch.cat([prompts[:rows], gen[:rows, :1]], dim=1)
    r_pre, r_dec, r_fwd = [], [], []
    with _route_recorder(tffn, k, r_pre):
        lp, c2 = make_prefill_step(free, pad_cache_to=smax)(params, prompts[:rows], {})
    with _route_recorder(tffn, k, r_dec):
        ld, c2 = make_decode_step(free)(params, gen[:rows, :1], c2)
    del c2
    with torch.no_grad(), _route_recorder(tffn, k, r_fwd):
        fwd, fwd_aux = free.forward(params, fwd_tokens, {})
    scale = float(fwd.abs().max())
    S1 = LM_PROMPT + 1
    fwd_check = {"scale": scale, "aux_loss": float(fwd_aux["aux_loss"]), "rows": []}
    for b in range(rows):
        row = {}
        for what, got, routes, tok, pos in (("prefill", lp, r_pre, b * LM_PROMPT + LM_PROMPT - 1,
                                             LM_PROMPT - 1),
                                            ("decode", ld, r_dec, b, LM_PROMPT)):
            layer, gap, probs_rel = _routes_apart(r_fwd, routes, b * S1 + pos, tok)
            row[what] = {"rel": float((got[b] - fwd[b, pos]).abs().max()) / scale,
                         "apart_at_layer": layer, "gap": gap, "probs_rel_before": probs_rel}
        fwd_check["rows"].append(row)
    del fwd, lp, ld, r_pre, r_dec, r_fwd
    torch.cuda.empty_cache()
    for row in fwd_check["rows"]:
        for what, c in row.items():
            if c["apart_at_layer"] is None and c["rel"] >= LM_FWD_REL:
                failures.append(f"forward against {what}: {c} (scale {scale})")
            if c["apart_at_layer"] is not None and c["gap"] >= LM_MOE_TIE_GAP:
                failures.append(f"forward and {what} route apart off a near-tie: {c}")
            if c["probs_rel_before"] >= LM_FWD_REL:
                failures.append(f"forward and {what} router probabilities apart: {c}")

    # ---- check 3: kernel path against plain paths, teacher-forced --------------
    def teacher_forced(mdl, p, routes=None):
        """Logits of the prefill and the first ``LM_CHECK_STEPS`` steps fed
        the kernel path's tokens, ``[1 + LM_CHECK_STEPS, B, V]`` f32; each
        MoE layer's top-k into ``routes``."""
        stack = contextlib.ExitStack()
        if routes is not None:
            real_route = tffn.route

            def route(probs, moe_cfg, capacity):
                r = real_route(probs, moe_cfg, capacity)
                routes.append(r.topi.reshape(-1, moe_cfg.top_k).sort(-1).values)
                return r
            stack.enter_context(mock.patch.object(tffn, "route", route))
        with stack:
            lg, c = make_prefill_step(mdl, pad_cache_to=smax)(p, prompts, {})
            out = [lg]
            step = make_decode_step(mdl)
            for i in range(LM_CHECK_STEPS):
                lg, c = step(p, gen[:, i:i + 1], c)
                out.append(lg)
        return torch.stack(out)

    def rel(a, b):
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).tolist()

    def route_differs(a, b):
        """Share of tokens whose top-k set differs, per MoE layer (the
        prefill's tokens and each step's, over the layers in order)."""
        share = []
        for layer in range(n_moe):
            ra = torch.cat(a[layer::n_moe])
            rb = torch.cat(b[layer::n_moe])
            share.append(float((ra != rb).any(-1).float().mean()))
        return share

    r_kernel, r_plain = [], []
    kernel_path = teacher_forced(model, params, r_kernel)
    reset()
    t0 = time.perf_counter()
    with plain_kernels():
        plain_path = teacher_forced(model, params, r_plain)
        torch.cuda.synchronize(dev)
        plain_path_s = time.perf_counter() - t0
        plain_counted = counts()
        plain_other = teacher_forced(
            build_model(dataclasses.replace(cfg, q_block=256, kv_block=256), device=dev), params)
    forced_vs_counted = max(rel(kernel_path, torch.cat(
        [prefill_logits[None], torch.stack(step_logits[:LM_CHECK_STEPS])])))
    kp, pp = rel(kernel_path, plain_path), rel(plain_other, plain_path)
    differs = route_differs(r_kernel, r_plain)
    del kernel_path, plain_path, plain_other, r_kernel, r_plain
    torch.cuda.empty_cache()

    # the float32 leg at the first LM_MOE_F32_LAYERS layers: kernel and plain
    # paths over the same bf16 weights, the plain path over their exact f32 copy
    cut_cfg = dataclasses.replace(cfg, n_layers=LM_MOE_F32_LAYERS)
    cut_model = build_model(cut_cfg, device=dev)
    cut = Decoder(params.embed, params.final_norm,
                  [{"p0": list(params.groups[0]["p0"])},
                   {"p0": list(params.groups[1]["p0"][:LM_MOE_F32_LAYERS - 1])}], params.unembed)
    cut_kernel = teacher_forced(cut_model, cut)
    compute = Policy.compute_dtype
    with plain_kernels():
        cut_plain = teacher_forced(cut_model, cut)
        cut32 = copy.deepcopy(cut).float()
        try:
            Policy.compute_dtype = torch.float32
            cut_f32 = teacher_forced(cut_model, cut32)
        finally:
            Policy.compute_dtype = compute
    del cut32
    k32, p32 = rel(cut_kernel, cut_f32), rel(cut_plain, cut_f32)
    kp_cut = rel(cut_kernel, cut_plain)
    del cut_kernel, cut_plain, cut_f32, cut
    torch.cuda.empty_cache()
    e2e = {"kernel_vs_plain_max": max(kp), "kernel_vs_plain_prefill": kp[0],
           "plain_blocks_vs_plain_max": max(pp), "teacher_forced_vs_counted": forced_vs_counted,
           "f32_layers": LM_MOE_F32_LAYERS, "cut_kernel_vs_plain_max": max(kp_cut),
           "cut_kernel_vs_f32_max": max(k32), "cut_plain_vs_f32_max": max(p32),
           "routing_differs_share_by_layer": differs,
           "per_step": {"kernel_vs_plain": kp, "plain_blocks_vs_plain": pp,
                        "cut_kernel_vs_f32": k32, "cut_plain_vs_f32": p32},
           "plain_path_s": plain_path_s, "plain_counted": plain_counted}
    _log("lm_moe_serve_checks", forward=fwd_check, e2e=e2e)
    if plain_counted["flash_fwd"] or plain_counted["decode_attn"] or plain_counted["moe"]:
        raise AssertionError(f"the plain path launched a kernel: {plain_counted}")
    if max(kp) > LM_E2E_FACTOR * max(pp):
        failures.append(f"kernel path against plain path {max(kp)} > {LM_E2E_FACTOR} x the "
                        f"plain paths' spread {max(pp)}")
    if max(k32) > LM_E2E_FACTOR * max(p32):
        failures.append(f"kernel path against float32 at {LM_MOE_F32_LAYERS} layers {max(k32)} "
                        f"> {LM_E2E_FACTOR} x the plain path's {max(p32)}")

    # ---- row 12's times at the phase's shapes ----------------------------------
    times = _row12_times(dev, cfg, layer1, seen)
    _log("lm_moe_serve_times", row12=times)

    # ---- decode at B = 1, and profiled windows by kind -------------------------
    _, c1 = prefill(params, prompts[:1], {})
    tok1 = gen[:1, :1]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(LM_B1_STEPS):
        l1, c1 = decode(params, tok1, c1)
        tok1 = l1.argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize(dev)
    b1_ms = (time.perf_counter() - t0) * 1e3 / LM_B1_STEPS
    _, c8 = prefill(params, prompts, {})
    profiles = {}
    windows = {"b1": (lambda c: decode(params, tok1, c)[1], c1, LM_PROFILE_STEPS, b1_ms),
               "b8": (lambda c: decode(params, gen[:, :1], c)[1], c8, LM_PROFILE_STEPS,
                      decode_s * 1e3 / LM_DECODE),
               "prefill": (lambda c: prefill(params, prompts, {})[1], None, 1, prefill_s * 1e3)}
    for name, (step, c, n_steps, wall_ms) in windows.items():
        for _ in range(2):  # the first profiled window pays the profiler's start
            torch.cuda.synchronize(dev)
            prof = _start_profiler(profiles)
            if prof is None:
                break
            for _ in range(n_steps):
                c = step(c)
            torch.cuda.synchronize(dev)
            prof.stop()
        if prof is None:
            break
        kinds = {k2: v2 / n_steps for k2, v2 in _kernel_device_ms(prof).items()}
        busy = sum(kinds.values())
        profiles[name] = {"device_ms": kinds, "device_busy_ms": busy, "unprofiled_ms": wall_ms,
                          "idle_share": 1 - busy / wall_ms if busy else None,
                          "top_kernels_ms_window": _device_kernels_ms(prof, 10)}
    del c1, c8
    _log("lm_moe_serve_decode", b1_ms_step=b1_ms, b1_tok_s=1e3 / b1_ms,
         b8_ms_step=decode_s * 1e3 / LM_DECODE, b8_tok_s=LM_BATCH * LM_DECODE / decode_s,
         profiled_steps=LM_PROFILE_STEPS, profiles=profiles,
         phase_max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         phase_s=time.perf_counter() - t_phase)
    del params, layer1, wts, seen, model
    torch.cuda.empty_cache()

    if failures:
        raise AssertionError("; ".join(failures))
    pf = times["prefill"]
    rec = {"name": "moe_expert_mlp", "route": "cuda", "source": "src/repro_torch/csrc/moe.cu",
           "replaces": "src/repro/models/ffn.py:131 (jnp _expert_mlp in moe_ffn, "
                       "not a Pallas site)",
           "launches": prefill_counted["moe"] + decode_counted["moe"],
           "max_abs_err": row12["prefill"]["kernel_vs_plain"], "ms": pf["ms"],
           "plain_ms": pf["plain_ms"], "bound_ms": pf["bound_ms"], "bound_by": pf["bound_by"],
           "library_ms": pf["library_ms"],
           "shape": {"rows": pf["rows"], "d": d, "f": f, "E": E}}
    launches = {"flash_fwd": prefill_counted["flash_fwd"],
                "decode_attn": decode_counted["decode_attn"]}
    return [rec], launches


def _lm_moe_row12(dev, seed: int) -> dict:
    """Row 12 alone at ``lm_moe_serve``'s three shapes (``--row12-times``):
    deepseek-moe-16b built and initialised as that phase does, one prefill
    of its prompts, then the first MoE layer's inputs captured by
    :func:`_moe_seen` and timed by :func:`_row12_times`.  Run once from
    each of two checkouts in one call, it compares two trees' row 12 on
    one card."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models.common import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.steps.train import make_decode_step, make_prefill_step

    cfg = get_config(LM_MOE_ARCH)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed), dtype=Policy.compute_dtype)
    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT, global_batch=LM_BATCH, seed=seed))
    prompts = torch.from_numpy(pipe.batch_at(0)["tokens"]).long().to(dev)
    prefill = make_prefill_step(model, pad_cache_to=LM_PROMPT + LM_DECODE)
    decode = make_decode_step(model)
    logits, _ = prefill(params, prompts, {})
    tok = logits.argmax(dim=-1, keepdim=True)
    del logits
    seen = _moe_seen(kmoe, cfg.moe.n_experts, prefill, decode, params, prompts, tok)
    return _row12_times(dev, cfg, params.groups[1]["p0"][0].moe, seen)


# ---- the hybrid family's serving path (lm_hybrid_serve) -----------------------

LM_HYBRID_ARCH = "recurrentgemma_9b"
# twice the window of 2,048: the window bites, and S % window == 0 keeps
# decode's ring slot (pos % window) in the prefill's time order, as JAX's
LM_HYBRID_PROMPT = 4096
# check 2's prompts (f32 logits of 2 x 4,097 x 256,000: 8.4 GB)
LM_HYBRID_CHECK_ROWS = 2
# row 13 beside the phase's own shape: (B, S, K, G, D, window); recurrentgemma's
# heads at the real window with S % window != 0, S < window and one token,
# and late rows whose window misses the block's first key tile (G = 1)
LM_LOCAL_SHAPES = ((2, 2100, 1, 16, 256, 2048), (1, 1500, 1, 16, 256, 2048),
                   (2, 1, 1, 16, 256, 2048), (1, 300, 1, 16, 256, 64), (1, 300, 1, 1, 256, 50),
                   (1, 257, 2, 7, 128, 64))
# row 14 beside the phase's: (B, S, w, h float32, with an initial state):
# w past a block's 64 channels, S past the 16-step unroll
LM_SCAN_SHAPES = ((2, 37, 130, True, True), (1, 4100, 4096, False, False),
                  (3, 9, 4096, False, True))


def _hybrid_params(cfg) -> int:
    """recurrentgemma's parameters as the JAX package's tree holds them
    (the gates block-diagonal, ``[nb, w/nb, w/nb]`` each; ``ArchConfig.
    param_count`` counts them as ``w x w``)."""
    d, w, nb = cfg.d_model, cfg.hybrid.lru_width or cfg.d_model, max(1, cfg.n_heads)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ffn = 3 * d * cfg.d_ff  # geglu: w_in, w_gate, w_out
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    # w_gate_in, w_x_in; conv_w, conv_b; w_a, w_i; lambda; w_out
    rglru = 2 * d * w + 5 * w + 2 * nb * (w // nb) ** 2 + w + w * d
    n = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d
    for g in cfg.layer_groups():
        for spec in g.specs:
            n += g.repeat * (2 * d + ffn + (rglru if spec.mixer == "rglru" else attn))
    return n


def _local64(q, k, v, window: int):
    """Float64 sliding-window attention (key ``j`` seen by query ``i`` iff
    ``i - window < j <= i``), one row at a time: row 13's yardstick (shares
    no code with the port)."""
    import torch

    B, S, K, G, D = q.shape
    i = torch.arange(S, device=q.device)
    delta = i[:, None] - i[None, :]
    mask = (delta >= 0) & (delta < window)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        s = torch.einsum("qkgd,skd->kgqs", q[b].double(), k[b].double()) * D ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        del s
        out[b] = torch.einsum("kgqs,skd->qkgd", p, v[b].double())
    return out


def _rglru64(r, i, h, lam, init):
    """Float64 RG-LRU recurrence walked in order: row 14's yardstick."""
    import torch

    log_a0 = torch.nn.functional.logsigmoid(lam.double())
    y = torch.empty(r.shape, dtype=torch.float64, device=r.device)
    acc = (torch.zeros(r.shape[0], r.shape[2], dtype=torch.float64, device=r.device)
           if init is None else init.double())
    for t in range(r.shape[1]):
        at = torch.exp(8.0 * r[:, t].double() * log_a0)
        x = torch.sqrt(torch.clamp(1.0 - at * at, min=1e-12)) * i[:, t].double() * h[:, t].double()
        acc = at * acc + x
        y[:, t] = acc
    return y


def _local_bound(B, S, K, G, D, window) -> tuple[float, str]:
    """Row 13's least time: ``4 B H D sum_i min(i + 1, w)`` FLOPs over the
    bf16 tensor-core rate, or q, k, v and out once over the HBM rate."""
    w = min(window, S)
    keys = w * (w + 1) // 2 + (S - w) * w
    t_ops = 4 * B * K * G * D * keys / PEAK_BF16_TC_S
    t_bytes = 2 * (2 * B * S * K * G * D + 2 * B * S * K * D) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _scan_bound(B, S, w) -> tuple[float, str]:
    """Row 14's least time: r, i (f32) and h (bf16) read and y (f32)
    written once, 14 bytes an element, plus Λ, the state in and out."""
    return (14 * B * S * w + 4 * w + 8 * B * w) / PEAK_BYTES_S * 1e3, "bytes"


def _row14_check(got, plain, want64) -> dict:
    """:func:`_yardstick` for row 14, and the float32-level rule beside it:
    each output row (b, t) within 2^-16 of its max |y| of the plain
    version, which rounds ``a_t`` and every term as the kernel does and
    sums the recurrence in another order.  (Both lie further from float64:
    ``a_t`` rounded to float32 is carried through up to 1 / (1 - a_t)
    steps.)"""
    out = _yardstick(got, plain, want64)
    rows = (got - plain).abs().amax(-1) / plain.abs().amax(-1).clamp_min(1e-30)
    out["row_rel_vs_plain_max"] = float(rows.max())
    if out["row_rel_vs_plain_max"] >= 2.0 ** -16:
        raise AssertionError(f"row 14 past 2^-16 of a row's scale from plain: {out}")
    return out


def _lm_hybrid_serve(dev, seed: int) -> tuple[list, dict]:
    """recurrentgemma-9b at the published widths and full depth (38
    layers: 26 RG-LRU and 12 local-attention, window 2,048, 16 query heads
    over one KV head of 256, GeGLU FFNs of 12,288, vocab 256,000 tied) on
    the card through ``build_model`` / ``make_prefill_step`` /
    ``make_decode_step``: 8 prompts of 4,096 tokens from the token pipeline,
    prefill without ``pad_cache_to`` (a local layer keeps its window), 64
    greedy decode steps at B = 8, then 16 at B = 1.  Checks: rows 13, 14
    and 8 against their plain versions and float64 at the phase's inputs
    (the first layer of each kind, captured by patching the wrappers; row
    8 also at ragged positions over the captured ring) and awkward ones; the forward against prefill and the first decode step
    on ``LM_HYBRID_CHECK_ROWS`` prompts (0.05 of max |logits|); the kernel
    path against the plain path teacher-forced, within
    ``LM_E2E_FACTOR`` times the spread of two plain paths (the second with
    the recurrence in two halves, the first's state carried: another order
    of the f32 sums) and of the plain path's distance to a float32 path;
    12 row-13 and 26 row-14 launches a prefill, 12 row-8 and 26 row-14 a
    decode step, no plain call.  Returns rows 13 and 14's records and the
    phase's launches of row 8."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru as krglru
    from repro_torch.models.common import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.steps.train import make_decode_step, make_prefill_step

    def halves_scan(r, i, h, lam, init_state=None):
        """The plain recurrence over each half of S, the first's state
        carried into the second: the same function, other f32 roundings."""
        m = r.shape[1] // 2
        if m == 0:
            return ref.rglru_scan_ref(r, i, h, lam, init_state)
        y1, s1 = ref.rglru_scan_ref(r[:, :m], i[:, :m], h[:, :m], lam, init_state)
        y2, s2 = ref.rglru_scan_ref(r[:, m:], i[:, m:], h[:, m:], lam, s1)
        return torch.cat([y1, y2], dim=1), s2

    def plain_kernels(halves: bool = False):
        """The plain versions of rows 13, 8 and 14 in place of their wrappers."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            kattn, "local_attention",
            lambda q, k, v, *, window: ref.local_attention_ref(q, k, v, window)))
        stack.enter_context(mock.patch.object(kattn, "decode_attention", ref.decode_attention_ref))
        stack.enter_context(mock.patch.object(
            krglru, "rglru_scan", halves_scan if halves else ref.rglru_scan_ref))
        return stack

    def counts():
        return {"local_attn": kattn.local_launches, "rglru": krglru.launches,
                "decode_attn": kattn.decode_launches, "flash_fwd": kattn.flash_launches,
                "plain_calls": ref.calls}

    def reset():
        kattn.local_launches = kattn.decode_launches = kattn.flash_launches = 0
        krglru.launches = ref.calls = 0

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros((), device=dev)
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(LM_HYBRID_ARCH)
    window, w = cfg.hybrid.window, cfg.hybrid.lru_width
    n_local = sum(g.repeat * sum(s.mixer == "local" for s in g.specs) for g in cfg.layer_groups())
    n_rglru = cfg.n_layers - n_local
    B, S = LM_BATCH, LM_HYBRID_PROMPT
    K, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed), dtype=Policy.compute_dtype)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != _hybrid_params(cfg):
        raise AssertionError(f"{n_params} parameters, JAX's tree holds {_hybrid_params(cfg)}")
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())

    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed))
    prompts = torch.from_numpy(pipe.batch_at(0)["tokens"]).long().to(dev)
    prefill = make_prefill_step(model)  # no padding: a local layer keeps its window
    decode = make_decode_step(model)

    _, wc = prefill(params, prompts[:1, :64], {})
    decode(params, prompts[:1, 64:65], wc)
    del wc
    torch.cuda.synchronize(dev)

    # ---- counted prefill and 64 greedy decode steps ----------------------------
    reset()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, {})
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    prefill_counted = counts()
    want = {"local_attn": n_local, "rglru": n_rglru, "decode_attn": 0, "flash_fwd": 0,
            "plain_calls": 0}
    if prefill_counted != want:
        raise AssertionError(f"prefill window: {prefill_counted}, want {want}")
    rings = [e["k"].shape[2] for g in cache["groups"] for e in g.values() if "k" in e]
    if sorted(set(rings)) != [window]:
        raise AssertionError(f"local caches of {rings} slots, want {window}")
    prefill_logits = logits
    tok = logits.argmax(dim=-1, keepdim=True)
    tokens, step_logits = [tok], []
    reset()
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(dim=-1, keepdim=True)
        step_logits.append(logits)
        tokens.append(tok)
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t0
    decode_counted = counts()
    want = {"local_attn": 0, "rglru": LM_DECODE * n_rglru, "decode_attn": LM_DECODE * n_local,
            "flash_fwd": 0, "plain_calls": 0}
    if decode_counted != want:
        raise AssertionError(f"decode window: {decode_counted}, want {want}")
    gen = torch.cat(tokens, dim=1)
    if (int(cache["pos"].min()) != S + LM_DECODE
            or not bool(torch.isfinite(torch.stack(step_logits)).all())
            or not bool(torch.isfinite(prefill_logits).all())):
        raise AssertionError(f"decode ended at pos {cache['pos'].tolist()} or non-finite logits")
    del cache
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    _log("lm_hybrid_serve", arch=cfg.name, describe=cfg.describe(), params=n_params,
         param_count_claimed=cfg.param_count(), weight_gb=weight_bytes / 1e9,
         layers={"rglru": n_rglru, "local": n_local}, window=window, batch=B, prompt=S,
         decode_steps=LM_DECODE, init_s=init_s, prefill_s=prefill_s,
         prefill_tok_s=B * S / prefill_s, decode_ms_step=decode_s * 1e3 / LM_DECODE,
         decode_tok_s=B * LM_DECODE / decode_s, serving_max_memory_allocated_gb=peak_gb,
         memory_before_gb=mem_before / 1e9, prefill_counted=prefill_counted,
         decode_counted=decode_counted, first_tokens=gen[:, :8].tolist())

    failures = []
    # ---- the phase's row-13 and row-14 inputs: the first layer of each kind ----
    seen: dict = {}
    real_local, real_scan = kattn.local_attention, krglru.rglru_scan
    real_decode = kattn.decode_attention

    def rec_local(q, k, v, *, window):
        if "local" not in seen:
            seen["local"] = (q.clone(), k.clone(), v.clone(), window)
        return real_local(q, k, v, window=window)

    def rec_scan(label):
        def call(r, i, h, lam, init_state=None):
            if label not in seen:
                seen[label] = tuple(None if t is None else t.clone()
                                    for t in (r, i, h, lam, init_state))
            return real_scan(r, i, h, lam, init_state)
        return call

    with mock.patch.object(kattn, "local_attention", rec_local), \
            mock.patch.object(krglru, "rglru_scan", rec_scan("prefill")):
        _, c8 = prefill(params, prompts, {})
    def rec_decode(q, k_cache, v_cache, pos):
        if "decode_attn" not in seen:  # the first local layer: D 256, G 16, K 1
            seen["decode_attn"] = tuple(t.clone() for t in (q, k_cache, v_cache, pos))
        return real_decode(q, k_cache, v_cache, pos)

    with mock.patch.object(krglru, "rglru_scan", rec_scan("decode_b8")), \
            mock.patch.object(kattn, "decode_attention", rec_decode):
        decode(params, gen[:, :1], c8)
    del c8
    torch.cuda.synchronize(dev)

    # ---- check 1: rows 13 and 14 against their plain versions and float64 ------
    gen_rng = torch.Generator(dev).manual_seed(seed + 31)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen_rng, device=dev).to(dtype)

    row13 = {}
    q, k, v, win = seen["local"]
    row13["phase"] = _yardstick(kattn.local_attention(q, k, v, window=win),
                                ref.local_attention_ref(q, k, v, win), _local64(q, k, v, win))
    for Bx, Sx, Kx, Gx, Dx, wx in LM_LOCAL_SHAPES:
        qa, ka, va = randn(Bx, Sx, Kx, Gx, Dx), randn(Bx, Sx, Kx, Dx), randn(Bx, Sx, Kx, Dx)
        row13[f"{Bx}x{Sx}x{Kx}x{Gx}x{Dx}_w{wx}"] = _yardstick(
            kattn.local_attention(qa, ka, va, window=wx), ref.local_attention_ref(qa, ka, va, wx),
            _local64(qa, ka, va, wx))
    torch.cuda.empty_cache()
    row14 = {}
    for label in ("prefill", "decode_b8"):
        args = seen[label]
        row14[label] = _row14_check(krglru.rglru_scan(*args)[0], ref.rglru_scan_ref(*args)[0],
                                    _rglru64(*args))
    for Bx, Sx, wx, h32, with_init in LM_SCAN_SHAPES:
        args = (torch.rand((Bx, Sx, wx), generator=gen_rng, device=dev),
                torch.rand((Bx, Sx, wx), generator=gen_rng, device=dev),
                randn(Bx, Sx, wx, dtype=torch.float32 if h32 else torch.bfloat16),
                2.2 + 4.7 * torch.rand((wx,), generator=gen_rng, device=dev),
                randn(Bx, wx, dtype=torch.float32) if with_init else None)
        y, state = krglru.rglru_scan(*args)
        if not torch.equal(state, y[:, -1]):
            raise AssertionError("row 14's state is not its last output")
        row14[f"{Bx}x{Sx}x{wx}_h{'f32' if h32 else 'bf16'}"] = _row14_check(
            y, ref.rglru_scan_ref(*args)[0], _rglru64(*args))
    row8 = {}
    qd, kc, vc, last = seen["decode_attn"]
    T = kc.shape[1]
    pos_sets = {"phase": last,  # the ring's last slot, min(pos, T - 1)
                "ragged": torch.tensor([i * (T - 1) // (B - 1) for i in range(B)],
                                       dtype=torch.int32, device=dev)}
    for name, pos in pos_sets.items():
        row8[name] = _yardstick(kattn.decode_attention(qd, kc, vc, pos),
                                ref.decode_attention_ref(qd, kc, vc, pos),
                                _decode64(qd, kc, vc, pos))
    row8["b1_last"] = _yardstick(kattn.decode_attention(qd[:1], kc[:1], vc[:1], last[:1]),
                                 ref.decode_attention_ref(qd[:1], kc[:1], vc[:1], last[:1]),
                                 _decode64(qd[:1], kc[:1], vc[:1], last[:1]))
    row8["shape"] = list(qd.shape) + [T]
    row8["phase_pos"] = sorted(set(last.tolist()))
    _log("lm_hybrid_serve_kernels", row13=row13, row14=row14, row8=row8)
    torch.cuda.empty_cache()

    # ---- check 2: forward against prefill and the first decode step ------------
    rows = LM_HYBRID_CHECK_ROWS
    fwd_tokens = torch.cat([prompts[:rows], gen[:rows, :1]], dim=1)
    lp, c2 = prefill(params, prompts[:rows], {})
    ld, c2 = decode(params, gen[:rows, :1], c2)
    del c2
    with torch.no_grad():
        fwd, _ = model.forward(params, fwd_tokens, {})
    scale = float(fwd.abs().max())
    fwd_check = {"scale": scale,
                 "prefill_rel": float((lp - fwd[:, S - 1]).abs().max()) / scale,
                 "decode_rel": float((ld - fwd[:, S]).abs().max()) / scale}
    del fwd, lp, ld
    torch.cuda.empty_cache()
    for what in ("prefill_rel", "decode_rel"):
        if fwd_check[what] >= LM_FWD_REL:
            failures.append(f"forward against {what}: {fwd_check}")

    # ---- check 3: kernel path against plain paths, teacher-forced --------------
    def teacher_forced():
        """Logits of the prefill and the first ``LM_CHECK_STEPS`` steps fed
        the kernel path's tokens, ``[1 + LM_CHECK_STEPS, B, V]`` f32."""
        lg, c = prefill(params, prompts, {})
        out = [lg]
        for i in range(LM_CHECK_STEPS):
            lg, c = decode(params, gen[:, i:i + 1], c)
            out.append(lg)
        return torch.stack(out)

    def rel(a, b):
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).tolist()

    def argmax_share(a, b):
        return float((a.argmax(-1) != b.argmax(-1)).float().mean())

    kernel_path = torch.cat([prefill_logits[None], torch.stack(step_logits[:LM_CHECK_STEPS])])
    reset()
    t0 = time.perf_counter()
    with plain_kernels():
        plain_path = teacher_forced()
        torch.cuda.synchronize(dev)
        plain_path_s = time.perf_counter() - t0
        plain_counted = counts()
    with plain_kernels(halves=True):
        plain_other = teacher_forced()
    compute = Policy.compute_dtype
    with plain_kernels():
        try:
            params.float()
            Policy.compute_dtype = torch.float32
            f32_path = teacher_forced()
        finally:
            Policy.compute_dtype = compute
            params.to(torch.bfloat16)  # exact: the values came from bf16
    torch.cuda.empty_cache()
    kp, pp = rel(kernel_path, plain_path), rel(plain_other, plain_path)
    k32, p32 = rel(kernel_path, f32_path), rel(plain_path, f32_path)
    e2e = {"kernel_vs_plain_max": max(kp), "kernel_vs_plain_prefill": kp[0],
           "plain_halves_vs_plain_max": max(pp), "kernel_vs_f32_max": max(k32),
           "plain_vs_f32_max": max(p32),
           "argmax_differs_share": {"kernel_vs_plain": argmax_share(kernel_path, plain_path),
                                    "plain_halves_vs_plain": argmax_share(plain_other, plain_path),
                                    "kernel_vs_f32": argmax_share(kernel_path, f32_path),
                                    "plain_vs_f32": argmax_share(plain_path, f32_path)},
           "per_step": {"kernel_vs_plain": kp, "plain_halves_vs_plain": pp,
                        "kernel_vs_f32": k32, "plain_vs_f32": p32},
           "plain_path_s": plain_path_s, "plain_counted": plain_counted}
    del kernel_path, plain_path, plain_other, f32_path
    _log("lm_hybrid_serve_checks", forward=fwd_check, e2e=e2e)
    if plain_counted["local_attn"] or plain_counted["decode_attn"] or plain_counted["rglru"]:
        raise AssertionError(f"the plain path launched a kernel: {plain_counted}")
    if max(kp) > LM_E2E_FACTOR * max(pp):
        failures.append(f"kernel path against plain path {max(kp)} > {LM_E2E_FACTOR} x the "
                        f"plain paths' spread {max(pp)}")
    if max(k32) > LM_E2E_FACTOR * max(p32):
        failures.append(f"kernel path against float32 {max(k32)} > {LM_E2E_FACTOR} x the "
                        f"plain path's {max(p32)}")

    # ---- rows 13 and 14 timed at the phase's shapes ----------------------------
    local_ms = _sync_ms(lambda: kattn.local_attention(q, k, v, window=win), 10, dev)
    local_dev_ms = _graph_ms(lambda: kattn.local_attention(q, k, v, window=win), 10, dev)
    local_plain_ms = _sync_ms(lambda: ref.local_attention_ref(q, k, v, win), 2, dev)
    local_lib = {"ms": None}
    try:  # SDPA with a boolean band mask, [B, H, S, D] views of the same tensors
        qs_, ks_, vs_ = (t.transpose(1, 2) for t in (q.reshape(B, S, K * G, D), k, v))
        pos_ = torch.arange(S, device=dev)
        band = (pos_[:, None] >= pos_[None, :]) & (pos_[:, None] - pos_[None, :] < win)
        local_lib["ms"] = _sync_ms(lambda: F.scaled_dot_product_attention(
            qs_, ks_, vs_, attn_mask=band, enable_gqa=True), 3, dev)
        del qs_, ks_, vs_, band
    except Exception as exc:  # no backend takes it: logged, library_ms null
        local_lib["error"] = repr(exc)[:300]
    torch.cuda.empty_cache()
    scan_times = {}
    for label, reps in (("prefill", 10), ("decode_b8", 50)):
        args = seen[label]
        b_ms, b_by = _scan_bound(*args[0].shape)
        scan_times[label] = {
            "ms": _sync_ms(lambda: krglru.rglru_scan(*args), reps, dev),
            "device_ms": _graph_ms(lambda: krglru.rglru_scan(*args), reps, dev),
            "plain_ms": _sync_ms(lambda: ref.rglru_scan_ref(*args), 2, dev),
            "bound_ms": b_ms, "bound_by": b_by, "shape": list(args[0].shape)}
    local_bound, local_by = _local_bound(B, S, K, G, D, win)
    _log("lm_hybrid_serve_times",
         row13={"ms": local_ms, "device_ms": local_dev_ms, "plain_ms": local_plain_ms,
                "sdpa_band_mask": local_lib, "bound_ms": local_bound, "bound_by": local_by,
                "shape": [B, S, K, G, D, win]},
         row14=scan_times)

    # ---- decode at B = 1, and profiled windows by kind -------------------------
    _, c1 = prefill(params, prompts[:1], {})
    tok1 = gen[:1, :1]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(LM_B1_STEPS):
        l1, c1 = decode(params, tok1, c1)
        tok1 = l1.argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize(dev)
    b1_ms = (time.perf_counter() - t0) * 1e3 / LM_B1_STEPS
    _, c8 = prefill(params, prompts, {})
    profiles = {}
    windows = {"b1": (lambda c: decode(params, tok1, c)[1], c1, LM_PROFILE_STEPS, b1_ms),
               "b8": (lambda c: decode(params, gen[:, :1], c)[1], c8, LM_PROFILE_STEPS,
                      decode_s * 1e3 / LM_DECODE),
               "prefill": (lambda c: prefill(params, prompts, {})[1], None, 1, prefill_s * 1e3)}
    for name, (step, c, n_steps, wall_ms) in windows.items():
        for _ in range(2):  # the first profiled window pays the profiler's start
            torch.cuda.synchronize(dev)
            prof = _start_profiler(profiles)
            if prof is None:
                break
            for _ in range(n_steps):
                c = step(c)
            torch.cuda.synchronize(dev)
            prof.stop()
        if prof is None:
            break
        kinds = {k2: v2 / n_steps for k2, v2 in _kernel_device_ms(prof).items()}
        # this model has no global attention: flash_fwd's kernel is row 13 here
        kinds["local_attn"] = kinds.pop("flash_fwd")
        busy = sum(kinds.values())
        profiles[name] = {"device_ms": kinds, "device_busy_ms": busy, "unprofiled_ms": wall_ms,
                          "idle_share": 1 - busy / wall_ms if busy else None,
                          "top_kernels_ms_window": _device_kernels_ms(prof, 10)}
    del c1, c8
    _log("lm_hybrid_serve_decode", b1_ms_step=b1_ms, b1_tok_s=1e3 / b1_ms,
         b8_ms_step=decode_s * 1e3 / LM_DECODE, b8_tok_s=B * LM_DECODE / decode_s,
         profiled_steps=LM_PROFILE_STEPS, profiles=profiles,
         phase_max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         phase_s=time.perf_counter() - t_phase)
    del params, model, seen, q, k, v
    torch.cuda.empty_cache()

    if failures:
        raise AssertionError("; ".join(failures))
    pf = scan_times["prefill"]
    records = [
        {"name": "local_attention", "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
         "replaces": "src/repro/models/attention.py:301 (jnp local_attention, not a Pallas site)",
         "launches": prefill_counted["local_attn"] + decode_counted["local_attn"],
         "max_abs_err": row13["phase"]["kernel_vs_plain"], "ms": local_ms,
         "plain_ms": local_plain_ms, "bound_ms": local_bound, "bound_by": local_by,
         "library_ms": local_lib["ms"], "shape": {"B": B, "S": S, "K": K, "G": G, "D": D,
                                                  "window": win}},
        {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru.cu",
         "replaces": "src/repro/models/rglru.py:84 (_rglru_scan: jnp terms and "
                     "lax.associative_scan, not a Pallas site)",
         "launches": prefill_counted["rglru"] + decode_counted["rglru"],
         "max_abs_err": row14["prefill"]["kernel_vs_plain"], "ms": pf["ms"],
         "plain_ms": pf["plain_ms"], "bound_ms": pf["bound_ms"], "bound_by": pf["bound_by"],
         "library_ms": None, "shape": {"B": B, "S": S, "w": w}},
    ]
    return records, {"decode_attn": decode_counted["decode_attn"]}


# ---- the LM substrate's training step (lm_train) -----------------------------

LM_TRAIN_ARCH = "starcoder2_3b"
LM_TRAIN_BATCH = 8
LM_TRAIN_SEQ = 2048
LM_TRAIN_MICRO = 2
LM_TRAIN_STEPS = 4  # the first is the warm-up: the kernels' and cuBLAS's first calls
# Rows 10 and 11 (csrc/adamw.cu) per element: row 10 reads p, g, m, v and
# writes p, m, v (float32); the law is 17 float operations (a division or
# square root counted as one).  Row 11's bytes are counted per leaf from its
# int8 blocks and scales (_adamw8bit_bytes); dequantizing and requantizing
# add 13 operations.
ADAMW_BYTES = 28
ADAMW_OPS = 17
ADAMW8_OPS = 30
# lm_train_kernels, (B, S, Skv, K, G, D, causal): a microbatch of the phase,
# the other wgmma head dim, a head dim of the mma.sync forward, and Skv != S
# without the causal mask
LM_TRAIN_SHAPES = ((4, 2048, 2048, 2, 12, 128, True), (2, 1000, 1000, 4, 7, 64, True),
                   (2, 1000, 1000, 4, 7, 80, True), (2, 300, 700, 4, 7, 128, False))
# lm_train_checks: one step at the published widths and 2 layers
LM_CHECK_LAYERS = 2
LM_CHECK_BATCH = 2
LM_CHECK_SEQ = 512
# lse against float64, per row: the kernel's error at most twice the plain
# version's plus 2^-17 of max(|lse|, 1) (64 f32 ulps: sums of ex2.approx terms)
LSE_ABS = 2.0 ** -17
# Row 9's rows against float64 also get 2^-18 of the tensor's largest value
# (32 f32 ulps there): a query that sees one key has an exact zero dq, as
# dS = P (dP - delta) cancels, and f32 sums of dP and delta in another order
# than the plain version's leave a few ulps of dP (1.7e-6 on the H100)
BWD_FLOOR = 2.0 ** -18


def _attention64_grads(q, k, v, do, causal: bool):
    """Float64 exact softmax attention, one row b at a time: its output,
    log-sum-exp ``[B, K, G, S]`` and the gradients of ``q``, ``k``, ``v``
    for the output's gradient ``do`` by autograd; the yardstick of row 9 and
    of row 7's ``lse`` (shares no code with the port)."""
    import torch

    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    f64 = dict(dtype=torch.float64, device=q.device)
    out, dq = torch.empty(q.shape, **f64), torch.empty(q.shape, **f64)
    dk, dv = torch.empty(k.shape, **f64), torch.empty(k.shape, **f64)
    lse = torch.empty((B, K, G, S), **f64)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
    for b in range(B):
        qb, kb, vb = (t[b].double().requires_grad_(True) for t in (q, k, v))
        s = (torch.einsum("qkgd,skd->kgqs", qb, kb) * D ** -0.5).masked_fill(~mask, float("-inf"))
        lse[b] = torch.logsumexp(s.detach(), dim=-1)
        o = torch.einsum("kgqs,skd->qkgd", torch.softmax(s, dim=-1), vb)
        out[b] = o.detach()
        dq[b], dk[b], dv[b] = torch.autograd.grad(o, (qb, kb, vb), do[b].double())
        del s, o
    return out, lse, dq, dk, dv


def _lse_check(kernel, plain, want64) -> dict:
    """Each row's log-sum-exp: the kernel's error against float64 at most
    twice the plain version's plus ``LSE_ABS`` of max(|lse|, 1)."""
    err_k = (kernel.double() - want64).abs()
    err_p = (plain.double() - want64).abs()
    excess = err_k - (2 * err_p + LSE_ABS * want64.abs().clamp_min(1.0))
    out = {"err_kernel": float(err_k.max()), "err_plain": float(err_p.max()),
           "kernel_vs_plain": float((kernel - plain).abs().max()), "rows": excess.numel(),
           "rows_over": int((excess > 0).sum()), "worst_excess": float(excess.max())}
    if out["rows_over"]:
        raise AssertionError(f"lse outside 2 x plain error + {LSE_ABS} x max(|lse|, 1): {out}")
    return out


def _flash_bwd_bound(B, S, Skv, K, G, D, causal: bool) -> tuple[float, str]:
    """Row 9: five products of 2 B H D S Skv FLOPs (half under the causal
    mask) on the bf16 tensor cores, or q, k, v, out, dO, dq, dk, dv (bf16) and
    lse (f32) once over the memory's rate."""
    H = K * G
    t_ops = 10 * B * H * D * S * Skv * (0.5 if causal else 1.0) / PEAK_BF16_TC_S
    t_bytes = (2 * (4 * B * S * H * D + 4 * B * Skv * K * D) + 4 * B * H * S) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _ptxas_by_kernel(log: str, pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name holds
    ``pattern``, from nvcc's ``-Xptxas -v`` output, and whether ptxas
    serialised its wgmmas (``C7512``); keys like ``flash_bwd_dkdv_kernel<128>``."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = None
            if pattern in m.group(1):
                n = re.search(r"(\w+?_kernel)I(?:Li(\d+)E)?", m.group(1)[m.group(1).find(pattern):])
                cur = f"{n.group(1)}<{n.group(2)}>" if n and n.group(2) else m.group(1)[-60:]
                out[cur] = {"registers": None, "spill_stores": None, "spill_loads": None,
                            "wgmma_serialized": False}
            continue
        if "C7512" in ln:
            for name in out:
                if name.split("<")[0] in ln:
                    out[name]["wgmma_serialized"] = True
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def _flash_bwd_passes_ms(fn, reps: int) -> dict | None:
    """Device milliseconds of each of row 9's kernels a call, from a
    profiled window of ``reps`` calls (None where the profiler cannot
    start)."""
    import re

    import torch

    notes = {}
    fn()
    torch.cuda.synchronize()
    prof = _start_profiler(notes)
    if prof is None:
        return None
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    prof.stop()
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        m = re.search(r"flash_bwd_(\w+?)_kernel", evt.key)
        if m and us:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / reps
    return out


def _rel_leaves(a: dict, b: dict) -> dict:
    """Per leaf, max |a - b| over max |b|."""
    return {n: float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
            for n in b}


def _lm_train(dev, seed: int) -> list:
    """starcoder2-3b at the published widths and full depth trained on the
    card through ``build_model`` / ``init_train_state`` / ``make_train_step``:
    float32 master parameters from the port's ``init``, bf16 compute with
    the config's ``remat="full"``, ``AdamWConfig()``; 4 steps of 8 x 2,048
    tokens from the token pipeline in 2 microbatches, each step 120
    launches of row 7 (with ``lse``: forward and remat recompute), 60 of
    row 9 and one of row 10 (AdamW) with no plain call, a finite loss and
    parameters that move; a profiled step by kind of kernel; row 10 alone
    over every leaf, bit-identical to its plain version on a few leaves'
    copies, beside its plain version and ``torch.optim.AdamW(fused=True)``
    on the same leaves and moments.  The same steps from the same seed
    and batches again three times: row 9 over a plan for half the SMs (its
    partials summed in another order), and rows 7, 9 and 10 patched to
    their plain versions at the config's blocks and at 256/256; the kernel
    path's loss and grad-norm curves must stay within twice the larger
    spread of the two pairs that differ only in their order of sums.
    Checks: rows 9 and 7's ``lse``
    against their plain versions and float64 at the phase's shape and
    awkward ones, two row-9 launches bit for bit; one step of a 2-layer
    model at the published widths through the kernels against two plain
    paths that differ only in their blocks and a float32 path (``lm_serve``
    check 3's rule: the loss, ``grad_norm`` and each gradient leaf within
    twice the plain paths' spread, and within twice the plain path's
    distance to float32).  Returns the records of rows 9, 7 (with
    ``lse``) and 10."""
    import copy
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ref
    from repro_torch.models.common import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as optim_adamw
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, step_scalars
    from repro_torch.steps.train import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(LM_TRAIN_ARCH)
    G = cfg.n_heads // cfg.n_kv_heads
    opt_cfg = AdamWConfig()
    failures = []  # raised at the end, after every reading is logged

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    state = init_train_state(model, torch.Generator(dev).manual_seed(seed), opt_cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    params = state["params"]
    n_params = sum(p.numel() for p in params.parameters())
    # the config counts one vector a norm; layernorm also has its bias
    n_norms = 2 * cfg.n_layers + 1
    want_params = cfg.param_count() + (n_norms * cfg.d_model if cfg.norm == "layernorm" else 0)
    if n_params != want_params:
        raise AssertionError(f"{n_params} parameters, the config counts {want_params}")
    if not all(p.requires_grad and p.dtype == torch.float32 for p in params.parameters()):
        raise AssertionError("init did not give trainable float32 parameters")
    state_gb = 16 * n_params / 1e9  # parameters, gradients, m and v, float32

    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH, seed=seed))

    def batch_at(i):
        b = pipe.batch_at(i)
        return {"tokens": torch.from_numpy(b["tokens"]).long().to(dev),
                "labels": torch.from_numpy(b["labels"]).long().to(dev)}

    step = make_train_step(model, opt_cfg, n_microbatches=LM_TRAIN_MICRO)
    watched = {"embed": params.embed, "final_norm.scale": params.final_norm.scale,
               "layer0.attn.wq": params.groups[0]["p0"][0].attn.wq,
               "last.ffn.w_out": params.groups[0]["p0"][cfg.n_layers - 1].ffn.w_out}
    before = {n: p.detach()[:64].clone() for n, p in watched.items()}
    recompute = 1 if cfg.remat == "none" else 2  # remat runs each layer's forward again
    want = {"flash_fwd": recompute * cfg.n_layers * LM_TRAIN_MICRO,
            "flash_bwd": cfg.n_layers * LM_TRAIN_MICRO, "decode_attn": 0, "adamw": 1,
            "plain_calls": 0}
    steps, totals = [], dict.fromkeys(want, 0)
    for i in range(LM_TRAIN_STEPS):
        batch = batch_at(i)
        kattn.flash_launches = kattn.flash_bwd_launches = kattn.decode_launches = 0
        kadamw.adamw_launches = 0
        ref.calls = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counted = {"flash_fwd": kattn.flash_launches, "flash_bwd": kattn.flash_bwd_launches,
                   "decode_attn": kattn.decode_launches, "adamw": kadamw.adamw_launches,
                   "plain_calls": ref.calls}
        steps.append({"step": i + 1, "wall_s": wall, "counted": counted,
                      **{k: float(v) for k, v in metrics.items()}})
        totals = {k: totals[k] + counted[k] for k in want}
        if counted != want:
            raise AssertionError(f"train step {i + 1}: {counted}, want {want}")
        if not math.isfinite(steps[-1]["loss"]) or not math.isfinite(steps[-1]["grad_norm"]):
            raise AssertionError(f"train step {i + 1}: non-finite loss or grad_norm {steps[-1]}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    moved = {n: float((p.detach()[:64] - before[n]).abs().max()) for n, p in watched.items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"parameters did not move: {moved}")
    wall_s = sum(r["wall_s"] for r in steps[1:]) / (LM_TRAIN_STEPS - 1)

    # a profiled step, and the optimizer's update alone (row 10 and the
    # global norm's torch ops)
    notes = {}
    batch = batch_at(LM_TRAIN_STEPS)
    profile = None
    for _ in range(2):  # the first profiled window pays the profiler's start
        torch.cuda.synchronize(dev)
        prof = _start_profiler(notes)
        if prof is None:
            break
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        prof.stop()
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    if prof is not None:
        kinds = _kernel_device_ms(prof)
        torch.cuda.synchronize(dev)
        oprof = _start_profiler(notes)
        adamw_update(params, zeros, state["opt"], opt_cfg)
        torch.cuda.synchronize(dev)
        opt_ms = None
        if oprof is not None:
            oprof.stop()
            opt_ms = sum(_kernel_device_ms(oprof).values())
        busy = sum(kinds.values())
        profile = {"device_ms_step": {**{k: v for k, v in kinds.items() if k != "other"},
                                      "optimizer": opt_ms,
                                      "rest": kinds["other"] - max((opt_ms or 0.0)
                                                                   - kinds["adamw"], 0.0)},
                   "top_kernels_ms_step": _device_kernels_ms(prof),
                   "device_busy_ms_step": busy, "unprofiled_ms_step": wall_s * 1e3,
                   "idle_share": 1 - busy / (wall_s * 1e3)}

    # row 10 alone over the model's every leaf (the state's moments, zero
    # gradients), its plain version, and torch.optim.AdamW(fused=True) over
    # the same leaves and moments (timed only)
    names = list(zeros)
    named = dict(params.named_parameters())
    leaves = ([named[n].detach() for n in names], [zeros[n] for n in names],
              [state["opt"]["m"][n] for n in names], [state["opt"]["v"][n] for n in names])
    lr, bc1, bc2 = step_scalars({"step": state["opt"]["step"].clone()}, opt_cfg)
    clip = torch.ones((), dtype=torch.float32, device=dev)
    hyper = dict(b1=opt_cfg.b1, b2=opt_cfg.b2, eps=opt_cfg.eps, weight_decay=opt_cfg.weight_decay)
    some = [0, 1, len(names) - 1]  # row 10 against plain on copies of a few leaves
    kc, pc = ([[t[i].clone() for i in some] for t in leaves] for _ in range(2))
    kadamw.adamw_fused(*kc, lr, bc1, bc2, clip, **hyper)
    ref.adamw_ref(*pc, lr, bc1, bc2, clip, **hyper)
    torch.cuda.synchronize(dev)
    row10_err = max(float((a - b).abs().max()) for ka, pa in zip(kc, pc) for a, b in zip(ka, pa))
    row10_equal = all(torch.equal(a, b) for ka, pa in zip(kc, pc) for a, b in zip(ka, pa))
    del kc, pc
    # ten launches back to back: the wrapper's host work (a few ms) hides
    # behind each launch's device time, so this is the kernel's
    row10_ms = _sync_ms(lambda: kadamw.adamw_fused(*leaves, lr, bc1, bc2, clip, **hyper), 10, dev)
    row10_plain_ms = _sync_ms(lambda: ref.adamw_ref(*leaves, lr, bc1, bc2, clip, **hyper), 2,
                              dev)
    plist = [named[n] for n in names]
    for p, g in zip(plist, leaves[1]):
        p.grad = g
    lib = torch.optim.AdamW(plist, lr=float(lr), betas=(opt_cfg.b1, opt_cfg.b2),
                            eps=opt_cfg.eps, weight_decay=opt_cfg.weight_decay, fused=True)
    for p, m, v in zip(plist, leaves[2], leaves[3]):  # its state is ours: no second copy
        lib.state[p] = {"step": torch.ones((), dtype=torch.float32, device=dev),
                        "exp_avg": m, "exp_avg_sq": v}
    row10_lib_ms = _sync_ms(lib.step, 10, dev)
    for p in plist:
        p.grad = None
    n_el = sum(p.numel() for p in plist)
    row10_bound, row10_by = _bound_ms(ADAMW_BYTES * n_el, ADAMW_OPS * n_el)
    row10 = {"ms": row10_ms, "plain_ms": row10_plain_ms,
             "library_ms": row10_lib_ms, "bound_ms": row10_bound, "bound_by": row10_by,
             "leaves": len(names), "elements": n_el, "max_abs_err_sample": row10_err,
             "bit_identical_sample": row10_equal}
    del lib, plist, leaves, zeros, named
    if not row10_equal:
        raise AssertionError(f"row 10 differs from its plain version: {row10_err}")
    _log("lm_train", arch=cfg.name, describe=cfg.describe(), params=n_params,
         state_gb_16_bytes_a_param=state_gb, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         microbatches=LM_TRAIN_MICRO, remat=cfg.remat, init_s=init_s, steps=steps,
         wall_s_step=wall_s, tokens_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / wall_s,
         max_memory_allocated_gb=peak_gb, memory_before_gb=mem_before / 1e9,
         launches_per_step=want, launches_total=totals, moved=moved, profile=profile,
         profile_notes=notes, adamw=row10)
    del state, params, watched, step, model, batch
    torch.cuda.empty_cache()

    # ---- the same steps through the plain rows 7 and 9 (loss curves) ------------
    def plain_attention():
        """The plain versions in place of the training attention's wrappers
        (rows 7 and 9) and of the optimizer's (row 10)."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(optim_adamw, "adamw_fused", ref.adamw_ref))
        stack.enter_context(mock.patch.object(
            kattn, "flash_attention_fwd",
            lambda q, k, v, *, causal=True, q_block=512, kv_block=1024:
            ref.flash_attention_fwd_ref(q, k, v, causal, q_block, kv_block)))
        stack.enter_context(mock.patch.object(
            kattn, "flash_attention_bwd",
            lambda q, k, v, out, lse, do, *, causal=True, q_block=512, kv_block=1024:
            ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, q_block, kv_block)))
        return stack

    def other_order():
        """Row 9 with its dK/dV partials summed in another order: the same
        kernels over a plan made for half the card's SMs, whose runs are
        cut at other places."""
        plan = kattn.flash_bwd_plan
        kattn._bwd_plans.clear()
        return mock.patch.object(kattn, "flash_bwd_plan",
                                 lambda *a: plan(*a[:-1], max(1, a[-1] // 2)))

    def curve(c, patch) -> dict:
        """Loss and grad norm of each of the ``LM_TRAIN_STEPS`` steps of a
        model built and initialised from the same seed, on the same
        batches, under ``patch()``."""
        m = build_model(c, device=dev)
        st = init_train_state(m, torch.Generator(dev).manual_seed(seed), opt_cfg)
        run_step = make_train_step(m, opt_cfg, n_microbatches=LM_TRAIN_MICRO)
        kattn.flash_launches = kattn.flash_bwd_launches = kadamw.adamw_launches = 0
        ref.calls = 0
        losses, norms = [], []
        t0 = time.perf_counter()
        with patch():
            for i in range(LM_TRAIN_STEPS):
                st, mets = run_step(st, batch_at(i))
                losses.append(float(mets["loss"]))
                norms.append(float(mets["grad_norm"]))
        torch.cuda.synchronize(dev)
        kattn._bwd_plans.clear()  # no plan made under the patch outlives it
        out = {"loss": losses, "grad_norm": norms, "wall_s": time.perf_counter() - t0,
               "kernel_launches": (kattn.flash_launches + kattn.flash_bwd_launches
                                   + kadamw.adamw_launches),
               "plain_calls": ref.calls}
        del st, m, run_step
        torch.cuda.empty_cache()
        return out

    curves = {"kernel": {"loss": [r["loss"] for r in steps],
                         "grad_norm": [r["grad_norm"] for r in steps]},
              "kernel_other_order": curve(cfg, other_order),
              "plain": curve(cfg, plain_attention),
              "plain_blocks": curve(dataclasses.replace(cfg, q_block=256, kv_block=256),
                                    plain_attention)}
    # lm_train_checks' rule over the whole curve: the kernel path within
    # twice the rounding noise at any step.  The noise is the larger of two
    # pairs that differ only in the order of their sums: the two plain paths
    # (their blocks) and the two kernel paths (row 9's partials).  Each step
    # amplifies the rounding of the steps before it, which the plain paths'
    # blocks alone understate.
    verdict = {}
    for what in ("loss", "grad_norm"):
        k_c, k2_c, p_c, o_c = (curves[n][what]
                               for n in ("kernel", "kernel_other_order", "plain", "plain_blocks"))
        gap = max(abs(a - b) for a, b in zip(k_c, p_c))
        spread_plain = max(abs(a - b) for a, b in zip(o_c, p_c))
        spread_kernel = max(abs(a - b) for a, b in zip(k2_c, k_c))
        spread = max(spread_plain, spread_kernel)
        verdict[what] = {"kernel_vs_plain": gap, "plain_blocks_vs_plain": spread_plain,
                         "kernel_other_order_vs_kernel": spread_kernel,
                         "within": gap <= LM_E2E_FACTOR * spread}
    _log("lm_train_curves", steps=LM_TRAIN_STEPS, curves=curves, verdict=verdict,
         kernels_cleared=all(v["within"] for v in verdict.values()))
    launches = (want["flash_fwd"] + want["flash_bwd"] + want["adamw"]) * LM_TRAIN_STEPS
    for n, want_kernel, want_plain in (("kernel_other_order", launches, 0),
                                       ("plain", 0, launches), ("plain_blocks", 0, launches)):
        if (curves[n]["kernel_launches"], curves[n]["plain_calls"]) != (want_kernel, want_plain):
            failures.append(f"{n} curve: {curves[n]['kernel_launches']} kernel launches, "
                            f"{curves[n]['plain_calls']} plain calls")
    for what, v in verdict.items():
        if not v["within"]:
            noise = max(v["plain_blocks_vs_plain"], v["kernel_other_order_vs_kernel"])
            failures.append(f"{what} curve: the kernel path parts from the plain path by "
                            f"{v['kernel_vs_plain']}, more than {LM_E2E_FACTOR} x the rounding "
                            f"noise {noise}")

    # ---- rows 9 and 7 (lse) against their plain versions and float64 -----------
    gen_rng = torch.Generator(dev).manual_seed(seed + 29)

    def randn(*shape):
        return torch.randn(shape, generator=gen_rng, device=dev).to(torch.bfloat16)

    checks, phase_inputs = {}, None
    for B, S, Skv, K, Gs, D, causal in LM_TRAIN_SHAPES:
        qa, ka, va, doa = randn(B, S, K, Gs, D), randn(B, Skv, K, D), randn(B, Skv, K, D), \
            randn(B, S, K, Gs, D)
        out_k, lse_k = kattn.flash_attention_fwd(qa, ka, va, causal=causal)
        out_p, lse_p = ref.flash_attention_fwd_ref(qa, ka, va, causal, 512, 1024)
        out64, lse64, dq64, dk64, dv64 = _attention64_grads(qa, ka, va, doa, causal)
        g_k = kattn.flash_attention_bwd(qa, ka, va, out_k, lse_k, doa, causal=causal)
        g_k2 = kattn.flash_attention_bwd(qa, ka, va, out_k, lse_k, doa, causal=causal)
        g_p = ref.flash_attention_bwd_ref(qa, ka, va, out_k, lse_k, doa, causal, 512, 1024)
        torch.cuda.synchronize(dev)
        name = f"{B}x{S}x{Skv}x{K}x{Gs}x{D}" + ("" if causal else " non-causal")
        checks[name] = {
            "bit_identical_twice": all(torch.equal(a, b) for a, b in zip(g_k, g_k2)),
            "out": _yardstick(out_k, out_p, out64), "lse": _lse_check(lse_k, lse_p, lse64),
            **{f"d{n}": _yardstick(gk, gp, g64, BWD_FLOOR)
               for n, gk, gp, g64 in zip("qkv", g_k, g_p, (dq64, dk64, dv64))}}
        if not checks[name]["bit_identical_twice"]:
            raise AssertionError(f"{name}: two row-9 launches differ")
        if phase_inputs is None:
            phase_inputs = (qa, ka, va, doa, out_k, lse_k, (B, S, Skv, K, Gs, D, causal))
        del out64, lse64, dq64, dk64, dv64, g_k, g_k2, g_p
        torch.cuda.empty_cache()

    qa, ka, va, doa, out_k, lse_k, shape = phase_inputs
    B, S, Skv, K, Gs, D, causal = shape
    H = K * Gs
    bwd_ms = _sync_ms(lambda: kattn.flash_attention_bwd(qa, ka, va, out_k, lse_k, doa), 10, dev)
    bwd_device_ms = _graph_ms(
        lambda: kattn.flash_attention_bwd(qa, ka, va, out_k, lse_k, doa), 10, dev)
    bwd_plain_ms = _sync_ms(
        lambda: ref.flash_attention_bwd_ref(qa, ka, va, out_k, lse_k, doa, True, 512, 1024), 2,
        dev)
    fwd_ms = _sync_ms(lambda: kattn.flash_attention_fwd(qa, ka, va), 10, dev)
    fwd_device_ms = _graph_ms(lambda: kattn.flash_attention_fwd(qa, ka, va), 10, dev)
    fwd_plain_ms = _sync_ms(lambda: ref.flash_attention_fwd_ref(qa, ka, va, True, 512, 1024), 2,
                            dev)
    qs = qa.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous().requires_grad_(True)
    ks = ka.transpose(1, 2).contiguous().requires_grad_(True)
    vs = va.transpose(1, 2).contiguous().requires_grad_(True)
    dos = doa.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    fwd_lib_ms = _sync_ms(lambda: F.scaled_dot_product_attention(
        qs.detach(), ks.detach(), vs.detach(), is_causal=True, enable_gqa=True), 10, dev)
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    bwd_lib_ms = _sync_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), dos,
                                                      retain_graph=True), 10, dev)
    del qs, ks, vs, dos, o_sdpa
    passes = _flash_bwd_passes_ms(
        lambda: kattn.flash_attention_bwd(qa, ka, va, out_k, lse_k, doa), 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = kattn.flash_bwd_plan(B, S, Skv, K, Gs, causal, sms)
    loads = plan.loads
    _log("lm_train_kernels", checks=checks,
         times={"flash_bwd_device_ms": bwd_device_ms, "flash_fwd_lse_device_ms": fwd_device_ms,
                "flash_bwd_ms": bwd_ms, "flash_bwd_sdpa_ms": bwd_lib_ms,
                "flash_bwd_bound_ms": _flash_bwd_bound(B, S, Skv, K, Gs, D, causal)[0],
                "flash_bwd_passes_device_ms": passes},
         plan={"sms": sms, "ctas": plan.n_cta, "items": plan.n_items, "row_tiles": plan.n_rt,
               "key_tiles": plan.n_kt, "pairs": plan.n_pairs,
               "chunks_most": max(len(c) for c in plan.chunks),
               "runs_cut": sum(len(c) > 1 for c in plan.chunks), "cap": plan.cap,
               "longest_item_row_tiles": plan.longest, "cta_cost_max": max(loads),
               "cta_cost_mean": sum(loads) / len(loads), "partial_slots": plan.n_slots,
               "workspace_mb": plan.workspace_floats(D) * 4 / 1e6},
         ptxas=_ptxas_by_kernel(BUILD_LOGS.get("attention_bwd", ""), "flash_bwd"),
         shape={"B": B, "S": S, "K": K, "G": Gs, "D": D})
    phase_err = checks[next(iter(checks))]
    del qa, ka, va, doa, out_k, lse_k, phase_inputs
    torch.cuda.empty_cache()

    # ---- one step of a 2-layer model: kernel path against plain and f32 paths ----
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    params0 = build_model(cfg2, device=dev).init(torch.Generator(dev).manual_seed(seed + 31))
    cpipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_CHECK_SEQ, global_batch=LM_CHECK_BATCH, seed=seed + 1))
    cb = cpipe.batch_at(0)
    cbatch = {"tokens": torch.from_numpy(cb["tokens"]).long().to(dev),
              "labels": torch.from_numpy(cb["labels"]).long().to(dev)}

    def one_step(c, plain: bool):
        """Loss, grad_norm and the accumulated gradients (before the
        optimizer) of one train step from ``params0``."""
        p = copy.deepcopy(params0)
        st = {"params": p, "opt": adamw_init(p)}
        grads = {}

        def keep(g, s):
            grads.update({n: t.detach().clone() for n, t in g.items()})
            return g, s

        run = make_train_step(build_model(c, device=dev), opt_cfg, compress_grads=keep)
        kattn.flash_launches = kattn.flash_bwd_launches = 0
        ref.calls = 0
        with plain_attention() if plain else contextlib.nullcontext():
            _, m = run(st, cbatch)
        torch.cuda.synchronize(dev)
        counted = (kattn.flash_launches, kattn.flash_bwd_launches, ref.calls)
        return float(m["loss"]), float(m["grad_norm"]), grads, counted

    k_loss, k_norm, k_grads, k_counted = one_step(cfg2, False)
    p_loss, p_norm, p_grads, p_counted = one_step(cfg2, True)
    o_loss, o_norm, o_grads, _ = one_step(
        dataclasses.replace(cfg2, q_block=256, kv_block=256), True)
    compute = Policy.compute_dtype
    try:
        Policy.compute_dtype = torch.float32
        f_loss, f_norm, f_grads, _ = one_step(cfg2, True)
    finally:
        Policy.compute_dtype = compute
    kp, pp = _rel_leaves(k_grads, p_grads), _rel_leaves(o_grads, p_grads)
    k32, p32 = _rel_leaves(k_grads, f_grads), _rel_leaves(p_grads, f_grads)
    # lm_serve's rule: the spread is the two plain paths' largest difference
    # over the whole gradient (there over all steps), not each leaf's own,
    # which for the norms' leaves is a handful of bf16 flips
    spread = max(pp.values())
    over = sorted(n for n in kp if kp[n] > LM_E2E_FACTOR * spread)
    e2e = {"loss": {"kernel": k_loss, "plain": p_loss, "plain_blocks": o_loss, "f32": f_loss},
           "grad_norm": {"kernel": k_norm, "plain": p_norm, "plain_blocks": o_norm,
                         "f32": f_norm},
           "grad_rel_max": {"kernel_vs_plain": max(kp.values()),
                            "plain_blocks_vs_plain": max(pp.values()),
                            "kernel_vs_f32": max(k32.values()), "plain_vs_f32": max(p32.values())},
           "leaves_over_spread": over, "leaves": len(kp),
           "leaves_over_own_spread": sorted(n for n in kp if kp[n] > LM_E2E_FACTOR * pp[n]),
           "per_leaf": {n: {"kernel_vs_plain": kp[n], "plain_blocks_vs_plain": pp[n],
                            "kernel_vs_f32": k32[n], "plain_vs_f32": p32[n]} for n in kp},
           "counted": {"kernel": k_counted, "plain": p_counted}}
    _log("lm_train_checks", layers=LM_CHECK_LAYERS, batch=LM_CHECK_BATCH, seq=LM_CHECK_SEQ,
         **e2e)
    del params0, k_grads, p_grads, o_grads, f_grads
    torch.cuda.empty_cache()
    if k_counted != (recompute * LM_CHECK_LAYERS, LM_CHECK_LAYERS, 0) or p_counted[:2] != (0, 0):
        failures.append(f"check paths' launches: kernel {k_counted}, plain {p_counted}")
    for what, (k_v, p_v, o_v) in {"loss": (k_loss, p_loss, o_loss),
                                  "grad_norm": (k_norm, p_norm, o_norm)}.items():
        if abs(k_v - p_v) > LM_E2E_FACTOR * abs(o_v - p_v):
            failures.append(f"{what}: kernel path {k_v} against plain {p_v}, more than "
                            f"{LM_E2E_FACTOR} x the plain paths' spread {abs(o_v - p_v)}")
    if over:
        failures.append(f"gradient leaves beyond {LM_E2E_FACTOR} x the plain paths' spread "
                        f"{spread}: {over}")
    if max(k32.values()) > LM_E2E_FACTOR * max(p32.values()):
        failures.append(f"kernel path's gradients against float32 {max(k32.values())} > "
                        f"{LM_E2E_FACTOR} x the plain path's {max(p32.values())}")
    if failures:
        raise AssertionError("; ".join(failures))

    adamw_rec = {
        "name": "adamw_f32", "route": "cuda", "source": "src/repro_torch/csrc/adamw.cu",
        "replaces": "src/repro/optim/adamw.py:82 (jnp adamw_update, not a Pallas site)",
        "launches": totals["adamw"], "max_abs_err": row10["max_abs_err_sample"],
        "ms": row10["ms"], "plain_ms": row10["plain_ms"], "bound_ms": row10["bound_ms"],
        "bound_by": row10["bound_by"], "library_ms": row10["library_ms"],
        "shape": {"leaves": row10["leaves"], "elements": row10["elements"]}}
    src = "src/repro_torch/csrc/attention_bwd.cu"
    bwd_bound, bwd_by = _flash_bwd_bound(B, S, Skv, K, Gs, D, causal)
    fwd_bound, fwd_by = _flash_bound(B, S, K, Gs, D)
    shape = {"B": B, "S": S, "K": K, "G": Gs, "D": D}
    return [
        {"name": "flash_bwd", "route": "cuda", "source": src,
         "replaces": "src/repro/models/attention.py:223", "launches": totals["flash_bwd"],
         "max_abs_err": max(phase_err[f"d{n}"]["kernel_vs_plain"] for n in "qkv"),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound, "bound_by": bwd_by,
         "library_ms": bwd_lib_ms, "shape": shape},
        {"name": "flash_fwd_lse", "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
         "replaces": "src/repro/models/attention.py:147", "launches": totals["flash_fwd"],
         "max_abs_err": phase_err["out"]["kernel_vs_plain"], "ms": fwd_ms,
         "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": fwd_lib_ms, "shape": shape},
        adamw_rec,
    ]


# ---- the training driver and launcher (lm_driver) ---------------------------

LM_DRIVER_LAYERS = 2  # the depth cut: every width of the published config kept
LM_DRIVER_STEPS = 80  # cut from 200 (PR 27) to keep the script inside its time limit
LM_DRIVER_SAVE_EVERY = 40  # two checkpoints a run
# the restart run: a transient failure and a device loss between the saves
LM_DRIVER_TRANSIENT = 45
LM_DRIVER_DEVICE_LOSS = 50
LM_DRIVER_CHECK_UPDATES = 3  # rows 10 and 11 against plain on real gradients
LM_DRIVER_CHECK_BATCH = 2
# the widths of the published config that reduced_config replaces
LM_DRIVER_WIDTHS = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim", "q_block",
                    "kv_block", "remat")


def _adamw8bit_bytes(numels) -> int:
    """Row 11's bytes: p and g read, p written (float32), each 128-element
    block's two int8 moments read and written and its two scales read and
    written."""
    nb = sum(-(-n // 128) for n in numels)
    return 12 * sum(numels) + 4 * 128 * nb + 16 * nb


def _lm_driver(dev, seed: int) -> tuple[list, dict]:
    """starcoder2-3b at the published widths, cut to ``LM_DRIVER_LAYERS``
    layers, trained through the launcher ``train_main`` on the card:
    ``LM_DRIVER_STEPS`` steps of 8 x 2,048 tokens in 2 microbatches,
    checkpoints every ``LM_DRIVER_SAVE_EVERY`` steps into a temporary
    directory (removed), the loss finite and falling; then the same run with
    a transient failure and a device loss on the one card (the re-mesh
    planned and built) between the two saves, whose steps must repeat the
    uninterrupted run's losses and gradient norms bit for bit.  Both runs
    under ``torch.use_deterministic_algorithms(True)``; each step launches
    rows 7, 9 and 10 and no plain version.  Then rows 10 and 11 against
    their plain versions over ``LM_DRIVER_CHECK_UPDATES`` updates of this
    model's real gradients, bit for bit, and row 11 timed at the full
    model's leaves.  Returns row 11's record and the run's launches of rows
    7, 9 and 10."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ref
    from repro_torch.launch.train import train_main
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as optim_adamw
    from repro_torch.optim import adamw8bit as optim_adamw8bit
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, step_scalars
    from repro_torch.optim.adamw8bit import adamw8bit_init, adamw8bit_update
    from repro_torch.runtime.driver import DeviceLoss
    from repro_torch.runtime.elastic import build_remesh, plan_remesh
    from repro_torch.steps.loss import softmax_xent

    torch.cuda.empty_cache()
    full = get_config(LM_TRAIN_ARCH)
    overrides = {f: getattr(full, f) for f in LM_DRIVER_WIDTHS}
    overrides["n_layers"] = LM_DRIVER_LAYERS
    cfg = get_reduced(LM_TRAIN_ARCH, **overrides)
    if cfg != dataclasses.replace(full, n_layers=LM_DRIVER_LAYERS):
        raise AssertionError(f"the overrides do not restore the published widths: {cfg}")
    run = dict(steps=LM_DRIVER_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
               reduced_overrides=overrides, save_every=LM_DRIVER_SAVE_EVERY,
               n_microbatches=LM_TRAIN_MICRO, seed=seed, device=dev)
    recompute = 1 if cfg.remat == "none" else 2
    per_step = {"flash_fwd": recompute * cfg.n_layers * LM_TRAIN_MICRO,
                "flash_bwd": cfg.n_layers * LM_TRAIN_MICRO, "adamw": 1}
    root = tempfile.gettempdir()
    # parameters, m and v in float32, twice (two checkpoints a run)
    need_gb = 2 * 12 * cfg.param_count() / 1e9
    free_gb = shutil.disk_usage(root).free / 1e9
    _log("lm_driver_disk", dir=root, free_gb=free_gb, need_gb=need_gb)
    if free_gb < need_gb:
        raise AssertionError(f"{free_gb:.1f} GB free under {root}, two checkpoints need "
                             f"{need_gb:.1f} GB")

    def counted_run(**extra) -> tuple[dict, dict]:
        with tempfile.TemporaryDirectory(prefix="lm_driver_", dir=root) as ckpt:
            kattn.flash_launches = kattn.flash_bwd_launches = kadamw.adamw_launches = 0
            ref.calls = 0
            out = train_main(LM_TRAIN_ARCH, ckpt_dir=ckpt, **run, **extra)
            counted = {"flash_fwd": kattn.flash_launches, "flash_bwd": kattn.flash_bwd_launches,
                       "adamw": kadamw.adamw_launches, "plain_calls": ref.calls}
            steps_on_disk = sorted(os.listdir(ckpt))
            disk_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ckpt)
                          for f in fs) / 1e9
        out["checkpoints_on_disk"], out["checkpoint_disk_gb"] = steps_on_disk, disk_gb
        out["removed"] = not os.path.exists(ckpt)
        return out, counted

    armed = {LM_DRIVER_TRANSIENT: RuntimeError("injected transient failure"),
             LM_DRIVER_DEVICE_LOSS: DeviceLoss(n_alive=1)}
    meshes = []

    def inject(step):
        if step in armed:
            raise armed.pop(step)

    def on_remesh(n_alive):
        plan = plan_remesh(n_alive, prefer_model=1, global_batch=LM_TRAIN_BATCH)
        meshes.append({"plan": dataclasses.asdict(plan),
                       "devices": [str(d) for d in build_remesh(plan).devices.flat]})

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        first, first_counted = counted_run()
        again, again_counted = counted_run(inject_failure=inject, on_remesh=on_remesh)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    failures = []
    losses = [m["loss"] for m in first["metrics_log"]]
    for name, out, counted in (("first", first, first_counted), ("restart", again, again_counted)):
        n = len(out["metrics_log"])
        want = {k: v * n for k, v in per_step.items()}
        if {k: counted[k] for k in per_step} != want or counted["plain_calls"]:
            failures.append(f"{name} run: launches {counted}, want {want} and 0 plain calls")
        if not out["removed"] or len(out["checkpoints_on_disk"]) > 2:
            failures.append(f"{name} run: checkpoints {out['checkpoints_on_disk']}")
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in out["metrics_log"]):
            failures.append(f"{name} run: a loss or grad norm is not finite")
    if not first["last_loss"] < first["first_loss"]:
        failures.append(f"the loss did not fall: {first['first_loss']} -> {first['last_loss']}")
    want_events = ["init:fresh", f"save:step_{LM_DRIVER_SAVE_EVERY}",
                   "retry1:RuntimeError", f"restore:step_{LM_DRIVER_SAVE_EVERY}",
                   "device_loss:1", "remesh", f"restore:step_{LM_DRIVER_SAVE_EVERY}",
                   f"save:step_{LM_DRIVER_STEPS}"]
    # the watchdog's straggler flags depend on timing: not part of the check
    events = [e for e in again["events"] if not e.startswith("straggler:")]
    if events != want_events or len(meshes) != 1:
        failures.append(f"restart events {again['events']}, meshes {meshes}")
    by_step = {m["step"]: m for m in first["metrics_log"]}
    apart = [m["step"] for m in again["metrics_log"] if m != by_step[m["step"]]]
    if apart:
        failures.append(f"restart steps {apart[:8]} differ from the uninterrupted run")
    stride = max(LM_DRIVER_STEPS // 20, 1)
    _log("lm_driver", arch=cfg.name, describe=cfg.describe(), cut={"n_layers": LM_DRIVER_LAYERS},
         params=first["params"], batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         microbatches=LM_TRAIN_MICRO, steps=first["steps"], wall_s=first["wall_s"],
         step_s=first["step_s"], stragglers=first["stragglers"],
         tokens_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / first["step_s"],
         first_loss=first["first_loss"], last_loss=first["last_loss"],
         min_loss=first["min_loss"], loss_every_10=losses[::stride],
         events=first["events"], saves=first["saves"],
         checkpoint_disk_gb=first["checkpoint_disk_gb"], launches=first_counted,
         launches_per_step=per_step, deterministic=True)
    _log("lm_driver_restart", events=again["events"], meshes=meshes,
         steps_run=len(again["metrics_log"]), wall_s=again["wall_s"], step_s=again["step_s"],
         saves=again["saves"], launches=again_counted, steps_apart=apart,
         bit_identical=not apart)
    if failures:
        raise AssertionError("; ".join(failures))

    # ---- rows 10 and 11 against their plain versions on real gradients ------
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=LM_DRIVER_STEPS)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(seed + 41))
    named = dict(params.named_parameters())
    p10 = {n: p.detach().clone() for n, p in named.items()}
    k8 = {n: p.detach().clone() for n, p in named.items()}
    p8 = {n: p.detach().clone() for n, p in named.items()}
    st10, pst10 = adamw_init(params), adamw_init(p10)
    st8, pst8 = adamw8bit_init(k8), adamw8bit_init(p8)
    pipe = ShardedTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_DRIVER_CHECK_BATCH,
        seed=seed + 43))
    checks = []
    for i in range(LM_DRIVER_CHECK_UPDATES):
        b = pipe.batch_at(i)
        tokens = torch.from_numpy(b["tokens"]).to(dev, torch.long)
        labels = torch.from_numpy(b["labels"]).to(dev, torch.long)
        logits, _ = model.forward(params, tokens)
        loss, _ = softmax_xent(logits, labels)
        loss.backward()
        del logits
        grads = {n: p.grad for n, p in named.items()}
        for p in named.values():
            p.grad = None
        kattn.flash_launches = kattn.flash_bwd_launches = 0
        kadamw.adamw_launches = kadamw.adamw8bit_launches = 0
        ref.calls = 0
        adamw_update(params, grads, st10, opt_cfg)
        adamw8bit_update(k8, grads, st8, opt_cfg)
        counted = (kadamw.adamw_launches, kadamw.adamw8bit_launches, ref.calls)
        with mock.patch.object(optim_adamw, "adamw_fused", ref.adamw_ref), \
                mock.patch.object(optim_adamw8bit, "adamw8bit_fused", ref.adamw8bit_ref):
            adamw_update(p10, grads, pst10, opt_cfg)
            adamw8bit_update(p8, grads, pst8, opt_cfg)
        torch.cuda.synchronize(dev)
        row10 = all(torch.equal(named[n].detach(), p10[n]) and torch.equal(st10["m"][n], pst10["m"][n])
                    and torch.equal(st10["v"][n], pst10["v"][n]) for n in named)
        row11 = all(torch.equal(k8[n], p8[n]) and all(torch.equal(st8["m8"][n][k], pst8["m8"][n][k])
                                                      for k in ("mq", "ms", "vq", "vs"))
                    for n in named)
        err10 = max(float((named[n].detach() - p10[n]).abs().max()) for n in named)
        err11 = max(float((k8[n] - p8[n]).abs().max()) for n in named)
        checks.append({"update": i + 1, "loss": float(loss.detach()), "counted": counted,
                       "row10_bit_identical": row10, "row11_bit_identical": row11,
                       "row10_max_abs_err": err10, "row11_max_abs_err": err11})
        del grads, loss
        if counted != (1, 1, 0) or not (row10 and row11):
            raise AssertionError(f"rows 10 and 11 against plain, update {i + 1}: {checks[-1]}")
    # the full model's leaves: these but for the layers, and one layer's
    # leaves for each of the published depth's layers
    shapes = ([tuple(p.shape) for n, p in named.items() if not n.startswith("groups.")]
              + [tuple(p.shape) for n, p in named.items() if n.startswith("groups.0.p0.0.")]
              * full.n_layers)
    _log("lm_driver_adamw_checks", params=sum(p.numel() for p in named.values()), checks=checks)
    del model, params, named, p10, k8, p8, st10, pst10, st8, pst8
    torch.cuda.empty_cache()

    # ---- row 11 at the full model's leaves --------------------------------------
    numels = [math.prod(sh) for sh in shapes]
    want_params = full.param_count() + (2 * full.n_layers + 1) * full.d_model  # layernorm biases
    if sum(numels) != want_params:
        raise AssertionError(f"{sum(numels)} elements in the full leaves, want {want_params}")
    gen = torch.Generator(dev).manual_seed(seed + 47)
    ps = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    gs = [torch.randn(sh, generator=gen, device=dev).mul_(1e-3) for sh in shapes]
    m8 = adamw8bit_init({str(i): p for i, p in enumerate(ps)})["m8"]
    states = [m8[str(i)] for i in range(len(ps))]
    lr, bc1, bc2 = step_scalars({"step": torch.zeros((), dtype=torch.int32, device=dev)}, opt_cfg)
    clip = torch.ones((), dtype=torch.float32, device=dev)
    hyper = dict(b1=opt_cfg.b1, b2=opt_cfg.b2, eps=opt_cfg.eps, weight_decay=opt_cfg.weight_decay)

    def kernel():
        kadamw.adamw8bit_fused(ps, gs, states, lr, bc1, bc2, clip, **hyper)

    row11_ms = _sync_ms(kernel, 10, dev)  # as row 10's: the device time
    row11_plain_ms = _sync_ms(lambda: ref.adamw8bit_ref(ps, gs, states, lr, bc1, bc2, clip,
                                                        **hyper), 1, dev)
    bound, bound_by = _bound_ms(_adamw8bit_bytes(numels), ADAMW8_OPS * sum(numels))
    state_gb = sum(t.numel() * t.element_size() for s8 in states for t in s8.values()) / 1e9
    _log("lm_driver_adamw8bit", leaves=len(shapes), elements=sum(numels), ms=row11_ms,
         plain_ms=row11_plain_ms, bound_ms=bound, bound_by=bound_by,
         moments_gb=state_gb, moments_bytes_a_param=state_gb * 1e9 / sum(numels))
    del ps, gs, m8, states
    torch.cuda.empty_cache()
    rec = {"name": "adamw_int8", "route": "cuda", "source": "src/repro_torch/csrc/adamw.cu",
           "replaces": "src/repro/optim/adamw8bit.py:77 (jnp adamw8bit_update, not a Pallas site)",
           "launches": sum(c["counted"][1] for c in checks),
           "max_abs_err": max(c["row11_max_abs_err"] for c in checks), "ms": row11_ms,
           "plain_ms": row11_plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "library_ms": None, "shape": {"leaves": len(shapes), "elements": sum(numels)}}
    launches = {"flash_fwd_lse": first_counted["flash_fwd"] + again_counted["flash_fwd"],
                "flash_bwd": first_counted["flash_bwd"] + again_counted["flash_bwd"],
                "adamw_f32": first_counted["adamw"] + again_counted["adamw"]}
    return [rec], launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    ap.add_argument("--row12-times", action="store_true",
                    help="only time row 12 at lm_moe_serve's shapes with this checkout's "
                         "src (one JSON line); no smoke run and no ok line")
    args = ap.parse_args(argv)

    # lm_driver runs under torch.use_deterministic_algorithms(True), which
    # takes cuBLAS only with a fixed workspace (set before its first handle)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if args.row12_times:
        from repro_torch.kernels import build

        build.build(("moe",))
        _log("lm_moe_row12_times", src=str(ROOT / "src"), card=card,
             row12=_lm_moe_row12(dev, args.seed))
        return 0
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
