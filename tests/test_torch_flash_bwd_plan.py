"""Row 9's work plan and tiling for head dims 64 and 128, on the CPU.

``kernels/attention.py`` ``flash_bwd_plan`` cuts each key tile's row
tiles into chunks and deals the items to the card's SMs;
``csrc/attention_bwd.cu`` runs them.  The kernels cannot run here, so
these tests hold the plan to what the kernels need (every (key tile, row
tile) pair that the mask leaves covered by exactly one item, no item past
the cap, the chunks of a key tile in row order with their partial slots
in that order), and hold a float64 twin of the kernels' arithmetic (the
delta pass's row-tile slots, the dK/dV items with their partials summed
in chunk order, the dQ items' lookups of those slots) to the float64
gradients of exact attention: within 1e-10 of the gradients' scale, as
only the order of float64 sums differs.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as kattn

from _torch_parity import attention64_grads

# (B, K, S, Skv, G, causal): the phase's microbatch, the 128-key tile's
# edges, the group sizes of the configs and G > 64 (two head blocks), Skv
# on both sides of S
PLAN_SHAPES = [
    (4, 2, 2048, 2048, 12, True),
    (1, 1, 127, 127, 1, True),
    (1, 1, 128, 128, 7, True),
    (2, 2, 129, 129, 12, True),
    (1, 2, 257, 257, 128, True),
    (2, 3, 1000, 1000, 7, True),
    (1, 1, 300, 300, 100, True),
    (1, 1, 1, 1, 1, True),
    (2, 2, 40, 150, 4, False),
    (1, 2, 150, 40, 4, False),
    (1, 1, 100, 300, 3, True),  # keys past the last position: tiles no row sees
    (1, 1, 300, 129, 7, True),
    (4, 2, 2048, 2048, 12, False),
    (1, 4, 513, 700, 16, False),
]


def _real_positions(S, G):
    """Each row tile's real positions (independently of the plan: the
    positions of its columns that hold a real (position, head) row)."""
    gsub, npos, n_gblk, n_rt = kattn.flash_bwd_row_tiles(S, G)
    out = []
    for t in range(n_rt):
        pb, hb = divmod(t, n_gblk)
        out.append({pb * npos + c // gsub for c in range(kattn.BWD_ROW_TILE)
                    if c < gsub * npos and hb * gsub + c % gsub < G and pb * npos + c // gsub < S})
    return out


@pytest.mark.parametrize("n_sm", [1, 16, 132])
@pytest.mark.parametrize("B,K,S,Skv,G,causal", PLAN_SHAPES)
def test_flash_bwd_plan_covers_every_needed_pair_once(B, K, S, Skv, G, causal, n_sm):
    plan = kattn.flash_bwd_plan(B, S, Skv, K, G, causal, n_sm)
    gsub, npos, n_gblk, n_rt = kattn.flash_bwd_row_tiles(S, G)
    assert (plan.gsub, plan.npos, plan.n_gblk, plan.n_rt) == (gsub, npos, n_gblk, n_rt)
    assert gsub * npos <= kattn.BWD_ROW_TILE and n_gblk * gsub >= G
    n_kt = -(-Skv // kattn.BWD_KEY_TILE)
    n_pairs = B * K
    assert plan.n_kt == n_kt and plan.n_pairs == n_pairs
    # which (key tile, row tile) pairs the mask leaves: a row at position p
    # sees key j iff j < Skv and, causal, j <= p
    positions = _real_positions(S, G)
    need = np.zeros((n_kt, n_rt), dtype=bool)
    for j in range(n_kt):
        k0 = j * kattn.BWD_KEY_TILE
        for t in range(n_rt):
            need[j, t] = bool(positions[t]) and (not causal or max(positions[t]) >= k0)
    covered = np.zeros((n_pairs, n_kt, n_rt), dtype=np.int64)
    per_run = {}  # (j, pair) -> its items' (t0, t1, slot)
    assert 1 <= plan.n_cta <= n_sm and all(plan.cta_items)
    for items in plan.cta_items:
        lengths = [t1 - t0 for _, _, t0, t1, _ in items]
        assert lengths == sorted(lengths, reverse=True)  # each CTA walks its longest first
        for j, pair, t0, t1, slot in items:
            assert 0 <= j < n_kt and 0 <= pair < n_pairs and t0 <= t1 <= n_rt
            assert t1 - t0 <= plan.cap
            covered[pair, j, t0:t1] += 1
            per_run.setdefault((j, pair), []).append((t0, t1, slot))
    assert (covered == need[None].astype(np.int64)).all()
    assert plan.n_items == sum(len(c) for c in plan.chunks)
    # every (key tile, pair) has its items: its chunks plan.chunks[j n_pairs +
    # pair] tile its row tiles in row order, and chunk c's partials go to
    # slot first_slot + c (each slot once), or the item writes dK and dV
    slots = []
    for j in range(n_kt):
        lo = int(np.argmax(need[j])) if need[j].any() else n_rt
        for pair in range(n_pairs):
            runs = plan.chunks[j * n_pairs + pair]
            first = plan.first_slot[j * n_pairs + pair]
            assert runs[0][0] == lo and runs[-1][1] == n_rt
            assert all(runs[c][1] == runs[c + 1][0] for c in range(len(runs) - 1))
            got = sorted(per_run[(j, pair)])
            assert [(t0, t1) for t0, t1, _ in got] == list(runs)
            if len(runs) == 1:
                assert first == -1 and got[0][2] == -1
            else:
                assert [s for _, _, s in got] == [first + c for c in range(len(runs))]
                slots += [s for _, _, s in got]
    assert sorted(slots) == list(range(plan.n_slots))
    # every CTA the same cost to within a few row tiles, no more CTAs than
    # give each segment BWD_MIN_CHUNK row tiles
    loads = plan.loads
    assert max(loads) <= sum(loads) / plan.n_cta + 2 * (kattn.BWD_ITEM_COST + 1)
    assert plan.n_cta == n_sm or sum(loads) < 2 * (n_sm + 1) * (kattn.BWD_MIN_CHUNK
                                                               + kattn.BWD_ITEM_COST)
    # the plan is a function of the shape and the SM count: the same again
    assert kattn.flash_bwd_plan(B, S, Skv, K, G, causal, n_sm) == plan


@pytest.mark.parametrize("B,K,S,Skv,G,causal", PLAN_SHAPES[:6])
def test_flash_bwd_plan_table_is_what_the_kernel_reads(B, K, S, Skv, G, causal):
    plan = kattn.flash_bwd_plan(B, S, Skv, K, G, causal, 132)
    table = kattn.flash_bwd_plan_table(plan)
    assert table.dtype == np.int32
    n_cta, n_items, n = plan.n_cta, plan.n_items, kattn.BWD_ITEM_INTS
    assert table.size == n_cta + 1 + n * n_items + 2 * plan.n_kt * plan.n_pairs
    offsets, items = table[:n_cta + 1], table[n_cta + 1:n_cta + 1 + n * n_items].reshape(-1, n)
    kt = table[n_cta + 1 + n * n_items:].reshape(-1, 2)
    for c in range(n_cta):
        assert [tuple(r) for r in items[offsets[c]:offsets[c + 1]]] == list(plan.cta_items[c])
    assert [tuple(r) for r in kt] == [(len(ch), fs) for ch, fs in zip(plan.chunks,
                                                                       plan.first_slot)]
    assert plan.workspace_floats(128) == (2 * plan.n_pairs * plan.n_rt * 64
                                          + plan.n_slots * 2 * 128 * 128)


def test_flash_bwd_plan_at_the_phase_shape_balances_the_causal_walk():
    """B 4, S 2,048, K 2, G 12 on 132 SMs: key tile 0 meets 410 row tiles
    of 5 positions and key tile 15 only 26; cut into 264 segments, no item
    is longer than about half a CTA's share and no CTA costs 2 % more than
    the mean (the first plan, longest chunks first to the least loaded CTA,
    left 22 %)."""
    plan = kattn.flash_bwd_plan(4, 2048, 2048, 2, 12, True, 132)
    assert (plan.gsub, plan.npos, plan.n_rt, plan.n_kt, plan.n_cta) == (12, 5, 410, 16, 132)
    tiles = sum(t1 - t0 for c in plan.cta_items for _, _, t0, t1, _ in c)
    assert tiles == 8 * sum(410 - (128 * j) // 5 for j in range(16))
    loads = plan.loads
    assert max(loads) <= 1.02 * sum(loads) / 132
    assert plan.longest <= plan.cap <= sum(loads) / 264 + kattn.BWD_ITEM_COST + 2


def _tiled_twin(q, k, v, out, lse, do, causal, plan):
    """Float64 ``(dq, dk, dv)`` computed the way the wgmma kernels cut the
    work: lse and delta by row-tile slot (+inf and 0 where a slot has no
    row), the dK/dV items of ``plan`` (key tile j's 128 keys against row
    tiles t0..t1, P^T masked by the column's position, its partials to
    ``slot`` or its key tile's outputs), the partials summed in chunk
    order, dQ by items of 128 rows reading the slots of their rows."""
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    f64 = torch.float64
    qd, kd, vd, od, dod, lsed = (t.to(f64) for t in (q, k, v, out, do, lse))
    scale = D ** -0.5
    gsub, npos, n_gblk, n_rt, n_pairs = plan.gsub, plan.npos, plan.n_gblk, plan.n_rt, plan.n_pairs
    T, KT = kattn.BWD_ROW_TILE, kattn.BWD_KEY_TILE
    tt, cc = np.meshgrid(np.arange(n_rt), np.arange(T), indexing="ij")
    pos = (tt // n_gblk) * npos + cc // gsub
    head = (tt % n_gblk) * gsub + cc % gsub
    real = (cc < gsub * npos) & (head < G) & (pos < S)
    colpos = np.where(np.arange(T) < gsub * npos, np.arange(T) // gsub, 1 << 30)
    lse2 = torch.full((n_pairs, n_rt, T), float("inf"), dtype=f64)
    delta = torch.zeros((n_pairs, n_rt, T), dtype=f64)
    pr, hr = torch.from_numpy(pos[real]), torch.from_numpy(head[real])
    for pair in range(n_pairs):
        b, kh = divmod(pair, K)
        lse2[pair][torch.from_numpy(real)] = lsed[b, kh, hr, pr]
        delta[pair][torch.from_numpy(real)] = (dod[b, pr, kh, hr] * od[b, pr, kh, hr]).sum(-1)

    def tile_rows(x, b, kh, t):
        rows = torch.zeros((T, D), dtype=f64)
        m = torch.from_numpy(real[t])
        rows[m] = x[b, torch.from_numpy(pos[t][real[t]]), kh, torch.from_numpy(head[t][real[t]])]
        return rows

    nan = float("nan")
    dk = torch.full(k.shape, nan, dtype=f64)
    dv = torch.full(v.shape, nan, dtype=f64)
    part = torch.full((plan.n_slots, 2, KT, D), nan, dtype=f64)
    for items in plan.cta_items:
        for j, pair, t0, t1, slot in items:
            b, kh = divmod(pair, K)
            keys = torch.arange(j * KT, (j + 1) * KT)
            kr = keys < Skv
            kt_, vt_ = torch.zeros((KT, D), dtype=f64), torch.zeros((KT, D), dtype=f64)
            kt_[kr], vt_[kr] = kd[b, keys[kr], kh], vd[b, keys[kr], kh]
            acc_k, acc_v = torch.zeros((KT, D), dtype=f64), torch.zeros((KT, D), dtype=f64)
            for t in range(t0, t1):
                qt, dot_ = tile_rows(qd, b, kh, t), tile_rows(dod, b, kh, t)
                pt = torch.exp(kt_ @ qt.T * scale - lse2[pair, t][None, :])
                if causal:
                    p0 = (t // n_gblk) * npos
                    pt[keys[:, None] > torch.from_numpy(p0 + colpos)[None, :]] = 0.0
                acc_v += pt @ dot_
                dst = pt * (vt_ @ dot_.T - delta[pair, t][None, :])
                acc_k += dst @ qt
            if slot < 0:
                dk[b, keys[kr], kh], dv[b, keys[kr], kh] = acc_k[kr] * scale, acc_v[kr]
            else:
                part[slot, 0], part[slot, 1] = acc_k, acc_v
    for jp, runs in enumerate(plan.chunks):
        if len(runs) < 2:
            continue
        j, pair = divmod(jp, n_pairs)
        b, kh = divmod(pair, K)
        keys = torch.arange(j * KT, (j + 1) * KT)
        kr = keys < Skv
        sk, sv = torch.zeros((KT, D), dtype=f64), torch.zeros((KT, D), dtype=f64)
        for c in range(len(runs)):
            sk += part[plan.first_slot[jp] + c, 0]
            sv += part[plan.first_slot[jp] + c, 1]
        dk[b, keys[kr], kh], dv[b, keys[kr], kh] = sk[kr] * scale, sv[kr]

    dq = torch.full(q.shape, nan, dtype=f64)
    npos_q = 128 // G
    for pair in range(n_pairs):
        b, kh = divmod(pair, K)
        for q0 in range(0, S, npos_q):
            p = torch.arange(q0, min(q0 + npos_q, S)).repeat_interleave(G)
            g = torch.arange(G).repeat(len(p) // G)
            t = (p // npos) * n_gblk + g // gsub
            c = (p % npos) * gsub + g % gsub
            lr, dr = lse2[pair, t, c], delta[pair, t, c]
            kv_end = min(Skv, q0 + npos_q) if causal else Skv
            keys = torch.arange(kv_end)
            s = qd[b, p, kh, g] @ kd[b, :kv_end, kh].T * scale
            pm = torch.exp(s - lr[:, None])
            if causal:
                pm[keys[None, :] > p[:, None]] = 0.0
            ds = pm * (dod[b, p, kh, g] @ vd[b, :kv_end, kh].T - dr[:, None])
            dq[b, p, kh, g] = ds @ kd[b, :kv_end, kh] * scale
    return dq, dk, dv


@pytest.mark.parametrize("B,K,S,Skv,G,causal,n_sm", [
    (1, 1, 700, 700, 1, True, 3),
    (2, 2, 130, 130, 7, True, 5),
    (1, 2, 200, 200, 12, True, 4),
    (1, 1, 70, 70, 100, True, 2),  # G > 64: two head blocks a position
    (1, 1, 100, 300, 4, False, 3),
    (1, 1, 150, 40, 4, False, 3),
    (2, 1, 100, 300, 3, True, 4),  # causal, keys no row sees
    (1, 1, 300, 129, 7, True, 2),
])
def test_flash_bwd_tiled_twin_matches_float64(monkeypatch, B, K, S, Skv, G, causal, n_sm):
    monkeypatch.setattr(kattn, "BWD_MIN_CHUNK", 1)  # segments of a few tiles at these sizes
    rng = np.random.default_rng(S * 7 + Skv + G)
    D = 16

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    q, do = bf16(B, S, K, G, D), bf16(B, S, K, G, D)
    k, v = bf16(B, Skv, K, D), bf16(B, Skv, K, D)
    out64, lse64, dq64, dk64, dv64 = attention64_grads(q, k, v, do, causal)
    plan = kattn.flash_bwd_plan(B, S, Skv, K, G, causal, n_sm)
    assert plan.n_slots > 0  # key tiles cut into chunks: the partials and their sum run
    got = _tiled_twin(q, k, v, out64, lse64, do, causal, plan)
    for name, g, want in zip("qkv", got, (dq64, dk64, dv64)):
        assert not torch.isnan(g).any(), f"d{name}: an element no item wrote"
        assert float((g - want).abs().max()) <= 1e-10 * max(float(want.abs().max()), 1.0), name
