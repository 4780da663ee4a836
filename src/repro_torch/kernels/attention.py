"""Launch the LM attention kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``).

:func:`flash_attention` (prefill and forward; row 7 of the kernel table,
replacing the jnp ``lax.scan`` of ``repro/models/attention.py``
``flash_attention``) and :func:`decode_attention` (decode; row 8,
replacing ``decode_attention`` there) take the JAX package's
grouped-query layout, as does :func:`local_attention` (the hybrid family's
sliding-window prefill; row 13, replacing ``local_attention`` there: row
7's kernel with a window, at head dims up to 128 and 256).  Training
takes :func:`flash_attention_fwd` (row 7 that also writes each row's
log-sum-exp, the forward of ``flash_attention_fused``) and
:func:`flash_attention_bwd` (row 9, replacing the jnp
``_flash_fused_bwd``).  A CPU tensor runs the plain
version (:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the
kernel on the current stream or raises: a failed build or launch is never
caught.  The kernels take contiguous bf16 tensors, 16-byte aligned, and
``lse`` contiguous float32; anything else on the card raises
``ValueError``.

The decode kernel cuts each (row, KV head) pair's cache slots into splits
(:func:`decode_split_plan`: as many as fill the card in one wave) and
merges them in the same launch, in the last block of each pair to finish,
which it knows by a ticket counter per pair.  The tickets are zero between
launches and one buffer per stream, so launches that share one run one
after another; a buffer outgrown by more pairs is kept, never freed, as a
CUDA graph that captured a launch goes on using it.  A capture must follow
an uncaptured launch on its stream at least as large (the buffer is zeroed
outside the capture), else it raises.  A graph replays with its capture
stream's tickets: do not replay it while a launch on that stream runs.

The backward for head dims 64 and 128 runs its dK/dV pass over a plan
(:func:`flash_bwd_plan`): the row tiles each (key tile, pair) meets, laid
end to end and cut into two segments of equal cost for each of the card's
SMs, so that the causal mask's uneven runs finish together.
The plan is made on the host once per shape and device and kept on the
device (never freed, as a CUDA graph that captured a launch reads it), so
a capture must follow an uncaptured launch of its shape, else it raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = [
    "flash_attention",
    "local_attention",
    "local_launches",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "decode_attention",
    "flash_attention_kernel_call",
    "flash_attention_bwd_kernel_call",
    "decode_attention_kernel_call",
    "flash_launches",
    "flash_bwd_launches",
    "decode_launches",
    "FLASH_MAX_HEAD_DIM",
    "FLASH_MAX_GROUP",
    "DECODE_MAX_HEAD_DIM",
    "DECODE_MAX_GROUP",
    "DECODE_GROUP",
    "DECODE_MAX_SPLITS",
    "decode_plan",
    "decode_split_plan",
    "BWD_KEY_TILE",
    "BWD_ROW_TILE",
    "BWD_ITEM_INTS",
    "BWD_WGMMA_HEAD_DIMS",
    "BWD_MIN_CHUNK",
    "BWD_ITEM_COST",
    "FlashBwdPlan",
    "flash_bwd_row_tiles",
    "flash_bwd_plan",
    "flash_bwd_plan_table",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else; the decode kernel's merge pass belongs to its launch, and
#: the backward's three passes to its one).
flash_launches = 0
local_launches = 0
flash_bwd_launches = 0
decode_launches = 0

#: What the kernels take: head dim a multiple of 16 up to 128 and at most
#: 128 query heads per KV head (flash); a multiple of 8 up to 256 and at
#: most 16 query heads per KV head (decode).
FLASH_MAX_HEAD_DIM = 128
FLASH_MAX_GROUP = 128
DECODE_MAX_HEAD_DIM = 256
DECODE_MAX_GROUP = 16
#: Cache slots of a decode stage (a split's length is a multiple), and the
#: most splits of a pair: the kernel's ``kDcGroup`` and ``kDcMaxSplits``,
#: checked against the library's own when it first plans on a device.
DECODE_GROUP = 16
DECODE_MAX_SPLITS = 128
#: The backward's wgmma geometry (``csrc/attention_bwd.cu``: ``kBwKeys``,
#: ``kBwRows``, ``kItemInts``), checked against the library's own when it
#: first plans: keys of a dK/dV work item, rows of a row tile, and the ints
#: of a planned item in the device table.
BWD_KEY_TILE = 128
BWD_ROW_TILE = 64
BWD_ITEM_INTS = 5
#: Head dims whose backward runs the wgmma kernels over a plan; the others
#: run the mma.sync kernels, which need none.
BWD_WGMMA_HEAD_DIMS = (64, 128)
#: What an item of the dK/dV pass costs besides its row tiles, in row tiles:
#: loading its K and V and writing its dK and dV, about two row tiles'
#: products on the H100.
BWD_ITEM_COST = 2
#: The fewest row tiles of a segment of the plan: below, fewer CTAs.
BWD_MIN_CHUNK = 8

_LIB: ctypes.CDLL | None = None
_BWD_LIB: ctypes.CDLL | None = None
_decode_fill: dict[tuple[int, int], int] = {}  # (device, D) -> SMs x blocks an SM holds
# (device, stream) -> int32 tickets, zero between launches; outgrown ones are
# kept in _retired for the graphs that captured them
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []
# D -> the backward library's geometry, once checked
_bwd_checked: set[int] = set()
# (device, B, S, Skv, K, G, causal) -> the dK/dV plan and its int32 table on the device
_bwd_plans: dict[tuple, tuple["FlashBwdPlan", torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    """The library, with its signatures set when it is first loaded."""
    global _LIB
    if _LIB is None:
        lib = build.load("attention")
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.decode_attn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.decode_attn.restype = ctypes.c_int
        lib.decode_attn_geometry.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.decode_attn_geometry.restype = ctypes.c_int
        lib.attention_error_string.argtypes = [ctypes.c_int]
        lib.attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = build.load("attention_bwd")
        lib.flash_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                  + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_bwd.restype = ctypes.c_int
        lib.flash_bwd_geometry.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.flash_bwd_geometry.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


def decode_split_plan(B: int, K: int, Smax: int, resident_blocks: int) -> tuple[int, int]:
    """``(n_splits, split_len)`` for the decode kernel: each of the ``B * K``
    pairs' ``Smax`` slots cut into ``n_splits`` splits of ``split_len``
    slots (a multiple of :data:`DECODE_GROUP`), as many as keep every block
    of the grid resident at once (``resident_blocks``: SMs times the blocks
    an SM holds), at least 1 and at most :data:`DECODE_MAX_SPLITS`, with no
    split wholly past ``Smax``."""
    groups = -(-Smax // DECODE_GROUP)
    n = max(1, min(resident_blocks // (B * K), DECODE_MAX_SPLITS, groups))
    split_len = -(-groups // n) * DECODE_GROUP
    return -(-Smax // split_len), split_len


def decode_plan(device, B: int, K: int, Smax: int, D: int) -> tuple[int, int]:
    """:func:`decode_split_plan` on a CUDA ``device``: its SMs times the
    decode blocks of head dim ``D`` that one SM holds (asked of the kernel
    once per device and ``D``, with its stage and most splits, which must
    be :data:`DECODE_GROUP` and :data:`DECODE_MAX_SPLITS`)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    fill = _decode_fill.get((idx, D))
    if fill is None:
        lib = _lib()
        per_sm, group, max_splits = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(idx):
            _raise_on(lib, lib.decode_attn_geometry(D, ctypes.byref(per_sm), ctypes.byref(group),
                                                    ctypes.byref(max_splits)), "decode_attn")
        if (group.value, max_splits.value) != (DECODE_GROUP, DECODE_MAX_SPLITS):
            raise RuntimeError(f"the decode kernel's stage and most splits are "
                               f"{group.value}, {max_splits.value}; the wrapper plans with "
                               f"{DECODE_GROUP}, {DECODE_MAX_SPLITS}")
        fill = _decode_fill[(idx, D)] = (
            torch.cuda.get_device_properties(idx).multi_processor_count * max(per_sm.value, 1))
    return decode_split_plan(B, K, Smax, fill)


class FlashBwdPlan(NamedTuple):
    """The dK/dV pass's work for one shape (:func:`flash_bwd_plan`).

    Row tiles are ``npos`` positions by ``gsub`` heads of one pair (``b``,
    KV head), ``n_rt`` a pair; key tile ``j`` is keys ``128 j`` on, ``n_kt``
    of them.  ``chunks[j * n_pairs + pair]`` are the ``[t0, t1)`` runs of
    row tiles that key tile ``j`` of ``pair`` is cut into, in row order
    (the order their partials are summed in), and ``first_slot`` at the
    same index its first partial slot, or -1 where it is one chunk (whose
    item writes dK and dV itself).  ``cta_items[c]`` are CTA ``c``'s items
    in the order it walks them, each ``(j, pair, t0, t1, slot)``, ``slot =
    first_slot + chunk`` or -1.  ``cap`` bounds every item's row tiles."""

    gsub: int
    npos: int
    n_gblk: int
    n_rt: int
    n_kt: int
    n_pairs: int
    cap: int
    chunks: tuple
    first_slot: tuple
    n_slots: int
    cta_items: tuple

    @property
    def n_cta(self) -> int:
        return len(self.cta_items)

    @property
    def n_items(self) -> int:
        return sum(len(c) for c in self.cta_items)

    @property
    def longest(self) -> int:
        """Row tiles of the longest item."""
        return max(t1 - t0 for c in self.cta_items for _, _, t0, t1, _ in c)

    @property
    def loads(self) -> list[int]:
        """Each CTA's cost: its row tiles plus :data:`BWD_ITEM_COST` an item."""
        return [sum(t1 - t0 + BWD_ITEM_COST for _, _, t0, t1, _ in c) for c in self.cta_items]

    def workspace_floats(self, D: int) -> int:
        """Float32s of the kernel's workspace: lse2 and delta by row tile,
        then the partial dK and dV of every slot."""
        return 2 * self.n_pairs * self.n_rt * BWD_ROW_TILE + self.n_slots * 2 * BWD_KEY_TILE * D


def flash_bwd_row_tiles(S: int, G: int) -> tuple[int, int, int, int]:
    """``(gsub, npos, n_gblk, n_rt)``: the backward's row tiles of ``S``
    positions with ``G`` query heads a KV head, ``gsub = min(G, 64)`` heads
    by ``npos = 64 // gsub`` positions each (one TMA box), ``n_gblk`` tiles
    across the heads of a position block, ``n_rt`` tiles a pair."""
    gsub = min(G, BWD_ROW_TILE)
    npos = BWD_ROW_TILE // gsub
    n_gblk = -(-G // gsub)
    return gsub, npos, n_gblk, -(-S // npos) * n_gblk


def flash_bwd_plan(B: int, S: int, Skv: int, K: int, G: int, causal: bool,
                   n_sm: int) -> FlashBwdPlan:
    """The dK/dV pass's plan on a card of ``n_sm`` SMs.

    Key tile ``j`` of each pair meets the row tiles from the first that
    holds a position ``>= 128 j`` (causal; all of them otherwise) to the
    last, so under the causal mask the runs shrink with ``j``.  The runs
    of every (key tile, pair), one after another, are cut into two
    segments a CTA of equal cost (row tiles, plus :data:`BWD_ITEM_COST` for
    each piece, which loads its K and V and writes its dK and dV): a run
    cut at a segment's end becomes two chunks.  So no item is longer than
    about half a CTA's share (``cap``), and every CTA gets the same cost to
    within a row tile or two.  CTA ``c`` takes segments ``c`` and ``c +
    n_cta`` and walks their items longest first.  The CTAs are at most
    ``n_sm`` and as many as give each segment :data:`BWD_MIN_CHUNK` row
    tiles."""
    gsub, npos, n_gblk, n_rt = flash_bwd_row_tiles(S, G)
    n_kt = -(-Skv // BWD_KEY_TILE)
    n_pairs = B * K

    def first(j):
        k0 = j * BWD_KEY_TILE
        return n_rt if k0 >= S else (k0 // npos) * n_gblk

    runs = [(j, pair, first(j) if causal else 0) for j in range(n_kt) for pair in range(n_pairs)]
    work = sum(n_rt - lo + BWD_ITEM_COST for _, _, lo in runs)
    n_cta = max(1, min(n_sm, work // (2 * (BWD_MIN_CHUNK + BWD_ITEM_COST))))
    n_seg = 2 * n_cta
    total = work + BWD_ITEM_COST * (n_seg - 1)  # a cut at each segment's end adds one item
    cap = -(-total // n_seg) + BWD_ITEM_COST + 1
    segs = [[] for _ in range(n_seg)]
    s, cum = 0, 0  # the segment being filled; the cost so far
    for j, pair, lo in runs:
        t = lo
        while True:
            # cost left in segment s before its end (s + 1) total / n_seg, in
            # units of 1 / n_seg, after this piece's own
            room = (s + 1) * total - (cum + BWD_ITEM_COST) * n_seg
            if segs[s] and room < n_seg and s < n_seg - 1:
                s += 1
                continue
            take = n_rt - t  # the last segment takes what is left
            if s < n_seg - 1:  # else the room, rounded, at least one tile
                take = min(take, max(1, (2 * room + n_seg) // (2 * n_seg)))
            segs[s].append((j, pair, t, t + take))
            cum += take + BWD_ITEM_COST
            t += take
            if t >= n_rt:
                break
    pieces: dict[tuple[int, int], list] = {}
    for seg in segs:
        for j, pair, t0, t1 in seg:
            pieces.setdefault((j, pair), []).append((t0, t1))
    chunks, first_slot, n_slots = [], [], 0
    for j in range(n_kt):
        for pair in range(n_pairs):
            runs_jp = tuple(pieces[(j, pair)])
            chunks.append(runs_jp)
            first_slot.append(n_slots if len(runs_jp) > 1 else -1)
            n_slots += len(runs_jp) if len(runs_jp) > 1 else 0
    cta_items = [[] for _ in range(n_cta)]
    for i, seg in enumerate(segs):
        for j, pair, t0, t1 in seg:
            fs = first_slot[j * n_pairs + pair]
            slot = -1 if fs < 0 else fs + chunks[j * n_pairs + pair].index((t0, t1))
            cta_items[i % n_cta].append((j, pair, t0, t1, slot))
    # longest first; a CTA left without items (the cuts' cost was estimated
    # high) is not launched
    cta_items = [sorted(c, key=lambda it: it[2] - it[3]) for c in cta_items if c]
    if max(t1 - t0 for c in cta_items for _, _, t0, t1, _ in c) > cap:
        raise AssertionError("flash_bwd_plan cut an item past its cap")
    return FlashBwdPlan(gsub, npos, n_gblk, n_rt, n_kt, n_pairs, cap, tuple(chunks),
                        tuple(first_slot), n_slots, tuple(tuple(c) for c in cta_items))


def flash_bwd_plan_table(plan: FlashBwdPlan) -> np.ndarray:
    """The plan as the kernel reads it, int32: ``n_cta + 1`` offsets of
    each CTA's first item, the items (:data:`BWD_ITEM_INTS` each), then
    ``(n_chunks, first_slot)`` of each (key tile, pair), pair fastest."""
    offsets = np.cumsum([0] + [len(c) for c in plan.cta_items])
    items = np.array([it for c in plan.cta_items for it in c], dtype=np.int64).reshape(-1)
    kt = np.array([(len(ch), fs) for ch, fs in zip(plan.chunks, plan.first_slot)],
                  dtype=np.int64).reshape(-1)
    table = np.concatenate([offsets, items, kt])
    if table.size and (table.max() > np.iinfo(np.int32).max or table.min() < -1):
        raise ValueError("the backward's plan does not fit int32")
    return table.astype(np.int32)


def _bwd_plan(dev: torch.device, B: int, S: int, Skv: int, K: int, G: int, D: int,
              causal: bool) -> tuple[FlashBwdPlan, torch.Tensor]:
    """The plan of this shape on ``dev`` and its table there, made once
    (the library's geometry checked once per head dim first)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if D not in _bwd_checked:
        lib = _bwd_lib()
        got = [ctypes.c_int(0) for _ in range(4)]
        _raise_on(_lib(), lib.flash_bwd_geometry(D, *(ctypes.byref(g) for g in got)),
                  "flash_bwd")
        want = (BWD_KEY_TILE, BWD_ROW_TILE, BWD_ITEM_INTS, int(D in BWD_WGMMA_HEAD_DIMS))
        if tuple(g.value for g in got) != want:
            raise RuntimeError(f"the backward kernel's key tile, row tile, item ints and "
                               f"wgmma flag are {tuple(g.value for g in got)}; the wrapper "
                               f"plans with {want}")
        _bwd_checked.add(D)
    key = (idx, B, S, Skv, K, G, bool(causal))
    found = _bwd_plans.get(key)
    if found is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured flash_bwd launch needs an uncaptured one of the same "
                               f"shape before it on this device, got {key[1:]}")
        plan = flash_bwd_plan(B, S, Skv, K, G, causal,
                              torch.cuda.get_device_properties(idx).multi_processor_count)
        table = torch.from_numpy(flash_bwd_plan_table(plan)).to(torch.device("cuda", idx))
        found = _bwd_plans[key] = (plan, table)
    return found


def _check_bf16(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on {dev}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.attention_error_string(rc).decode()}")


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024) -> torch.Tensor:
    """Attention of ``q [B, S, K, G, D]`` over ``k``/``v [B, Skv, K, D]``
    (causal: key ``j`` is seen by query ``i`` iff ``j <= i``).  On the CPU
    the plain version, whose blocks ``q_block``/``kv_block`` pick; the
    kernel tiles by itself and ignores them."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, q_block, kv_block)
    return flash_attention_kernel_call(q, k, v, causal=causal)


def local_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Sliding-window causal attention of ``q [B, S, K, G, D]`` over
    ``k``/``v [B, S, K, D]``: key ``j`` is seen by query ``i`` iff ``i -
    window < j <= i``.  On the CPU the plain version."""
    if q.device.type == "cpu":
        return _ref.local_attention_ref(q, k, v, window)
    return flash_attention_kernel_call(q, k, v, window=window)


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_block: int = 512,
                        kv_block: int = 1024):
    """:func:`flash_attention` and each row's log-sum-exp: ``(out, lse)``,
    ``lse [B, K, G, S]`` float32 in natural log units (the forward of
    ``flash_attention_fused``).  On the CPU the plain version."""
    if q.device.type == "cpu":
        return _ref.flash_attention_fwd_ref(q, k, v, causal, q_block, kv_block)
    return flash_attention_kernel_call(q, k, v, causal=causal, want_lse=True)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True, q_block: int = 512,
                        kv_block: int = 1024):
    """``(dq, dk, dv)`` of the attention whose forward gave ``out`` and
    ``lse`` (:func:`flash_attention_fwd`), for the output's gradient ``do``,
    in the inputs' dtypes.  On the CPU the plain version, whose blocks
    ``q_block``/``kv_block`` pick; the kernel tiles by itself."""
    if q.device.type == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, q_block, kv_block)
    return flash_attention_bwd_kernel_call(q, k, v, out, lse, do, causal=causal)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One token per row, ``q [B, 1, K, G, D]``, against the caches
    ``[B, Smax, K, D]`` up to slot ``pos [B]`` (int32) inclusive.  On the
    CPU the plain version."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos)
    return decode_attention_kernel_call(q, k_cache, v_cache, pos)


def _check_flash_shapes(q, k, v, windowed: bool = False) -> None:
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"q must be [B, S, K, G, D] and k, v [B, Skv, K, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, K, D) or v.shape != k.shape:
        raise ValueError(f"k, v must be [{B}, Skv, {K}, {D}], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if windowed:
        if D % 16 or (not 16 <= D <= FLASH_MAX_HEAD_DIM and D != 256) or G > FLASH_MAX_GROUP:
            raise ValueError(f"the windowed flash kernel takes D a multiple of 16 up to "
                             f"{FLASH_MAX_HEAD_DIM}, or 256, and G <= {FLASH_MAX_GROUP}, "
                             f"got D={D}, G={G}")
        if Skv != S:
            raise ValueError(f"local attention takes keys of the queries' length {S}, got "
                             f"{Skv}")
    elif D % 16 or not 16 <= D <= FLASH_MAX_HEAD_DIM or G > FLASH_MAX_GROUP:
        raise ValueError(f"the flash kernel takes D a multiple of 16 up to "
                         f"{FLASH_MAX_HEAD_DIM} and G <= {FLASH_MAX_GROUP}, got D={D}, G={G}")
    if Skv == 0 and q.numel():
        raise ValueError("the flash kernel needs at least one key")


def flash_attention_kernel_call(q, k, v, *, causal: bool = True, want_lse: bool = False,
                                window: int | None = None):
    """Row 7 on the card: ``[B, S, K, G, D]`` bf16, and with ``want_lse``
    also ``lse [B, K, G, S]`` float32 (``(out, lse)``).  With a ``window``
    (``>= 1``) row 13, the same kernel windowed: causal, ``k``/``v`` of
    ``q``'s length, D up to 128 or 256, counted in ``local_launches``; no
    input may require grad, as row 13 has no backward yet (hybrid training
    is ROADMAP queue 1, LM item 9).  Does not synchronize."""
    global flash_launches, local_launches
    dev = q.device
    what = "flash attention" if window is None else "local attention"
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel needs CUDA tensors, got {dev}")
    if window is not None:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "row 13 has no backward yet: hybrid training is ROADMAP queue 1, LM item 9")
        if int(window) < 1:
            raise ValueError(f"window must be at least 1, got {window}")
    _check_bf16(dev, q=q, k=k, v=v)
    _check_flash_shapes(q, k, v, windowed=window is not None)
    B, S, K, G, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=dev) if want_lse else None
    if out.numel():
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               0 if lse is None else lse.data_ptr(), B, S, k.shape[1], K, G, D,
                               int(causal),
                               0 if window is None else min(int(window), S), D ** -0.5,
                               torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, rc, "flash_fwd" if window is None else "flash_fwd (window)")
        if window is None:
            flash_launches += 1
        else:
            local_launches += 1
    return (out, lse) if want_lse else out


def flash_attention_bwd_kernel_call(q, k, v, out, lse, do, *, causal: bool = True):
    """Row 9 on the card: ``(dq [B, S, K, G, D], dk, dv [B, Skv, K, D])``
    bf16 from the forward's ``out`` (bf16, like ``q``) and ``lse [B, K, G,
    S]`` (float32) and the output's gradient ``do`` (bf16, like ``q``).
    One call counts one launch; it does not synchronize.

    Head dims 64 and 128 run four wgmma/TMA kernels
    (``csrc/attention_bwd.cu``): lse in base 2 and ``delta = rowsum(dO *
    O)`` by row tile; dK and dV on persistent CTAs over
    :func:`flash_bwd_plan` (128 keys of one (b, KV head) pair against a run
    of its row tiles an item, every CTA the same cost), whose cut runs
    write f32 partials; their sum in chunk order; dQ on persistent CTAs,
    128 rows an item.  The dK/dV pass is bound by its four products on the
    tensor cores, the dQ pass by its three.  Other head dims run the three
    ``mma.sync`` kernels.  One ``torch.empty`` holds the workspace.
    Deterministic: every output and partial is summed by one thread in a
    fixed order and the partials in chunk order, with no atomics, so two
    launches agree bit for bit (a CUDA graph too: a capture must follow an
    uncaptured launch of its shape, as the plan is made then).  A failed
    build or launch raises."""
    global flash_bwd_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention backward kernel needs CUDA tensors, got {dev}")
    _check_bf16(dev, q=q, k=k, v=v, out=out, do=do)
    _check_flash_shapes(q, k, v)
    B, S, K, G, D = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out and do must be {tuple(q.shape)}, got {tuple(out.shape)}, "
                         f"{tuple(do.shape)}")
    if (lse.device != dev or lse.dtype != torch.float32 or lse.shape != (B, K, G, S)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 [{B}, {K}, {G}, {S}] on {dev}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    Skv = k.shape[1]
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        if D in BWD_WGMMA_HEAD_DIMS:
            plan, table = _bwd_plan(dev, B, S, Skv, K, G, D, causal)
            work = torch.empty(plan.workspace_floats(D), dtype=torch.float32, device=dev)
            plan_ptr, n_cta, n_items = table.data_ptr(), plan.n_cta, plan.n_items
        else:  # delta [B, K, G, S] = rowsum(dO * O)
            work = torch.empty((B, K, G, S), dtype=torch.float32, device=dev)
            plan_ptr, n_cta, n_items = 0, 0, 0
        rc = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), work.data_ptr(), plan_ptr, n_cta,
                           n_items, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, Skv, K, G,
                           D, int(causal), D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(_lib(), rc, "flash_bwd")
    flash_bwd_launches += 1
    return dq, dk, dv


def decode_attention_kernel_call(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Row 8 on the card: ``[B, 1, K, G, D]`` bf16.  Does not synchronize."""
    global decode_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the decode attention kernel needs CUDA tensors, got {dev}")
    _check_bf16(dev, q=q, k_cache=k_cache, v_cache=v_cache)
    if q.ndim != 5 or q.shape[1] != 1 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B, 1, K, G, D] and the caches [B, Smax, K, D], "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, _, K, G, D = q.shape
    Smax = k_cache.shape[1]
    if k_cache.shape != (B, Smax, K, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"the caches must be [{B}, Smax, {K}, {D}], got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if (pos.device != dev or pos.dtype != torch.int32 or pos.shape != (B,)
            or not pos.is_contiguous()):
        raise ValueError(f"pos must be contiguous int32 [{B}] on {dev}")
    if D % 8 or not 8 <= D <= DECODE_MAX_HEAD_DIM or G > DECODE_MAX_GROUP:
        raise ValueError(f"the decode kernel takes D a multiple of 8 up to "
                         f"{DECODE_MAX_HEAD_DIM} and G <= {DECODE_MAX_GROUP}, got D={D}, G={G}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Smax == 0:
        raise ValueError("the decode kernel needs at least one cache slot")
    lib = _lib()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n_splits, split_len = decode_plan(dev, B, K, Smax, D)
    stream = torch.cuda.current_stream(dev)
    tickets = _tickets.get((idx, stream.cuda_stream))
    if tickets is None or tickets.numel() < B * K:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a captured decode launch needs an uncaptured one before it on "
                               f"the capture stream with at least {B * K} (row, KV head) pairs")
        if tickets is not None:
            _retired.append(tickets)
        tickets = _tickets[(idx, stream.cuda_stream)] = torch.zeros(
            max(B * K, 1024), dtype=torch.int32, device=dev)
    # one workspace: the splits' partial outputs [B, K, n_splits, G, D], then
    # their (max, sum) [B, K, n_splits, G, 2], both f32
    n_part = B * K * n_splits * G * D
    work = torch.empty(n_part + 2 * B * K * n_splits * G, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.decode_attn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                             pos.data_ptr(), work.data_ptr(), work.data_ptr() + 4 * n_part,
                             tickets.data_ptr(), out.data_ptr(), B, Smax, K, G, D, n_splits,
                             split_len, D ** -0.5, stream.cuda_stream)
    _raise_on(lib, rc, "decode_attn")
    decode_launches += 1
    return out
