"""Launch the LM attention kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``).

:func:`flash_attention` (prefill and forward; row 7 of the kernel table,
replacing the jnp ``lax.scan`` of ``repro/models/attention.py``
``flash_attention``) and :func:`decode_attention` (decode; row 8,
replacing ``decode_attention`` there) take the JAX package's
grouped-query layout.  Training takes :func:`flash_attention_fwd` (row 7
that also writes each row's log-sum-exp, the forward of
``flash_attention_fused``) and :func:`flash_attention_bwd` (row 9,
replacing the jnp ``_flash_fused_bwd``).  A CPU tensor runs the plain
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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = [
    "flash_attention",
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
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else; the decode kernel's merge pass belongs to its launch, and
#: the backward's three passes to its one).
flash_launches = 0
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

_LIB: ctypes.CDLL | None = None
_BWD_LIB: ctypes.CDLL | None = None
_decode_fill: dict[tuple[int, int], int] = {}  # (device, D) -> SMs x blocks an SM holds
# (device, stream) -> int32 tickets, zero between launches; outgrown ones are
# kept in _retired for the graphs that captured them
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []


def _lib() -> ctypes.CDLL:
    """The library, with its signatures set when it is first loaded."""
    global _LIB
    if _LIB is None:
        lib = build.load("attention")
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
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
        lib.flash_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd.restype = ctypes.c_int
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


def _check_flash_shapes(q, k, v) -> None:
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"q must be [B, S, K, G, D] and k, v [B, Skv, K, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    if k.shape != (B, Skv, K, D) or v.shape != k.shape:
        raise ValueError(f"k, v must be [{B}, Skv, {K}, {D}], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if D % 16 or not 16 <= D <= FLASH_MAX_HEAD_DIM or G > FLASH_MAX_GROUP:
        raise ValueError(f"the flash kernel takes D a multiple of 16 up to "
                         f"{FLASH_MAX_HEAD_DIM} and G <= {FLASH_MAX_GROUP}, got D={D}, G={G}")
    if Skv == 0 and q.numel():
        raise ValueError("the flash kernel needs at least one key")


def flash_attention_kernel_call(q, k, v, *, causal: bool = True, want_lse: bool = False):
    """Row 7 on the card: ``[B, S, K, G, D]`` bf16, and with ``want_lse``
    also ``lse [B, K, G, S]`` float32 (``(out, lse)``).  Does not
    synchronize."""
    global flash_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, got {dev}")
    _check_bf16(dev, q=q, k=k, v=v)
    _check_flash_shapes(q, k, v)
    B, S, K, G, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=dev) if want_lse else None
    if out.numel():
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               0 if lse is None else lse.data_ptr(), B, S, k.shape[1], K, G, D,
                               int(causal), D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, rc, "flash_fwd")
        flash_launches += 1
    return (out, lse) if want_lse else out


def flash_attention_bwd_kernel_call(q, k, v, out, lse, do, *, causal: bool = True):
    """Row 9 on the card: ``(dq [B, S, K, G, D], dk, dv [B, Skv, K, D])``
    bf16 from the forward's ``out`` (bf16, like ``q``) and ``lse [B, K, G,
    S]`` (float32) and the output's gradient ``do`` (bf16, like ``q``).
    Three passes in one call (``delta``, then dK and dV, then dQ), which
    counts one launch.  Deterministic: no atomics.  Does not synchronize."""
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
    delta = torch.empty((B, K, G, S), dtype=torch.float32, device=dev)  # rowsum(dO * O)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), B, S, k.shape[1], K, G, D, int(causal),
                           D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
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
