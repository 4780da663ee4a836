"""Launch the LM attention kernels (``csrc/attention.cu``).

:func:`flash_attention` (prefill and forward; row 7 of the kernel table,
replacing the jnp ``lax.scan`` of ``repro/models/attention.py``
``flash_attention``) and :func:`decode_attention` (decode; row 8,
replacing ``decode_attention`` there) take the JAX package's
grouped-query layout.  A CPU tensor runs the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel on
the current stream or raises: a failed build or launch is never caught.
The kernels take contiguous bf16 tensors, 16-byte aligned; anything else
on the card raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

__all__ = [
    "flash_attention",
    "decode_attention",
    "flash_attention_kernel_call",
    "decode_attention_kernel_call",
    "flash_launches",
    "decode_launches",
    "FLASH_MAX_HEAD_DIM",
    "FLASH_MAX_GROUP",
    "DECODE_MAX_HEAD_DIM",
    "DECODE_MAX_GROUP",
]

#: Launches by each wrapper since the last reset to 0 (one per launch,
#: nowhere else; the decode kernel's merge pass belongs to its launch).
flash_launches = 0
decode_launches = 0

#: What the kernels take: head dim a multiple of 16 up to 128 and at most
#: 128 query heads per KV head (flash); a multiple of 8 up to 256 and at
#: most 16 query heads per KV head (decode).
FLASH_MAX_HEAD_DIM = 128
FLASH_MAX_GROUP = 128
DECODE_MAX_HEAD_DIM = 256
DECODE_MAX_GROUP = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("attention")
    lib.flash_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_fwd.restype = ctypes.c_int
    lib.decode_attn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attn.restype = ctypes.c_int
    lib.decode_attn_chunks.argtypes = [ctypes.c_int]
    lib.decode_attn_chunks.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


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


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One token per row, ``q [B, 1, K, G, D]``, against the caches
    ``[B, Smax, K, D]`` up to slot ``pos [B]`` (int32) inclusive.  On the
    CPU the plain version."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos)
    return decode_attention_kernel_call(q, k_cache, v_cache, pos)


def flash_attention_kernel_call(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Row 7 on the card: ``[B, S, K, G, D]`` bf16.  Does not synchronize."""
    global flash_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, got {dev}")
    _check_bf16(dev, q=q, k=k, v=v)
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("the flash kernel needs at least one key")
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Skv,
                           K, G, D, int(causal), D ** -0.5,
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "flash_fwd")
    flash_launches += 1
    return out


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
    chunks = lib.decode_attn_chunks(Smax)
    part_o = torch.empty((B, K, chunks, G, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, K, chunks, G, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.decode_attn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                             pos.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
                             out.data_ptr(), B, Smax, K, G, D, D ** -0.5,
                             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "decode_attn")
    decode_launches += 1
    return out
