"""The port's LM attention against the JAX package's, on the CPU.

``repro_torch.models.attention`` on CPU tensors runs the plain versions of
the CUDA kernels (``kernels/ref.py`` ``flash_attention_ref`` and
``decode_attention_ref``); they repeat the JAX math of
``repro.models.attention`` (``flash_attention``, ``decode_attention``).
Inputs are made with numpy from a seed and go through both.

Tolerances: float32 inputs within 1e-5 absolute (outputs are O(1); the
two differ only in the order of the f32 sums, measured at 2.4e-7); bf16
inputs within one bf16 ulp of the JAX output, ``2**-7 * |x|`` (both
compute in f32 and round once; measured: equal or one ulp apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as jattn
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the value
BF16_ATOL = 1e-6  # for outputs near 0

_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(seed, B, S, K, G, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32))


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


def _jax(fn, arrays, dtype, *args, **kw):
    out = fn(*(jnp.asarray(a, _J[dtype]) for a in arrays), *args, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, arrays, dtype, *args, **kw):
    out = fn(*(torch.from_numpy(a).to(_T[dtype]) for a in arrays), *args, **kw)
    assert out.dtype == _T[dtype]
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(dtype, causal):
    # S = 40 with q_block = 16: _pick_block takes 10, an awkward divisor
    arrays = _qkv(1, 2, 40, 2, 3, 32)
    kw = dict(causal=causal, q_block=16, kv_block=16)
    want = _jax(jattn.flash_attention, arrays, dtype, **kw)
    got = _port(tattn.flash_attention, arrays, dtype, **kw)
    assert got.shape == (2, 40, 2, 3, 32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_cross_lengths_match_jax(dtype):
    # the enc-dec shape: non-causal over a key axis of another length
    arrays = _qkv(2, 1, 12, 1, 4, 16, Skv=30)
    want = _jax(jattn.flash_attention, arrays, dtype, causal=False, q_block=8, kv_block=7)
    got = _port(tattn.flash_attention, arrays, dtype, causal=False, q_block=8, kv_block=7)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [[0, 13, 23], [5, 5, 5], [23, 0, 1]])
def test_decode_attention_matches_jax(dtype, pos):
    rng = np.random.default_rng(3)
    B, Smax, K, G, D = 3, 24, 2, 4, 32
    arrays = (rng.standard_normal((B, 1, K, G, D)).astype(np.float32),
              rng.standard_normal((B, Smax, K, D)).astype(np.float32),
              rng.standard_normal((B, Smax, K, D)).astype(np.float32))
    p = np.asarray(pos, np.int32)
    want = np.asarray(jattn.decode_attention(
        *(jnp.asarray(a, _J[dtype]) for a in arrays), jnp.asarray(p)).astype(jnp.float32))
    got = tattn.decode_attention(*(torch.from_numpy(a).to(_T[dtype]) for a in arrays),
                                 torch.from_numpy(p)).float().numpy()
    _close(got, want, dtype)


def test_decode_attention_reads_only_valid_slots():
    """Slots past ``pos`` may hold anything: the output does not move."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 1, 2, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 10, 1, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((2, 10, 1, 16)).astype(np.float32))
    pos = torch.tensor([3, 0], dtype=torch.int32)
    out = tattn.decode_attention(q, kc, vc, pos)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[0, 4:], vc2[0, 4:], kc2[1, 1:], vc2[1, 1:] = 1e4, -1e4, 7.0, 7.0
    assert torch.equal(tattn.decode_attention(q, kc2, vc2, pos), out)
    # pos = 0 attends to slot 0 alone: the output is v[0]
    torch.testing.assert_close(out[1, 0, 0], vc[1, 0, 0].expand(2, 16), rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    arrays = [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(5, 1, 9, 1, 2, 16)]
    kattn.flash_launches = kattn.decode_launches = 0
    ref.calls = 0
    out = kattn.flash_attention(*arrays)
    dec = kattn.decode_attention(arrays[0][:, :1], arrays[1], arrays[2],
                                 torch.tensor([4], dtype=torch.int32))
    assert out.shape == arrays[0].shape and dec.shape == (1, 1, 1, 2, 16)
    assert ref.calls == 2
    assert kattn.flash_launches == 0 and kattn.decode_launches == 0
    torch.testing.assert_close(out, ref.flash_attention_ref(*arrays), rtol=0, atol=0)


def test_kernel_calls_refuse_cpu_tensors():
    arrays = [torch.zeros((1, 4, 1, 2, 16), dtype=torch.bfloat16),
              torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16),
              torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="CUDA"):
        kattn.flash_attention_kernel_call(*arrays)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.decode_attention_kernel_call(arrays[0][:, :1], arrays[1], arrays[2],
                                           torch.zeros(1, dtype=torch.int32))


def test_backend_ref_and_unported_attention():
    """The model's attention is the kernels' wrappers (on the CPU, the
    plain versions bit for bit; ``flash_attention_fused``'s forward too);
    ``local_attention`` (ported with the hybrid family) is row 13's
    wrapper, on the CPU its plain version, within float32 rounding of
    JAX's."""
    arrays = [torch.from_numpy(a) for a in _qkv(6, 1, 8, 1, 2, 16)]
    assert tattn.flash_attention is kattn.flash_attention
    assert tattn.decode_attention is kattn.decode_attention
    torch.testing.assert_close(ref.flash_attention_ref(*arrays),
                               tattn.flash_attention(*arrays), rtol=0, atol=0)
    torch.testing.assert_close(ref.flash_attention_ref(*arrays),
                               tattn.flash_attention_fused(*arrays), rtol=0, atol=0)
    assert tattn.local_attention is kattn.local_attention
    local = tattn.local_attention(*arrays, window=4)
    torch.testing.assert_close(ref.local_attention_ref(*arrays, 4), local, rtol=0, atol=0)
    want = jattn.local_attention(*(jnp.asarray(a.numpy()) for a in arrays), window=4)
    np.testing.assert_allclose(local.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)


def test_yardstick_holds_each_row_to_its_own_scale():
    """The card tests' rule (``kernel_within_yardstick``) is per output
    row: an attention whose long rows come out 3 % too large (a wrong
    rescale late in the scan) moves them by less than the error the whole
    output allows at its largest value (the early rows, which see few
    keys), yet is refused row by row."""
    from tests._torch_parity import attention64, bf16_ulp, kernel_within_yardstick

    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(11, 1, 2049, 1, 2, 128))
    want = attention64(q, k, v)
    plain = ref.flash_attention_ref(q, k, v, True, 512, 1024)
    assert kernel_within_yardstick(plain, plain, want)[0]
    wrong = want.clone()
    wrong[:, 1024:] *= 1 + 2.0 ** -5
    wrong = wrong.to(torch.bfloat16)
    whole_err = float((wrong.double() - want).abs().max())
    whole_limit = 2 * float((plain.double() - want).abs().max()) + bf16_ulp(want.abs().max())
    assert whole_err <= whole_limit  # one limit for the whole output lets it through
    ok, err_k, err_p, worst = kernel_within_yardstick(wrong, plain, want)
    assert not ok and worst["row"][1] >= 1024, worst


def _flash_bf16_p(q, k, v, causal=True, tile=128):
    """The wgmma flash kernel's arithmetic on the CPU: float32 scores and
    softmax over key tiles of ``tile``, the running max per tile, and P
    rounded once to bf16 where it meets V (one product, no high and low
    parts), the output rounded to bf16 once."""
    B, S, K, G, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, K, G, S), -1e30)
    l = torch.zeros((B, K, G, S))
    acc = torch.zeros((B, K, G, S, D))
    qpos = torch.arange(S)
    for k0 in range(0, Skv, tile):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k0 + tile]) * D ** -0.5
        if causal:
            kpos = torch.arange(k0, min(k0 + tile, Skv))
            s = torch.where(qpos[:, None] >= kpos[None, :], s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(torch.bfloat16).float(), vf[:, k0:k0 + tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4).to(torch.bfloat16)


def test_single_bf16_product_of_p_meets_the_card_rule():
    """The flash kernel multiplies P by V once, with P in bf16 (the first
    kernel split P into two bf16 parts).  Emulated at a causal S = 1,000
    with qwen2-7b's G = 7 and D = 128, it stays within the card check's
    per-row rule against float64: twice the plain version's error plus one
    bf16 ulp at the row's max |out|."""
    from tests._torch_parity import attention64, kernel_within_yardstick

    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(12, 1, 1000, 1, 7, 128))
    want = attention64(q, k, v)
    plain = ref.flash_attention_ref(q, k, v, True, 512, 1024)
    ok, err_k, err_p, worst = kernel_within_yardstick(_flash_bf16_p(q, k, v), plain, want)
    assert ok, (err_k, err_p, worst)
    # the emulation is not the plain version: P's rounding shows
    assert not torch.equal(_flash_bf16_p(q, k, v), plain)


def _split_ranges(pos, Smax, split_len):
    """The slots ``[start, end)`` each split of a row reads, as
    ``csrc/attention.cu`` ``decode_attn_kernel`` cuts them: the valid slots
    ``s <= pos`` (all ``Smax``, masked, where ``pos < 0``) in runs of
    ``split_len``; a split that starts past them exits at once."""
    n_valid = Smax if pos < 0 else min(pos + 1, Smax)
    return [(s, min(s + split_len, n_valid)) for s in range(0, n_valid, split_len)]


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("Smax", [1, 16, 17, 300, 2112, 5000])
@pytest.mark.parametrize("resident", [1, 132 * 3, 132 * 16])
def test_decode_split_plan_covers_every_valid_slot_once(B, Smax, resident):
    """The decode kernel's splits: every valid slot in exactly one split,
    none past ``pos``, no more than the card holds at once where it holds
    one split a pair, lengths in whole stages."""
    K = 4
    n_splits, split_len = kattn.decode_split_plan(B, K, Smax, resident)
    assert 1 <= n_splits <= kattn.DECODE_MAX_SPLITS
    assert split_len % kattn.DECODE_GROUP == 0 and n_splits * split_len >= Smax
    assert (n_splits - 1) * split_len < Smax  # no split wholly past the cache
    if resident >= B * K:
        assert B * K * n_splits <= max(resident, B * K)
    for pos in {-1, 0, Smax // 2, Smax - 1, Smax + 5}:
        n_valid = Smax if pos < 0 else min(pos + 1, Smax)
        ranges = _split_ranges(pos, Smax, split_len)
        assert len(ranges) <= n_splits
        covered = [s for a, b in ranges for s in range(a, b)]
        assert covered == list(range(n_valid))  # each valid slot once, in order
        assert all(a < b <= n_valid and a % split_len == 0 for a, b in ranges)
