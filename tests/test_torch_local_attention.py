"""The port's sliding-window attention (row 13's plain version,
``kernels/ref.py`` ``local_attention_ref``, behind
``repro_torch.kernels.attention.local_attention``) and the hybrid decoder's
prefill and decode against the JAX package, on the CPU, at
``get_reduced("recurrentgemma_9b")`` (window 64, 1 KV head, 4 query heads of
32, layers rglru, rglru, local, rglru).

Inputs come from numpy with a seed; JAX's ``init_decoder`` parameters are
carried over by ``params_from_jax``.

Tolerances, and why:

* ``local_attention`` in float32 within 1e-5 absolute (inputs O(1); the
  same blocks and float32 scores, sums and softmax in another order), in
  bf16 within one bf16 ulp of each value (both round the float32 result
  once); both within 1e-5 of a float64 band attention (float32 inputs);
* the decoder with ``Policy.compute_dtype`` float32 in both packages
  (``monkeypatch``): logits and every cache leaf within 1e-4 of their
  scale (the family rule of ``tests/test_torch_lm_models.py``; measured
  about 3e-6), ``pos`` equal; in bf16 within 0.05 of the scale (that
  file's rule: both round every product to bf16 and sum in other orders).

JAX's local-layer cache has two quirks (ROADMAP queue 3), reproduced here
and held equal: a prefill padded past the window keeps ``pad_cache_to``
slots that decode then attends over as one ring (``w =
cache["k"].shape[1]``: zero slots and more than the window), and decode's
ring slot ``pos % w`` agrees with the prefill's time order only when ``S
<= w`` or ``S % w == 0``, so after a prefill of ``S % w != 0`` tokens past
the window decode evicts another token than the oldest.  (A prefill of
``S < w`` unpadded keeps an ``S``-slot ring, so its decode also departs
from the forward once ``pos >= S``.)  Decode agrees with the forward only
where the ring holds exactly the last ``window`` tokens in order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.registry import build_model as jbuild
from repro_torch.configs import registry as treg
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model

from _torch_parity import bf16_ulp, local_attention64

ARCH = "recurrentgemma_9b"
WINDOW = 16
N_DECODE = 4
F32_REL = 1e-4
BF16_REL = 0.05


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(seed, B, S, K, G, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


# ---- local_attention --------------------------------------------------------

# S < w, S = w, S = 2 w, S % w != 0 (one and several blocks), S = 1
SEQS = (9, WINDOW, 2 * WINDOW, 2 * WINDOW + 5, 5 * WINDOW - 3, 1)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("K,G", [(1, 4), (2, 3)])
def test_local_attention_matches_jax_and_float64_in_float32(S, K, G):
    q, k, v = _qkv(S * 7 + K, 2, S, K, G, 32)
    want = jattn.local_attention(*(jnp.asarray(a) for a in (q, k, v)), window=WINDOW)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.local_attention(tq, tk, tv, window=WINDOW)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    want64 = local_attention64(tq, tk, tv, WINDOW).numpy()
    np.testing.assert_allclose(_np(got), want64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(want), want64, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S", SEQS)
def test_local_attention_matches_jax_in_bf16(S):
    q, k, v = _qkv(S, 2, S, 1, 4, 32)
    want = _np(jattn.local_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                     window=WINDOW))
    got = tattn.local_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                window=WINDOW)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7, atol=1e-6)


def test_local_attention_window_past_the_length_is_causal():
    """``w = min(window, S)``: a window longer than the prompt is plain
    causal attention, as the flash version computes it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 12, 1, 2, 16))
    torch.testing.assert_close(kattn.local_attention(q, k, v, window=100),
                               ref.flash_attention_ref(q, k, v, True, 4, 4),
                               rtol=0, atol=1e-6)


def test_local_attention_wrapper_is_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 37, 1, 4, 32))
    kattn.local_launches = 0
    ref.calls = 0
    got = kattn.local_attention(q, k, v, window=WINDOW)
    assert torch.equal(got, ref.local_attention_ref(q, k, v, WINDOW))
    assert kattn.local_launches == 0 and ref.calls == 2
    assert tattn.local_attention is kattn.local_attention
    with pytest.raises(ValueError, match="CUDA"):
        kattn.flash_attention_kernel_call(q, k, v, window=WINDOW)


def test_local_attention_plain_version_is_differentiable():
    """Hybrid training runs on the CPU through the plain version: its
    gradients match float64 autograd of the band attention within float32
    rounding (the plain version computes in float32)."""
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(5, 1, 21, 1, 2, 8))
    with torch.enable_grad():
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g = torch.autograd.grad(ref.local_attention_ref(*ins, 8).sum(), ins)
        ins64 = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g64 = torch.autograd.grad(local_attention64(*ins64, 8).sum(), ins64)
    for a, b in zip(g, g64):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# ---- the hybrid decoder: prefill and decode ---------------------------------

def _leaves(cache, cfg):
    out = {"pos": _np(cache["pos"]).astype(np.int64)}
    for gi, group in enumerate(cfg.layer_groups()):
        for i in range(len(group.specs)):
            entry = cache["groups"][gi][f"p{i}"]
            for name in sorted(entry):
                leaf = entry[name]
                out[f"{gi}/p{i}/{name}"] = _np(leaf.clone() if isinstance(leaf, torch.Tensor)
                                               else leaf)
    return out


def _serve(model, params, tokens, S, pad, to_in, cache_leaves):
    """Prefill ``tokens[:, :S]`` and ``N_DECODE`` teacher-forced steps:
    logits and the cache's leaves after each call (taken before the next:
    the port writes its cache in place)."""
    lp, cache = model.prefill(params, to_in(tokens[:, :S]), {}, pad_cache_to=pad)
    out = {"prefill": _np(lp), "cache0": cache_leaves(cache)}
    for i in range(N_DECODE):
        ld, cache = model.decode(params, to_in(tokens[:, S + i:S + i + 1]), cache)
        out[f"decode{i}"] = _np(ld)
        out[f"cache{i + 1}"] = cache_leaves(cache)
    return out


def _hybrid_parity(S, pad, rel, window=None):
    """JAX's prefill of ``S`` tokens (cache padded to ``pad``) and 4 decode
    steps against the port's, every logit and cache leaf; returns both
    runs' outputs and the port's forward logits."""
    over = {} if window is None else {"hybrid": dataclasses.replace(
        jreg.get_reduced(ARCH).hybrid, window=window)}
    jcfg, tcfg = jreg.get_reduced(ARCH, **over), treg.get_reduced(ARCH, **over)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S + N_DECODE)).astype(np.int32)
    want = _serve(jbuild(jcfg), jparams, tokens, S, pad, jnp.asarray,
                  lambda c: _leaves(jax.tree.map(np.asarray, c), jcfg))
    model = build_model(tcfg, device="cpu")
    with torch.no_grad():
        got = _serve(model, tparams, tokens, S, pad, lambda a: torch.from_numpy(a).long(),
                     lambda c: _leaves(c, tcfg))
        fwd = _np(model.forward(tparams, torch.from_numpy(tokens).long(), {})[0])
    scale = float(np.abs(want["prefill"]).max())
    errs = {}
    for key in ("prefill", *(f"decode{i}" for i in range(N_DECODE))):
        errs[key] = float(np.abs(got[key] - want[key]).max()) / scale
    for step in range(N_DECODE + 1):
        jl, tl = want[f"cache{step}"], got[f"cache{step}"]
        assert jl.keys() == tl.keys()
        np.testing.assert_array_equal(tl.pop("pos"), jl.pop("pos"))
        for name, leaf in jl.items():
            assert tl[name].shape == leaf.shape, name
            errs[f"cache{step}/{name}"] = float(
                np.abs(tl[name] - leaf).max() / (np.abs(leaf).max() + 1e-12))
    assert max(errs.values()) < rel, {k: v for k, v in errs.items() if v >= rel}
    return tcfg, want, got, fwd


# (S, pad_cache_to): no padding (S < w: a ring of S slots); a prefill past
# the window padded past it (quirk 1: a ring of 80 slots where the window
# is 64); a prompt of 2 w (the ring consistent); S % w != 0 past the window
# (quirk 2)
CASES = {"no_pad": (32, None), "pad_past_window": (70, 80), "two_windows": (128, None),
         "ragged_past_window": (96, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_prefill_and_decode_match_jax_in_float32(case, monkeypatch):
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tcommon.Policy, "compute_dtype", torch.float32)
    S, pad = CASES[case]
    cfg, want, got, fwd = _hybrid_parity(S, pad, F32_REL)
    w = cfg.hybrid.window
    local = got["cache0"]["0/p2/k"]
    assert local.shape[2] == (pad if pad is not None else min(w, S))
    rglru = got["cache0"]["0/p0/conv"]
    assert rglru.shape == (1, 2, 3, cfg.hybrid.lru_width)
    scale = float(np.abs(fwd).max())
    # decode against the forward: within rounding only where the ring is w
    # slots holding the last w tokens in time order (S a multiple of w, no
    # padding); a ring of S < w slots, or of 80 slots, or a ragged prompt's
    # ring (quirk 2) makes decode attend to other keys than the forward
    err = max(float(np.abs(got[f"decode{i}"] - fwd[:, S + i]).max()) / scale
              for i in range(N_DECODE))
    if case == "two_windows":
        assert err < F32_REL, err
    else:
        assert err > 100 * F32_REL, err


@pytest.mark.parametrize("case", ["no_pad", "pad_past_window", "ragged_past_window"])
def test_hybrid_prefill_and_decode_match_jax_in_bf16(case):
    S, pad = CASES[case]
    _hybrid_parity(S, pad, BF16_REL)


def test_hybrid_window_longer_than_padded_cache_keeps_its_last_slots(monkeypatch):
    """A cache cut shorter than the kept keys (``pad_cache_to < min(w, S)``)
    keeps the last of them, as ``_pad_kv_caches`` cuts; window 16 here."""
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tcommon.Policy, "compute_dtype", torch.float32)
    _, _, got, _ = _hybrid_parity(40, 12, F32_REL, window=WINDOW)
    assert got["cache0"]["0/p2/k"].shape[2] == 12
