"""The port's training pieces against the JAX package's, on the CPU:
``steps.loss.softmax_xent``, ``optim.adamw``, ``runtime.compression``,
the plain versions of rows 7 (with ``lse``) and 9 and
``models.attention.flash_attention_fused`` (a ``torch.autograd.Function``
over them).  The whole train step has ``tests/test_torch_lm_train_step.py``.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:

* the loss, its metrics and its gradient in float32 within 1e-6 relative
  to their scale (the two differ in the order of the f32 sums only);
* AdamW within 1e-6 relative to each leaf's scale after 1 and 3 updates
  (float32 elementwise maths; the sums of the global norm differ in order);
  the closed-form checks of ``tests/test_substrate.py`` with its own
  tolerances;
* the compressor bit for bit (the same float32 operations in the same
  order, round half to even);
* attention in float32 within 1e-5 absolute of JAX (outputs and
  gradients O(1): the f32 sums differ in order) and within 1e-4 of a float64
  autograd of exact softmax attention; in bf16 within two bf16 ulps at
  each tensor's scale (both round the f32 results once, from sums in
  another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro.steps.loss import softmax_xent as jxent
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import compression as tcomp
from repro_torch.steps.loss import softmax_xent

F32_REL = 1e-6
ATT_F32_ATOL = 1e-5
ATT_F64_ATOL = 1e-4
BF16_ULPS = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---- softmax_xent -----------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_xent_value_and_gradient_match_jax(with_mask):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)  # some hits for the accuracy
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if with_mask else None

    def jloss(x):
        return jxent(x, jnp.asarray(labels), mask=None if mask is None else jnp.asarray(mask))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = softmax_xent(t, torch.from_numpy(labels).long(),
                          mask=None if mask is None else torch.from_numpy(mask))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= F32_REL * abs(float(jl))
    for k in ("nll", "accuracy"):
        assert abs(float(tm[k]) - float(jm[k])) <= F32_REL * max(abs(float(jm[k])), 1e-6), k
        assert not tm[k].requires_grad
    assert float(tm["accuracy"]) > 0
    assert _rel(t.grad, jg) <= F32_REL


def test_softmax_xent_max_carries_no_gradient_and_bf16_logits_upcast():
    """The gradient is softmax - onehot (plus the z-loss term) whatever the
    max; bf16 logits are upcast before any sum, as JAX's ``astype``."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 9)).astype(np.float32)
    labels = torch.tensor([[0, 3, 8, 1]])
    t = torch.from_numpy(x).requires_grad_(True)
    loss, _ = softmax_xent(t, labels, z_loss_coeff=0.0)
    loss.backward()
    want = torch.softmax(torch.from_numpy(x), -1) - torch.nn.functional.one_hot(labels, 9)
    torch.testing.assert_close(t.grad, want / 4, rtol=0, atol=1e-7)
    lb, _ = softmax_xent(torch.from_numpy(x).to(torch.bfloat16), labels)
    lf, _ = softmax_xent(torch.from_numpy(x).to(torch.bfloat16).float(), labels)
    assert float(lb) == float(lf)


# ---- AdamW ------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("clip", [0.3, 1e9])
@pytest.mark.parametrize("schedule,wd", [("cosine", 0.1), ("linear", 0.0), ("constant", 0.5)])
def test_adamw_update_matches_jax(schedule, wd, clip, n_updates):
    kw = dict(lr=0.05, weight_decay=wd, grad_clip=clip, warmup_steps=2, total_steps=5,
              schedule=schedule)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p0 = _tree(3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["m"]["a"].dtype == torch.float32
    for i in range(n_updates):
        g = _tree(10 + i)
        jp, js, jmet = jadamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp, ts, tmet = tadamw.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                           ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= F32_REL * abs(float(jmet[k])), k
        for k in p0:
            assert _rel(tp[k], jp[k]) <= F32_REL, k
            assert _rel(ts["m"][k], js["m"][k]) <= F32_REL, k
            assert _rel(ts["v"][k], js["v"][k]) <= F32_REL, k


def test_adamw_updates_a_module_in_place_and_takes_no_torch_optim():
    lin = torch.nn.Linear(3, 2)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    st = tadamw.adamw_init(lin)
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    ids = {n: p.data_ptr() for n, p in lin.named_parameters()}
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
                             schedule="constant")
    tadamw.adamw_update(lin, grads, st, cfg)
    for n, p in lin.named_parameters():
        assert p.data_ptr() == ids[n]
        torch.testing.assert_close(p.detach(), before[n] - 0.1, rtol=0, atol=1e-6)


# the counterparts of tests/test_substrate.py's optimizer tests

def test_adamw_matches_closed_form_step():
    cfg = tadamw.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                             grad_clip=1e9, warmup_steps=0, total_steps=10, schedule="constant")
    p = {"w": torch.tensor([1.0, -2.0])}
    st = tadamw.adamw_init(p)
    p2, st2, _ = tadamw.adamw_update(p, {"w": torch.tensor([0.5, 0.5])}, st, cfg)
    want = np.array([1.0, -2.0]) - 0.1 * np.sign([0.5, 0.5])
    np.testing.assert_allclose(p2["w"].numpy(), want, atol=1e-5)
    assert int(st2["step"]) == 1


def test_adamw_weight_decay_decoupled():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9, warmup_steps=0,
                             total_steps=10, schedule="constant")
    p = {"w": torch.tensor([2.0])}
    p2, _, _ = tadamw.adamw_update(p, {"w": torch.tensor([0.0])}, tadamw.adamw_init(p), cfg)
    np.testing.assert_allclose(p2["w"].numpy(), [2.0 - 0.1 * 0.5 * 2.0], atol=1e-6)


def test_schedule_warmup_and_cosine():
    s = tadamw.make_schedule(tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                                                schedule="cosine"))
    assert float(s(torch.tensor(5))) == pytest.approx(0.5, rel=1e-3)
    assert float(s(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(s(torch.tensor(110))) == pytest.approx(0.0, abs=1e-6)


def test_grad_clip_caps_global_norm():
    cfg = tadamw.AdamWConfig(grad_clip=1.0, warmup_steps=0, total_steps=1, schedule="constant")
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    st = tadamw.adamw_init(p)
    _, _, metrics = tadamw.adamw_update(p, g, st, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-4)
    # the fused update clips as it reads (m = (1 - b1) * g * scale) and
    # leaves the gradients as they were; clip_by_global_norm clips in place
    torch.testing.assert_close(st["m"]["w"], torch.full((4,), (1 - cfg.b1) * 0.5))
    assert float(tadamw.global_norm(g)) == pytest.approx(200.0, rel=1e-6)
    tadamw.clip_by_global_norm(g, cfg.grad_clip)
    assert float(tadamw.global_norm(g)) == pytest.approx(1.0, rel=1e-6)


# ---- int8 error-feedback compression -----------------------------------------

def test_int8_quantization_matches_jax_and_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, 1000).astype(np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(g))
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(tcomp.dequantize_int8(q, s).numpy() - g)
    assert err.max() <= float(s) / 2 + 1e-6


def test_compressor_matches_jax_bit_for_bit_over_steps():
    comp, jc = tcomp.make_compressor(), jcomp.make_compressor()
    st, jst = {}, {}
    for i in range(3):
        g = _tree(20 + i)
        jg, jst = jc({k: jnp.asarray(v) for k, v in g.items()}, jst)
        tg, st = comp({k: torch.from_numpy(v.copy()) for k, v in g.items()}, st)
        for k in g:
            assert np.array_equal(tg[k].numpy(), np.asarray(jg[k])), (i, k)
            assert np.array_equal(st["ef"][k].numpy(), np.asarray(jst["ef"][k])), (i, k)


def test_error_feedback_is_unbiased_over_time():
    comp = tcomp.make_compressor()
    g_true = torch.from_numpy(np.linspace(-3e-3, 7e-3, 64).astype(np.float32))
    st = {"ef": {"w": torch.zeros(64)}}
    total = np.zeros(64)
    for _ in range(50):
        gq, st = comp({"w": g_true.clone()}, st)
        total += gq["w"].numpy()
    np.testing.assert_allclose(total / 50, g_true.numpy(), atol=5e-5)


# ---- attention: rows 7 (with lse) and 9, plain, and the autograd Function -----

ATT_CASES = [  # (B, S, Skv, K, G, D, causal, q_block, kv_block)
    (2, 48, 48, 2, 1, 16, True, 32, 32),
    (1, 48, 48, 2, 3, 32, True, 32, 32),  # _pick_block: 48 with 32-blocks -> 24
    (2, 48, 48, 1, 3, 16, False, 32, 32),
    (1, 40, 72, 2, 3, 32, False, 16, 24),  # Skv != S, not causal
    (1, 64, 64, 2, 3, 32, True, 64, 64),
]


def _qkv_do(seed, B, S, Skv, K, G, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, Skv, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, G, D)).astype(np.float32))


def _within_bf16(got, want, ulps=BF16_ULPS):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    tol = ulps * 2.0 ** (np.floor(np.log2(scale)) - 7)
    return float(np.abs(got - want).max()), tol


@pytest.mark.parametrize("case", ATT_CASES)
def test_flash_fwd_ref_out_and_lse_match_jax_flash_fwd_loop(case):
    B, S, Skv, K, G, D, causal, qb, kb = case
    q, k, v, _ = _qkv_do(S + G, B, S, Skv, K, G, D)
    bq, bk = jattn._pick_block(S, qb), jattn._pick_block(Skv, kb)
    jout, jlse = jattn._flash_fwd_loop(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                       bq, bk)
    ref.calls = 0
    out, lse = ref.flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)), causal, qb, kb)
    assert ref.calls == 1 and lse.shape == (B, K, G, S) and lse.dtype == torch.float32
    assert float(np.abs(out.numpy() - np.asarray(jout)).max()) <= ATT_F32_ATOL
    assert float(np.abs(lse.numpy() - np.asarray(jlse)).max()) <= ATT_F32_ATOL
    # the same output as the forward without lse, bit for bit
    assert torch.equal(out, ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal,
                                                    qb, kb))


def _exact64(q, k, v, causal):
    """Float64 softmax attention, differentiable: the yardstick of both."""
    D, S, Skv = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k) * D ** -0.5
    if causal:
        mask = torch.arange(S)[:, None] >= torch.arange(Skv)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("case", ATT_CASES)
def test_flash_attention_fused_backward_matches_jax_vjp_and_float64(case):
    B, S, Skv, K, G, D, causal, qb, kb = case
    q, k, v, do = _qkv_do(S * 7 + D, B, S, Skv, K, G, D)
    jout, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention_fused(a, b, c, causal, qb, kb),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    ref.calls = 0
    kattn.flash_launches = kattn.flash_bwd_launches = 0
    out = tattn.flash_attention_fused(tq, tk, tv, causal, qb, kb, True)  # parallel_q: ignored
    out.backward(torch.from_numpy(do))
    assert ref.calls == 2 and kattn.flash_launches == kattn.flash_bwd_launches == 0
    assert float(np.abs(out.detach().numpy() - np.asarray(jout)).max()) <= ATT_F32_ATOL
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == torch.float32
        assert float(np.abs(t.grad.numpy() - np.asarray(j)).max()) <= ATT_F32_ATOL, name

    q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    _exact64(q64, k64, v64, causal).backward(torch.from_numpy(do).double())
    for name, t, w in zip("qkv", (tq, tk, tv), (q64, k64, v64)):
        assert float((t.grad.double() - w.grad).abs().max()) <= ATT_F64_ATOL, name


@pytest.mark.parametrize("case", [ATT_CASES[1], ATT_CASES[3]])
def test_flash_attention_fused_bf16_matches_jax(case):
    """bf16 inputs: the residual ``out`` is the bf16 output in both, delta
    is summed from it, and the gradients come back in bf16."""
    B, S, Skv, K, G, D, causal, qb, kb = case
    q, k, v, do = _qkv_do(S + 3, B, S, Skv, K, G, D)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    jout, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention_fused(a, b, c, causal, qb, kb),
                        *jb[:3])
    jgrads = vjp(jb[3])
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    leaves = [t.clone().requires_grad_(True) for t in tb[:3]]
    out = tattn.flash_attention_fused(*leaves, causal, qb, kb)
    out.backward(tb[3])
    assert out.dtype == torch.bfloat16
    err, tol = _within_bf16(out, np.asarray(jout.astype(jnp.float32)))
    assert err <= tol, ("out", err, tol)
    for name, t, j in zip("qkv", leaves, jgrads):
        assert t.grad.dtype == torch.bfloat16
        err, tol = _within_bf16(t.grad, np.asarray(j.astype(jnp.float32)))
        assert err <= tol, (name, err, tol)


def test_flash_attention_bwd_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv_do(4, 1, 9, 9, 1, 2, 16))
    kattn.flash_launches = kattn.flash_bwd_launches = 0
    ref.calls = 0
    out, lse = kattn.flash_attention_fwd(q, k, v)
    grads = kattn.flash_attention_bwd(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    assert ref.calls == 3 and kattn.flash_launches == kattn.flash_bwd_launches == 0
    for g, w, x in zip(grads, want, (q, k, v)):
        assert g.dtype == x.dtype and torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.flash_attention_bwd_kernel_call(q, k, v, out, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        kattn.flash_attention_kernel_call(q, k, v, want_lse=True)
