"""The port's RG-LRU block (``repro_torch.models.rglru``) and row 14's plain
version (``kernels/ref.py`` ``rglru_scan_ref``) against the JAX package's
``repro.models.rglru``, on the CPU, at ``get_reduced("recurrentgemma_9b")``
(d 128, lru_width 128, 4 gate blocks of 32).

Inputs come from numpy with a seed; JAX's ``init_rglru_block`` parameters
are handed to the port as numpy arrays.  The recurrence runs through
``repro_torch.kernels.rglru.rglru_scan``, which on CPU tensors is the plain
version: ``lax.associative_scan``'s recursion in torch ops.

Tolerances, and why:

* the causal conv: float32 within 1e-6 absolute (four products and adds
  in JAX's order; inputs O(1)); bf16 within one bf16 ulp of the value
  (each package rounds the same operations to bf16; XLA may keep a fused
  chain in float32);
* the gates: float32 within 1e-6 (float32 products summed over 32 terms
  in another order, then a sigmoid);
* the scan: float32 within 1e-5 of the output's scale.  Not bit for bit:
  XLA on the CPU evaluates ``exp`` and ``sqrt`` to other ulps than torch
  and contracts ``a2 * b1 + b2`` into a fused multiply-add, and the
  recurrence carries each such ulp forward (``a_t`` up to 0.999).  Both
  packages lie within 1e-5 of the scale of a float64 recurrence walked in
  order (``_torch_parity.rglru_scan64``) from the same inputs;
* the block's forward and decode: float32 within 1e-5 of the output's
  scale; bf16 within 4 bf16 ulps of the scale (the products and the conv
  round to bf16 in both packages, their f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import rglru as jrglru
from repro_torch.configs import registry as treg
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as krglru
from repro_torch.models import rglru as trglru

from _torch_parity import bf16_ulp, rglru_scan64

ARCH = "recurrentgemma_9b"
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16}
LEAVES = ("w_gate_in", "w_x_in", "conv_w", "conv_b", "w_a", "w_i", "lambda", "w_out")


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _block(seed=0):
    """JAX's block at the reduced config and the port's with its values."""
    jcfg, tcfg = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg)
    tp = trglru.RGLRUBlock(*(torch.from_numpy(np.array(jp[n])) for n in LEAVES))
    return jcfg, tcfg, jp, tp


def _scan_inputs(seed, B=2, S=37, w=128):
    rng = np.random.default_rng(seed)
    r = rng.random((B, S, w)).astype(np.float32)
    i = rng.random((B, S, w)).astype(np.float32)
    h = rng.standard_normal((B, S, w)).astype(np.float32)
    lam = rng.uniform(2.2, 6.9, w).astype(np.float32)
    init = rng.standard_normal((B, w)).astype(np.float32)
    return r, i, h, lam, init


def _jax_scan(r, i, h, lam, init):
    """``repro.models.rglru._rglru_scan`` after its gates (the same lines)."""
    log_a0 = jax.nn.log_sigmoid(lam)[None, None, :]
    at = jnp.exp(jrglru._C * r * log_a0)
    beta = jnp.sqrt(jnp.maximum(1.0 - at * at, 1e-12))
    xin = beta * i * h.astype(jnp.float32)
    if init is not None:
        xin = xin.at[:, 0, :].add(at[:, 0, :] * init)

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2

    _, y = jax.lax.associative_scan(combine, (at, xin), axis=1)
    return y, y[:, -1, :]


def test_block_leaves_and_init_match_jax():
    """The port draws JAX's leaves under JAX's names and shapes (the gates
    block-diagonal ``[nb, w/nb, w/nb]``), ``lambda`` in (2.2, 6.9)."""
    jcfg, tcfg, jp, _ = _block()
    tp = trglru.init_rglru_block(torch.Generator().manual_seed(0), tcfg)
    names = [n for n, _ in tp.named_parameters()]
    assert sorted(names) == sorted(jp) == sorted(LEAVES)
    for n, t in tp.named_parameters():
        assert tuple(t.shape) == jp[n].shape and t.dtype == torch.float32, n
    lam = tp.lam()
    assert float(lam.min()) >= 2.2 and float(lam.max()) <= 6.9
    assert float(tp.conv_b.abs().max()) == 0.0
    bf = trglru.init_rglru_block(torch.Generator().manual_seed(0), tcfg, dtype=torch.bfloat16)
    for a, b in zip(tp.parameters(), bf.parameters()):
        assert torch.equal(a.to(torch.bfloat16), b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 128)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 128))).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = jrglru._causal_conv(jnp.asarray(x, _J[dtype]), jnp.asarray(w), jnp.asarray(b))
    got = trglru._causal_conv(torch.from_numpy(x).to(_T[dtype]), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert got.dtype == _T[dtype]
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("lead", [(2, 9), (3,)])
def test_gates_match_jax(lead):
    _, tcfg, jp, tp = _block(1)
    h = np.random.default_rng(2).standard_normal((*lead, 128)).astype(np.float32)
    jr, ji = jrglru._gates(jp, jnp.asarray(h), tcfg.n_heads)
    tr, ti = trglru._gates(tp, torch.from_numpy(h), tcfg.n_heads)
    assert tr.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(_np(tr), _np(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ti), _np(ji), rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("S", [1, 2, 37, 64])
def test_scan_matches_jax_and_float64(with_init, S):
    r, i, h, lam, init = _scan_inputs(S, S=S)
    init = init if with_init else None
    want, want_last = _jax_scan(*(jnp.asarray(a) for a in (r, i, h, lam)),
                                None if init is None else jnp.asarray(init))
    tin = [torch.from_numpy(a) for a in (r, i, h, lam)]
    tinit = None if init is None else torch.from_numpy(init)
    got, last = krglru.rglru_scan(*tin, tinit)
    assert got.dtype == last.dtype == torch.float32 and tuple(got.shape) == r.shape
    assert torch.equal(last, got[:, -1])
    assert _rel(got, want) < 1e-5 and _rel(last, want_last) < 1e-5
    y64, _ = rglru_scan64(*tin, tinit)
    scale = float(y64.abs().max())
    assert float((got.double() - y64).abs().max()) / scale < 1e-5
    assert float(np.abs(np.asarray(want, np.float64) - y64.numpy()).max()) / scale < 1e-5


def test_scan_wrapper_is_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing; bf16 ``h`` is read as float32."""
    r, i, h, lam, init = (torch.from_numpy(a) for a in _scan_inputs(3))
    krglru.launches = 0
    ref.calls = 0
    got = krglru.rglru_scan(r, i, h.to(torch.bfloat16), lam, init)
    want = ref.rglru_scan_ref(r, i, h.to(torch.bfloat16).float(), lam, init)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert krglru.launches == 0 and ref.calls == 2
    with pytest.raises(ValueError, match="CUDA"):
        krglru.rglru_scan_kernel_call(r, i, h, lam, init)


def test_scan_plain_version_is_differentiable():
    """Hybrid training runs on the CPU through the plain version: its
    gradient matches float64 autograd of the sequential recurrence."""
    r, i, h, lam, init = (torch.from_numpy(a).double() for a in _scan_inputs(4, S=9, w=8))
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_(True) for t in (r, i, h, init)]
        y, _ = ref.rglru_scan_ref(leaves[0], leaves[1], leaves[2], lam, leaves[3])
        g = torch.autograd.grad(y.sum(), leaves)
        leaves64 = [t.clone().requires_grad_(True) for t in (r, i, h, init)]
        y64, _ = rglru_scan64(leaves64[0], leaves64[1], leaves64[2], lam, leaves64[3])
        g64 = torch.autograd.grad(y64.sum(), leaves64)
    for a, b in zip(g, g64):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_block_forward_matches_jax(dtype, with_init):
    jcfg, tcfg, jp, tp = _block(2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, 128)).astype(np.float32)
    init = rng.standard_normal((2, 128)).astype(np.float32) if with_init else None
    want, wstate = jrglru.rglru_block_forward(jp, jnp.asarray(x, _J[dtype]), jcfg,
                                              None if init is None else jnp.asarray(init))
    got, state, hx = trglru.rglru_block_forward(tp, torch.from_numpy(x).to(_T[dtype]), tcfg,
                                                None if init is None else torch.from_numpy(init))
    assert got.dtype == _T[dtype] and state.dtype == torch.float32 and hx.dtype == _T[dtype]
    scale = float(np.abs(_np(want)).max())
    tol = 1e-5 if dtype == "f32" else 4 * bf16_ulp(scale) / scale
    assert _rel(got, want) < tol, _rel(got, want)
    assert _rel(state, wstate) < (1e-5 if dtype == "f32" else 1e-2)
    np.testing.assert_allclose(
        _np(hx), _np(jnp.asarray(x, _J[dtype]) @ jp["w_x_in"].astype(_J[dtype])),
        rtol=0 if dtype == "f32" else 2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_decode_matches_jax(cache_dtype, dtype):
    """One step from a cache (JAX's ``init_rglru_cache`` keeps ``conv`` in
    float32, a prefill in the compute dtype: both promote as JAX does),
    then a second from the first's cache."""
    jcfg, tcfg, jp, tp = _block(3)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((3, 3, 128)).astype(np.float32)
    state = rng.standard_normal((3, 128)).astype(np.float32)
    jc = {"conv": jnp.asarray(conv, _J[cache_dtype]), "state": jnp.asarray(state)}
    tc = {"conv": torch.from_numpy(conv).to(_T[cache_dtype]), "state": torch.from_numpy(state)}
    for step in range(2):
        x = rng.standard_normal((3, 1, 128)).astype(np.float32)
        want, jc = jrglru.rglru_block_decode(jp, jnp.asarray(x, _J[dtype]), jc, jcfg)
        got, tc = trglru.rglru_block_decode(tp, torch.from_numpy(x).to(_T[dtype]), tc, tcfg)
        assert tuple(got.shape) == want.shape and got.dtype == _T[dtype]
        assert tc["conv"].dtype == {"float32": torch.float32,
                                    "bfloat16": torch.bfloat16}[str(jc["conv"].dtype)]
        scale = float(np.abs(_np(want)).max())
        tol = 1e-5 if dtype == "f32" else 4 * bf16_ulp(scale) / scale
        assert _rel(got, want) < tol, (step, _rel(got, want))
        assert _rel(tc["state"], jc["state"]) < (1e-5 if dtype == "f32" else 1e-2)
        assert _rel(tc["conv"], jc["conv"]) < (1e-6 if dtype == "f32" else 2.0 ** -7)


def test_decode_step_is_the_scan_at_one_step():
    """``rglru_block_decode`` is the forward's scan at S = 1 from the
    cache's state: a forward over one token from that state gives the
    same output and state when the conv's window holds zeros."""
    _, tcfg, _, tp = _block(4)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 1, 128)).astype(np.float32))
    state = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    cache = trglru.init_rglru_cache(tcfg, 2)
    assert cache["conv"].dtype == torch.float32 and tuple(cache["conv"].shape) == (2, 3, 128)
    out_d, new = trglru.rglru_block_decode(tp, x, dict(cache, state=state), tcfg)
    out_f, state_f, _ = trglru.rglru_block_forward(tp, x, tcfg, init_state=state)
    assert torch.equal(new["state"], state_f)
    torch.testing.assert_close(out_d, out_f, rtol=0, atol=1e-6)
