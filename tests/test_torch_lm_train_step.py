"""The port's training step against the JAX package's, on the CPU.

Two steps of ``make_train_step`` on ``get_reduced(...)`` of every family
the port serves, the state carried from JAX's ``init_train_state`` by
``train_state_from_jax`` and compared leaf by leaf in JAX's layout by
``to_jax_layout``: the metrics, and every leaf of ``params``, ``opt.m``
and ``opt.v`` after each step.  Cases: 1 and 2 microbatches,
``flash_vjp`` False and True (the port takes ``flash_attention_fused``
whenever it trains: JAX's two branches give the same gradient up to
rounding), and ``remat`` none, dots and full.  ``Policy.compute_dtype`` is
float32 in both packages (``monkeypatch``; no file of ``repro`` changes).

The optimizer's ``eps`` is 1e-4 here, not the default 1e-8.  At its first
update AdamW moves every element by ``lr * g / (|g| + eps)``, about
``lr * sign(g)``, however small ``g`` is; an element whose gradient is
rounding noise (some key-projection entries are 1e-9 against 1e-3 for the
leaf) then takes a sign that depends on the order of the f32 sums, in
either package, and the two runs part by up to ``2 lr`` there and diverge
from that step on (measured: 2.7e-2 of a leaf's scale).  With ``eps``
above that noise such an element hardly moves and the step is held
tightly; AdamW at ``eps = 1e-8`` is held against JAX on its own in
``tests/test_torch_lm_train.py``.

Tolerances (float32; measured worst over these cases in brackets): the
loss, ``nll``, ``accuracy``, ``grad_norm`` and ``lr`` within 1e-5 relative
[8e-7]; ``params`` within 2e-4 of each leaf's scale [4.5e-5, a zero-init
bias whose scale is a few updates]; ``m`` and ``v`` within 1e-4 [5e-6].
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models.registry import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.compression import make_compressor as jmake_compressor
from repro.steps.train import init_train_state as jinit_train_state
from repro.steps.train import make_train_step as jmake_train_step
from repro_torch.configs import registry as treg
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ref
from repro_torch.models import common as tcommon
from repro_torch.models.convert import to_jax_layout, train_state_from_jax
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.compression import make_compressor
from repro_torch.steps.train import init_train_state, make_train_step

DENSE_ARCHS = ("chameleon_34b", "llama3_405b", "nemotron4_15b", "qwen2_7b", "starcoder2_3b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
B, S, STEPS = 4, 48, 2
METRIC_REL = 1e-5
PARAM_REL = 2e-4
MOMENT_REL = 1e-4
EF_REL = 1e-2

CASES = ([(arch, 1, False, "none") for arch in DENSE_ARCHS]
         + [(arch, 2, True, "full") for arch in DENSE_ARCHS]
         + [("starcoder2_3b", 1, True, "dots"), ("starcoder2_3b", 2, False, "dots"),
            ("starcoder2_3b", 1, True, "none"), ("qwen2_7b", 2, False, "full")])


@pytest.fixture
def float32_compute(monkeypatch):
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tcommon.Policy, "compute_dtype", torch.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _far(got, want, rel):
    """Elements of each leaf further from JAX than ``rel`` of the leaf's
    scale: ``(count, size, largest abs difference)`` over the tree."""
    lg, lw = _leaves(got), _leaves(want)
    assert lg.keys() == lw.keys()
    far = size = 0
    worst = 0.0
    for name, w in lw.items():
        g = lg[name]
        assert g.shape == w.shape, name
        d = np.abs(g - w)
        far += int((d > rel * (float(np.abs(w).max()) + 1e-30)).sum())
        size += d.size
        worst = max(worst, float(d.max()))
    return far, size, worst


def _parts(tstate, jstate, cfg):
    got, want = to_jax_layout(tstate, cfg), jax.tree.map(np.asarray, jstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])
    return {"params": (got["params"], want["params"], PARAM_REL),
            "m": (got["opt"]["m"], want["opt"]["m"], MOMENT_REL),
            "v": (got["opt"]["v"], want["opt"]["v"], MOMENT_REL)}


def _assert_state_close(tstate, jstate, cfg, what):
    for part, (got, want, rel) in _parts(tstate, jstate, cfg).items():
        far, _, worst = _far(got, want, rel)
        assert far == 0, (what, part, far, worst)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


@pytest.mark.parametrize("arch,n_micro,flash_vjp,remat", CASES)
def test_train_step_matches_jax(arch, n_micro, flash_vjp, remat, float32_compute):
    jcfg = dataclasses.replace(jreg.get_reduced(arch), remat=remat, flash_vjp=flash_vjp)
    tcfg = dataclasses.replace(treg.get_reduced(arch), remat=remat, flash_vjp=flash_vjp)
    jmodel = jbuild(jcfg)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0), JAdamWConfig(**OPT))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    _assert_state_close(tstate, jstate, tcfg, "init")
    jstep = jax.jit(jmake_train_step(jmodel, JAdamWConfig(**OPT), n_microbatches=n_micro))
    tstep = make_train_step(build_model(tcfg, device="cpu"), AdamWConfig(**OPT),
                            n_microbatches=n_micro)
    tokens, labels = _batch(tcfg, 1)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        ref.calls = 0
        kattn.flash_launches = kattn.flash_bwd_launches = 0
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(labels).long()})
        # the plain attention forward (again in the backward under remat)
        # and backward per layer and microbatch, and the optimizer's plain
        # version (row 10) once; no kernel on the CPU
        per_layer = 2 if remat == "none" else 3
        assert ref.calls == per_layer * tcfg.n_layers * n_micro + 1
        assert kattn.flash_launches == kattn.flash_bwd_launches == 0
        assert tm.keys() == jm.keys(), (set(tm), set(jm))
        for k, w in jm.items():
            w = float(w)
            assert abs(float(tm[k]) - w) <= METRIC_REL * max(abs(w), 1e-6), (i, k)
        assert all(p.grad is None for p in tstate["params"].parameters())
        _assert_state_close(tstate, jstate, tcfg, f"step {i + 1}")


def test_compressor_in_train_step_matches_jax(float32_compute):
    """``tests/test_substrate.py``'s compressor-in-the-step test, on both
    packages: the residuals live in ``ef``, congruent with the parameters,
    and the step equals JAX's."""
    jcfg = jreg.get_reduced("starcoder2_3b", n_layers=2)
    tcfg = treg.get_reduced("starcoder2_3b", n_layers=2)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-4)
    jmodel = jbuild(jcfg)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0), JAdamWConfig(**opt))
    jstate["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstate["params"])
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    assert tstate["ef"].keys() == dict(tstate["params"].named_parameters()).keys()
    tokens, labels = _batch(tcfg, 2)
    jstep = jax.jit(jmake_train_step(jmodel, JAdamWConfig(**opt),
                                     compress_grads=jmake_compressor()))
    tstep = make_train_step(build_model(tcfg, device="cpu"), AdamWConfig(**opt),
                            compress_grads=make_compressor())
    lr_sum = [1e-3, 1e-3 + 7.5e-4]  # the schedule's lr at steps 1 and 2, summed
    for i in range(2):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(labels).long()})
        assert np.isfinite(float(tm["loss"]))
        for k, w in jm.items():
            assert abs(float(tm[k]) - float(w)) <= METRIC_REL * max(abs(float(w)), 1e-6), (i, k)
        # A gradient element at a quantisation boundary (x.5 steps) may round
        # to either neighbour after the two packages' sums: measured 1 element
        # in 412k after step 1, 71 after step 2.  Such an element's update
        # moves by at most lr (AdamW's step), its moments and residual by
        # about one quantisation step.  So at most 1e-3 of the elements may
        # leave the tight rule, and no parameter by more than the lr so far.
        parts = _parts(tstate, jstate, tcfg)
        # the residual g - Q(g) keeps the gradients' differences (up to 4e-5
        # of the gradient's scale after the first update) at 1/254 of that
        # scale: 1e-2 of its own
        parts["ef"] = (to_jax_layout(tstate["ef"], tcfg), jax.tree.map(np.asarray, jstate["ef"]),
                       EF_REL)
        for part, (got, want, rel) in parts.items():
            far, size, worst = _far(got, want, rel)
            assert far <= 1e-3 * size, (i, part, far, size)
            if part == "params":
                assert worst <= lr_sum[i], (i, worst)
        assert sum(float(np.abs(x).sum()) for x in _leaves(parts["ef"][0]).values()) > 0


def test_init_train_state_and_the_model_train_on_their_own():
    """The port alone at bf16 compute: ``init_train_state`` draws trainable
    float32 parameters; two steps keep the loss finite and move the
    parameters; prefill and decode run without grad."""
    cfg = treg.get_reduced("starcoder2_3b")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0, AdamWConfig(**OPT))
    params = state["params"]
    assert all(p.requires_grad and p.dtype == torch.float32 for p in params.parameters())
    assert not any(p.requires_grad for p in model.init(0, dtype=torch.bfloat16).parameters())
    before = [p.detach().clone() for p in params.parameters()]
    step = make_train_step(model, AdamWConfig(**OPT), n_microbatches=2)
    tokens, labels = (torch.from_numpy(a).long() for a in _batch(cfg, 3))
    for _ in range(2):
        state, m = step(state, {"tokens": tokens, "labels": labels})
        assert np.isfinite(float(m["loss"])) and set(m) == {"loss", "grad_norm", "lr"}
    assert int(state["opt"]["step"]) == 2
    assert sum(float((p.detach() - b).abs().sum())
               for p, b in zip(params.parameters(), before)) > 0
    logits, cache = model.prefill(params, tokens[:, :8], {})
    assert not logits.requires_grad and not cache["groups"][0]["p0"]["k"].requires_grad
    with pytest.raises(ValueError, match="multiple"):
        step(state, {"tokens": tokens[:3], "labels": labels[:3]})
