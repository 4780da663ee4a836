"""The port's LM serving path against the JAX package's, on the CPU.

Covers ``repro_torch.configs``, ``data.tokens``, ``models.common``,
``models.ffn``, ``models.decoder``, ``models.convert``, ``models.registry``
and ``steps.train`` (the serving steps).  Inputs are made with numpy from
a seed; JAX's ``init_decoder`` parameters are carried to the port by
``params_from_jax``; the port runs with ``device="cpu"``, where its
attention takes the plain versions of the CUDA kernels.

Tolerances:

* building blocks in float32 within 1e-6 absolute (inputs O(1); the two
  differ in the order of the f32 sums only; RoPE at positions up to 5,000
  and the FFN's products within 1e-5), in bf16 within one bf16 ulp of the
  value (``2**-7 * |x|``); the activations within one ulp of the f32
  function and of JAX's bf16 result at its scale (JAX rounds to bf16
  after each operation of the formula, the port once), the FFN within two
  ulps of the output's scale;
* the decoder with ``Policy.compute_dtype`` set to float32 in both
  packages (``monkeypatch``; no file of ``repro`` changes): logits and
  every cache leaf within 1e-4 of their scale (max |x|); measured about
  2e-6;
* the decoder at the default bf16: within 0.05 of the scale, the JAX
  test's own rule for forward against prefill and decode.  Both packages
  round every product to bf16 and their sums differ in order, so bf16
  roundings drift apart through the layers: measured up to 0.024 on the
  logits, as far from JAX's bf16 as JAX's bf16 is from its own float32;
* the MoE families (deepseek-moe-16b, dbrx-132b) as above in float32,
  with the summed ``aux_loss`` within 1e-5; in bf16 a token whose router
  logits near-tie may take another expert in each package, which moves
  its logits by far more than rounding (JAX's own bf16 run departs from
  its float32 run by 0.46 of the scale at 3 of deepseek's 72 tokens; the
  port's bf16 run departs from it at 3 of dbrx's), so each token (and
  cache slot) is held within 0.05 of the scale of JAX's bf16 where JAX's
  bf16 stays within 0.05 of JAX's float32, and within 0.05 of one of
  JAX's two runs everywhere;
* the hybrid family (recurrentgemma-9b: rglru and local layers, whose
  cache entries are ``conv``/``state`` and a ``k``/``v`` ring) under the
  dense families' rules; its RG-LRU recurrence rounds apart from JAX's by
  float32 ulps (XLA's ``exp``, ``sqrt`` and fused multiply-adds), measured
  about 3e-6 of the scale in float32 and 0.021 in bf16.
  ``ArchConfig.param_count`` counts the hybrid's block-diagonal gates as
  ``w x w`` (ROADMAP queue 3), so its init is held against JAX's tree leaf
  by leaf instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data.tokens import ShardedTokenPipeline as JPipeline
from repro.data.tokens import TokenPipelineConfig as JPipeCfg
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models.registry import build_model as jbuild
from repro.steps.train import make_decode_step as jdecode_step
from repro.steps.train import make_prefill_step as jprefill_step
from repro_torch.configs import registry as treg
from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.decoder import init_decoder
from repro_torch.models.registry import build_model
from repro_torch.steps.train import make_decode_step, make_prefill_step

DENSE_ARCHS = ("chameleon_34b", "llama3_405b", "nemotron4_15b", "qwen2_7b", "starcoder2_3b")
MOE_ARCHS = ("deepseek_moe_16b", "dbrx_132b")
HYBRID_ARCHS = ("recurrentgemma_9b",)
B, S, N_DECODE = 2, 32, 4
F32_REL = 1e-4
BF16_REL = 0.05


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, dtype=np.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ---- configs and data -------------------------------------------------------

def test_configs_equal_jax():
    assert treg.ARCH_IDS == jreg.ARCH_IDS and treg.SHAPES == jreg.SHAPES
    for arch in jreg.ARCH_IDS:
        for tget, jget in ((treg.get_config, jreg.get_config),
                           (treg.get_reduced, jreg.get_reduced)):
            t, j = tget(arch), jget(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert t.param_count() == j.param_count(), arch
            assert t.param_count(active_only=True) == j.param_count(active_only=True), arch
            assert t.describe() == j.describe(), arch
            assert ([(tuple((s.mixer, s.ffn) for s in g.specs), g.repeat)
                     for g in t.layer_groups()]
                    == [(tuple((s.mixer, s.ffn) for s in g.specs), g.repeat)
                        for g in j.layer_groups()]), arch
        assert (treg.shape_applicable(treg.get_config(arch), "long_500k")
                == jreg.shape_applicable(jreg.get_config(arch), "long_500k"))


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_token_pipeline_equals_jax(host, n_hosts):
    cfg = dict(vocab=1000, seq_len=24, global_batch=4, seed=7)
    t = ShardedTokenPipeline(TokenPipelineConfig(**cfg), host, n_hosts)
    j = JPipeline(JPipeCfg(**cfg), host, n_hosts)
    for step in (0, 3):
        tb, jb = t.batch_at(step), j.batch_at(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[key], jb[key])


# ---- building blocks --------------------------------------------------------

_J = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x, _J[dtype]), torch.from_numpy(x).to(_T[dtype])
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _close(tcommon.rmsnorm(tx, tw), jcommon.rmsnorm(jx, jw), dtype)
    _close(tcommon.layernorm(tx, tw, torch.from_numpy(bias)),
           jcommon.layernorm(jx, jw, jnp.asarray(bias)), dtype)
    _close(tcommon.layernorm(tx, tw), jcommon.layernorm(jx, jw), dtype)
    np.testing.assert_allclose(_np(tcommon.rope_freqs(16, 1e6)),
                               np.asarray(jcommon.rope_freqs(16, 1e6)), rtol=1e-6)
    for theta in (1e4, 1e6):
        got = tcommon.apply_rope(tx, torch.from_numpy(pos), theta)
        want = jcommon.apply_rope(jx, jnp.asarray(pos), theta)
        # positions up to 5,000: sin/cos of angles that large differ by
        # ~1e-6 between libraries, so f32 is held at 1e-5 here
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
        else:
            _close(got, want, dtype)
    # zero weights: the JAX scale is 1 + weight
    z = torch.zeros(16)
    unit = tcommon.rmsnorm(torch.ones(4, 16) * 3.0, z)
    torch.testing.assert_close(unit, torch.ones(4, 16), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["gelu", "relu2", "silu"])
def test_activations_match_jax(dtype, kind):
    x = np.random.default_rng(1).standard_normal((64,)).astype(np.float32) * 3
    got = tcommon.activation(kind, torch.from_numpy(x).to(_T[dtype]))
    want = jcommon.activation(kind, jnp.asarray(x, _J[dtype]))
    if dtype == "f32":
        _close(got, want, dtype)
        return
    # JAX evaluates the formula in bf16, rounding after each operation (its
    # tanh gelu loses 13% at x = -2.45 to cancellation); the port in f32,
    # rounding once.  The port is within one bf16 ulp of the f32 function
    # of the same bf16 inputs, and within one ulp at the output's scale of
    # JAX's bf16 result.
    exact = jcommon.activation(kind, jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(_np(got), _np(exact), rtol=2.0 ** -7, atol=1e-6)
    assert np.abs(_np(got) - _np(want)).max() <= 2.0 ** -7 * np.abs(_np(want)).max()


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tcommon.activation("tanh", torch.zeros(2))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_dense_ffn_matches_jax(act):
    p = jffn.init_dense_ffn(jax.random.PRNGKey(3), 32, 48, act)
    tp = tffn.DenseFFN(*(torch.tensor(np.asarray(p[n])) if n in p else None
                         for n in ("w_in", "w_out", "w_gate")))
    x = np.random.default_rng(2).standard_normal((2, 3, 32)).astype(np.float32)
    for dtype in ("f32", "bf16"):
        want = jffn.dense_ffn(p, jnp.asarray(x, _J[dtype]), act)
        got = tffn.dense_ffn(tp, torch.from_numpy(x).to(_T[dtype]), act)
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
        else:  # three bf16 products: the hidden roundings may differ by an ulp
            assert _rel(got, want) < 2.0 ** -6


def test_dense_init_rule():
    gen = torch.Generator().manual_seed(0)
    w = tcommon.dense_init((400, 300), gen)
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * 400 ** -0.5 + 1e-7
    assert abs(float(w.std()) / 400 ** -0.5 - 0.8796) < 0.02  # std of N(0,1) cut at ±2
    e = tcommon.dense_init((50, 8), gen, scale=0.02, dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16 and float(e.abs().max()) <= 0.04 + 1e-3


# ---- the slice as a whole ---------------------------------------------------

def _run_jax(cfg, params, tokens):
    model = jbuild(cfg)
    logits, aux = model.forward(params, jnp.asarray(tokens), {})
    prefill = jprefill_step(model, pad_cache_to=S + N_DECODE)
    decode = jdecode_step(model)
    lp, cache = prefill(params, jnp.asarray(tokens[:, :S]), {})
    out = {"forward": logits, "prefill": lp, "cache0": jax.tree.map(np.asarray, cache),
           "aux": float(aux["aux_loss"])}
    for i in range(N_DECODE):
        ld, cache = decode(params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache)
        out[f"decode{i}"] = ld
        out[f"cache{i + 1}"] = jax.tree.map(np.asarray, cache)
    return out


def _cache_leaves(cache, cfg):
    out = {"pos": _np(cache["pos"]) if isinstance(cache["pos"], torch.Tensor)
           else np.asarray(cache["pos"])}
    for gi, group in enumerate(cfg.layer_groups()):
        for i in range(len(group.specs)):
            entry = cache["groups"][gi][f"p{i}"]
            for name in sorted(entry):  # k, v; or an rglru layer's conv, state
                leaf = entry[name]
                out[f"{gi}/p{i}/{name}"] = _np(leaf.clone() if isinstance(leaf, torch.Tensor)
                                               else leaf)
    return out


def _run_port(cfg, params, tokens):
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits, aux = model.forward(params, torch.from_numpy(tokens), {})
    assert logits.dtype == torch.float32 and aux["aux_loss"].dtype == torch.float32
    if cfg.moe is None:
        assert float(aux["aux_loss"]) == 0.0
    prefill = make_prefill_step(model, pad_cache_to=S + N_DECODE)
    decode = make_decode_step(model)
    lp, cache = prefill(params, torch.from_numpy(tokens[:, :S]), {})
    # the port writes the cache in place: take the leaves before each step
    out = {"forward": logits, "prefill": lp, "cache0": _cache_leaves(cache, cfg),
           "aux": float(aux["aux_loss"])}
    for i in range(N_DECODE):
        ld, cache = decode(params, torch.from_numpy(tokens[:, S + i:S + i + 1]), cache)
        out[f"decode{i}"] = ld
        out[f"cache{i + 1}"] = _cache_leaves(cache, cfg)
    return out


def _setup(arch):
    jcfg, tcfg = jreg.get_reduced(arch), treg.get_reduced(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (B, S + N_DECODE)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _compare(arch, rel):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    want, got = _run_jax(jcfg, jparams, tokens), _run_port(tcfg, tparams, tokens)
    if tcfg.moe is not None:
        assert abs(got["aux"] - want["aux"]) <= 1e-5, (got["aux"], want["aux"])
    scale = float(np.abs(_np(want["forward"])).max())
    errs = {}
    for key in ("forward", "prefill", *(f"decode{i}" for i in range(N_DECODE))):
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        errs[key] = float(np.abs(_np(got[key]) - _np(want[key])).max()) / scale
    for step in range(N_DECODE + 1):
        jleaves = _cache_leaves(want[f"cache{step}"], jcfg)
        tleaves = got[f"cache{step}"]
        assert jleaves.keys() == tleaves.keys()
        np.testing.assert_array_equal(tleaves.pop("pos"), jleaves.pop("pos"))
        for name, leaf in jleaves.items():
            assert tleaves[name].shape == leaf.shape, name
            errs[f"cache{step}/{name}"] = _rel(tleaves[name], leaf)
    assert max(errs.values()) < rel, {k: v for k, v in errs.items() if v >= rel}
    return errs


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + HYBRID_ARCHS)
def test_decoder_matches_jax_in_float32(arch, monkeypatch):
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tcommon.Policy, "compute_dtype", torch.float32)
    _compare(arch, F32_REL)


@pytest.mark.parametrize("arch", DENSE_ARCHS + HYBRID_ARCHS)
def test_decoder_matches_jax_in_bf16(arch):
    _compare(arch, BF16_REL)


def _token_errors(got, want, scale):
    """Per token (every index but the last) ``|got - want|`` max over the
    last axis, over ``scale``."""
    return np.abs(_np(got) - _np(want)).max(-1) / scale


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decoder_matches_jax_in_bf16_off_routing_flips(arch, monkeypatch):
    jcfg, tcfg, jparams, tparams, tokens = _setup(arch)
    want, got = _run_jax(jcfg, jparams, tokens), _run_port(tcfg, tparams, tokens)
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    want32 = _run_jax(jcfg, jparams, tokens)
    scale = float(np.abs(_np(want["forward"])).max())
    flipped = 0
    for key in ("forward", "prefill", *(f"decode{i}" for i in range(N_DECODE))):
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        stable = _token_errors(want[key], want32[key], scale) < BF16_REL
        err = _token_errors(got[key], want[key], scale)
        assert (err[stable] < BF16_REL).all(), (key, err[stable].max())
        err32 = _token_errors(got[key], want32[key], scale)
        assert (np.minimum(err, err32) < BF16_REL).all(), key
        flipped += int((np.maximum(err, err32) >= BF16_REL).sum())
    for step in range(N_DECODE + 1):
        jl, jl32 = _cache_leaves(want[f"cache{step}"], jcfg), _cache_leaves(want32[f"cache{step}"], jcfg)
        tl = got[f"cache{step}"]
        np.testing.assert_array_equal(tl.pop("pos"), jl.pop("pos"))
        jl32.pop("pos")
        for name, leaf in jl.items():
            s = float(np.abs(leaf).max())
            stable = np.abs(leaf - jl32[name]).max(-1) / s < BF16_REL
            err = np.abs(tl[name] - leaf).max(-1) / s
            assert (err[stable] < BF16_REL).all(), (step, name, err[stable].max())
            err32 = np.abs(tl[name] - jl32[name]).max(-1) / s
            assert (np.minimum(err, err32) < BF16_REL).all(), (step, name)
    assert flipped <= 0.1 * B * (S + N_DECODE + 2), flipped


@pytest.mark.parametrize("arch", ["qwen2_7b", "starcoder2_3b", *MOE_ARCHS, *HYBRID_ARCHS])
def test_port_prefill_and_decode_agree_with_its_forward(arch):
    """``tests/test_models.py``'s cache check on the port alone (MoE
    drop-free: ``capacity_factor = n_experts``, the JAX test's rule)."""
    cfg = treg.get_reduced(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    model = build_model(cfg, device="cpu")
    params = model.init(1)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1)).astype(np.int64))
    logits_fwd, _ = model.forward(params, tokens, {})
    lp, cache = model.prefill(params, tokens[:, :S], {}, pad_cache_to=S + 4)
    ld, cache2 = model.decode(params, tokens[:, S:S + 1], cache)
    scale = float(logits_fwd.abs().max()) + 1e-9
    assert float((lp - logits_fwd[:, S - 1]).abs().max()) / scale < 0.05
    assert float((ld - logits_fwd[:, S]).abs().max()) / scale < 0.05
    assert int(cache2["pos"][0]) == S + 1


def test_prefill_longer_than_cache_keeps_the_last_slots():
    cfg = treg.get_reduced("qwen2_7b")
    model = build_model(cfg, device="cpu")
    params = model.init(2)
    tokens = torch.randint(0, cfg.vocab, (1, 12), generator=torch.Generator().manual_seed(0))
    _, full = model.prefill(params, tokens, {})
    _, cut = model.prefill(params, tokens, {}, pad_cache_to=5)
    k_full, k_cut = full["groups"][0]["p0"]["k"], cut["groups"][0]["p0"]["k"]
    assert k_cut.shape[2] == 5 and torch.equal(k_cut, k_full[:, :, -5:])


def test_model_init_draws_serving_weights_and_matches_param_count():
    cfg = treg.get_reduced("qwen2_7b")
    model = build_model(cfg, device="cpu")
    p32 = model.init(3)
    pbf = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    assert sum(t.numel() for t in p32.parameters()) == cfg.param_count()
    assert all(t.dtype == torch.float32 for t in p32.parameters())
    assert all(t.dtype == torch.bfloat16 for t in pbf.parameters())
    # cast once from the same f32 draw: equal to casting the f32 parameters
    for a, b in zip(p32.parameters(), pbf.parameters()):
        assert torch.equal(a.to(torch.bfloat16), b)
    cache = model.init_cache(2, 10)
    assert cache["groups"][0]["p0"]["k"].shape == (cfg.n_layers, 2, 10, cfg.n_kv_heads, cfg.hd)
    assert cache["groups"][0]["p0"]["k"].dtype == torch.bfloat16
    assert cache["pos"].dtype == torch.int32 and model.extras_shapes(2) == {}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_init_matches_param_count(arch):
    """The MoE families build on the CPU; ``init`` draws every leaf of
    JAX's tree (``param_count`` counts them), in float32 or cast once to
    bf16, with a ``moe`` on each MoE layer and a dense ``ffn`` on the
    leading dense ones."""
    cfg = treg.get_reduced(arch)
    model = build_model(cfg, device="cpu")
    p32 = model.init(3)
    pbf = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    assert sum(t.numel() for t in p32.parameters()) == cfg.param_count()
    for a, b in zip(p32.parameters(), pbf.parameters()):
        assert torch.equal(a.to(torch.bfloat16), b)
    for gi, group in enumerate(cfg.layer_groups()):
        for layer in p32.groups[gi]["p0"]:
            assert (layer.moe is not None) == (group.specs[0].ffn == "moe")
            assert (layer.ffn is None) == (layer.moe is not None)
    jtree = jax.tree.map(np.asarray, jbuild(jreg.get_reduced(arch)).init(jax.random.PRNGKey(0)))
    assert sum(a.size for a in jax.tree.leaves(jtree)) == cfg.param_count()


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_hybrid_model_init_matches_the_jax_tree_leaf_by_leaf(arch):
    """``init`` draws every leaf of JAX's tree under its name and shape
    (the gates ``[nb, w/nb, w/nb]``), in float32 or cast once to bf16;
    ``param_count`` over-counts them as ``w x w`` in both packages alike
    (ROADMAP queue 3), so the sum is held against JAX's tree, not it."""
    from repro_torch.models.convert import to_jax_layout

    cfg = treg.get_reduced(arch)
    model = build_model(cfg, device="cpu")
    p32 = model.init(3)
    pbf = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    for a, b in zip(p32.parameters(), pbf.parameters()):
        assert torch.equal(a.to(torch.bfloat16), b)
    jtree = jax.tree.map(np.asarray, jbuild(jreg.get_reduced(arch)).init(jax.random.PRNGKey(0)))
    ttree = to_jax_layout(p32, cfg)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [(jax.tree_util.keystr(k), v.shape) for k, v in jflat] == \
        [(jax.tree_util.keystr(k), v.shape) for k, v in tflat]
    n = sum(t.numel() for t in p32.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(jtree)) < cfg.param_count()
    for gi, group in enumerate(cfg.layer_groups()):
        for i, spec in enumerate(group.specs):
            for layer in p32.groups[gi][f"p{i}"]:
                assert (layer.rglru is not None) == (spec.mixer == "rglru")
                assert (layer.attn is None) == (spec.mixer == "rglru")
    cache = model.init_cache(2, 10)
    local = [e for g in cache["groups"] for e in g.values() if "k" in e]
    assert local and all(e["k"].shape[2] == min(cfg.hybrid.window, 10) for e in local)
    conv = [e["conv"] for g in cache["groups"] for e in g.values() if "conv" in e]
    assert conv and all(c.dtype == torch.float32 and c.shape[2] == 3 for c in conv)


@pytest.mark.parametrize("arch", ["mamba2_130m", "whisper_medium"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(treg.get_reduced(arch), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_decoder(torch.Generator().manual_seed(0), treg.get_reduced(arch))


@pytest.mark.parametrize("arch", ["qwen2_7b", "deepseek_moe_16b"])
def test_build_model_without_device_needs_a_card(arch):
    cfg = treg.get_reduced(arch)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)


def test_params_from_jax_without_device_needs_a_card():
    cfg = treg.get_reduced("qwen2_7b")
    tree = jax.tree.map(np.asarray, jbuild(jreg.get_reduced("qwen2_7b")).init(jax.random.PRNGKey(0)))
    if torch.cuda.is_available():
        assert params_from_jax(tree, cfg).embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            params_from_jax(tree, cfg)
    assert params_from_jax(tree, cfg, device="cpu").embed.device.type == "cpu"


def test_entry_points_refuse_tensors_on_another_device():
    """Parameters, tokens or a cache that lie elsewhere than the model are
    refused, never run where they lie."""
    cfg = treg.get_reduced("qwen2_7b")
    model = build_model(cfg, device="cpu")
    params = model.init(4)
    tokens = torch.zeros((1, 6), dtype=torch.int64)
    _, cache = model.prefill(params, tokens, {}, pad_cache_to=8)
    away = torch.device("meta")
    with pytest.raises(ValueError, match="tokens lies on meta"):
        model.forward(params, tokens.to(away), {})
    with pytest.raises(ValueError, match="params lies on meta"):
        model.prefill(model.init(5).to(away), tokens, {})  # Module.to moves in place
    with pytest.raises(ValueError, match="cache lies on meta"):
        model.decode(params, tokens[:, :1], dict(cache, pos=cache["pos"].to(away)))
