"""The port's MoE FFN (``repro_torch.models.ffn``: ``route``, ``moe_ffn``)
and row 12's plain version against the JAX package, on the CPU.

Inputs come from numpy with a seed; JAX's ``init_moe`` parameters are
handed to the port as numpy arrays.  The port's expert MLP runs through
``repro_torch.kernels.moe.moe_expert_mlp``, which on CPU tensors is the
plain version (``kernels/ref.py`` ``moe_expert_mlp_ref``).

Tolerances:

* routing from the same float32 probabilities: ``topi``, ``topv``,
  ``keep``, the queue positions and the per-expert assignment share
  bit-identical (the top-k by a stable sort puts the lower expert first on
  ties, as ``jax.lax.top_k``; the normalising sum adds in order, as XLA
  does).  From the same logits the softmax's ``exp`` differs by an ulp or
  two between the packages, so ``topv`` is held within 4 float32 ulps and
  the rest stays bit-identical (the logits are bf16-rounded, so distinct
  logits lie far apart);
* the aux loss within 1e-6 of its value: XLA sums the mean probability in
  another order than torch;
* ``moe_ffn`` in float32 within 1e-5 of the output's scale, against both
  of JAX's dispatch paths; in bf16 within 4 bf16 ulps of the scale, on the
  tokens off a routing tie (``_torch_parity.moe_tie_mask``): JAX's
  ``silu`` rounds its sigmoid to bf16 before the product, the port
  rounds once, as the dense FFN's test says;
* row 12's plain version against a float64 einsum over the
  capacity-padded buffer: float32 within 1e-5 of each run's scale, bf16
  within 4 bf16 ulps (three roundings: the products, the activation, the
  GLU product).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import MoECfg as JMoECfg
from repro.models import ffn as jffn
from repro.models.registry import build_model as jbuild
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoECfg as TMoECfg
from repro_torch.kernels import moe as kmoe
from repro_torch.kernels import ref
from repro_torch.models import ffn as tffn
from repro_torch.models.convert import jax_layout_views, params_from_jax, to_jax_layout

from _torch_parity import bf16_ulp, moe_inputs, moe_mlp64, moe_tie_mask

D = 128
ACTS = ("swiglu", "geglu", "gelu", "relu2")


@pytest.fixture(autouse=True)
def _no_grad():
    """Serving: float32 parameters are trainable, and no test here needs
    their gradients."""
    with torch.no_grad():
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---- routing ----------------------------------------------------------------

def _jax_route(probs, cfg, capacity):
    """``repro/models/ffn.py`` ``moe_ffn``'s routing, line for line, from
    its probabilities: ``(topv, topi, pos, keep, ce)`` per choice."""
    n, g, E = probs.shape
    k = cfg.top_k
    topv, topi = jax.lax.top_k(probs, k)
    if cfg.router_norm_topk:
        topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    assign = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    pos = jnp.cumsum(assign.reshape(n, g * k, E), axis=1)
    pos = (pos - 1).reshape(n, g, k, E)
    keep = (pos < capacity) & (assign > 0)
    keep_k = jnp.take_along_axis(keep, topi[..., None], axis=-1)[..., 0]
    pos_k = jnp.take_along_axis(pos, topi[..., None], axis=-1)[..., 0].astype(jnp.int32)
    ce = assign.sum(2).mean(axis=(0, 1))
    return topv, topi, pos_k, keep_k, ce


def _logits(kind, rng, n, g, E):
    if kind == "ties":  # coarse values: many exact ties, the lower expert must win
        return np.round(rng.standard_normal((n, g, E)) * 2.0) / 4.0
    if kind == "uniform":  # zero rows (JAX's padding rows) beside random ones
        lg = rng.standard_normal((n, g, E))
        lg[:, ::2] = 0.0
        return lg
    if kind == "skewed":  # most tokens want expert 3: its queue overflows
        lg = rng.standard_normal((n, g, E))
        lg[..., 3] += 4.0
        return lg
    return rng.standard_normal((n, g, E)) * 2.0


ROUTING_CASES = {
    # name: (E, k, n, g, logits kind, capacity factor or "no_drop", router_norm_topk)
    "ties_e64_k6": (64, 6, 2, 48, "ties", 1.25, True),
    "uniform_e64_k6": (64, 6, 1, 40, "uniform", 1.25, True),
    "overflow_e8_k2": (8, 2, 3, 32, "skewed", 1.0, True),
    "no_drop_e16_k4": (16, 4, 2, 24, "skewed", "no_drop", True),
    "no_norm_e8_k3": (8, 3, 2, 30, "ties", 1.25, False),
    "one_token_e64_k6": (64, 6, 1, 1, "random", 1.25, True),
}


def _routing_case(name):
    E, k, n, g, kind, cap, norm = ROUTING_CASES[name]
    cf = 1.25 if cap == "no_drop" else cap
    kw = dict(n_experts=E, top_k=k, d_ff_expert=16, capacity_factor=cf, router_norm_topk=norm)
    tcfg = TMoECfg(**kw)
    capacity = tffn.moe_capacity(tcfg, g, cap == "no_drop")
    rng = np.random.default_rng(sum(map(ord, name)))
    lg = _logits(kind, rng, n, g, E)
    lg = np.array(jnp.asarray(lg, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    return JMoECfg(**kw), tcfg, capacity, lg


def _check_routing(want, got, counts_inv, exact_topv: bool):
    topv, topi, pos, keep, ce = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got.topi.numpy(), topi)
    np.testing.assert_array_equal(got.pos.numpy(), pos)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal((got.counts.sum(0).float() * counts_inv).numpy(), ce)
    if exact_topv:
        np.testing.assert_array_equal(got.topv.numpy(), topv)
    else:
        np.testing.assert_array_max_ulp(got.topv.numpy(), topv, maxulp=4)


@pytest.mark.parametrize("name", sorted(ROUTING_CASES))
def test_routing_from_the_same_probabilities_is_bit_identical(name):
    jcfg, tcfg, capacity, lg = _routing_case(name)
    probs = np.array(jax.nn.softmax(jnp.asarray(lg), axis=-1))
    want = _jax_route(jnp.asarray(probs), jcfg, capacity)
    got = tffn.route(torch.from_numpy(probs), tcfg, capacity)
    n, g, _ = probs.shape
    _check_routing(want, got, 1.0 / (n * g), exact_topv=True)
    assert got.pos.dtype == torch.int32 and got.counts.dtype == torch.int32
    if name.startswith("uniform"):  # a zero row picks experts 0..k-1, in order
        np.testing.assert_array_equal(got.topi[0, 0].numpy(), np.arange(tcfg.top_k))
    if name.startswith("overflow"):
        assert not bool(got.keep.all())  # the case drops pairs
    if name.startswith("no_drop"):
        assert bool(got.keep.all())


@pytest.mark.parametrize("name", sorted(ROUTING_CASES))
def test_routing_from_the_same_logits_matches(name):
    jcfg, tcfg, capacity, lg = _routing_case(name)
    want = _jax_route(jax.nn.softmax(jnp.asarray(lg), axis=-1), jcfg, capacity)
    probs = torch.softmax(torch.from_numpy(lg), dim=-1)
    got = tffn.route(probs, tcfg, capacity)
    n, g, _ = lg.shape
    _check_routing(want, got, 1.0 / (n * g), exact_topv=False)


def test_stable_sort_orders_ties_unlike_topk():
    """The reason for the sort: ``torch.topk`` need not put the lower index
    first on equal values, ``jax.lax.top_k`` does."""
    probs = torch.full((1, 1, 64), 1.0 / 64)
    r = tffn.route(probs, TMoECfg(n_experts=64, top_k=6, d_ff_expert=8), 10)
    assert r.topi[0, 0].tolist() == [0, 1, 2, 3, 4, 5]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 6)[1])[0, 0].tolist() == [
        0, 1, 2, 3, 4, 5]


# ---- moe_ffn -----------------------------------------------------------------

def _moe_params(cfg_kw, act, seed=0):
    jcfg = JMoECfg(**cfg_kw)
    p = jffn.init_moe(jax.random.PRNGKey(seed), D, jcfg, act)
    return jcfg, TMoECfg(**cfg_kw), p, jax.tree.map(np.asarray, p)


def _port_moe(tree, dtype):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    shared = None
    if "shared" in tree:
        s = tree["shared"]
        shared = tffn.DenseFFN(t(s["w_in"]), t(s["w_out"]), t(s["w_gate"]) if "w_gate" in s
                               else None)
    return tffn.MoEFFN(t(tree["router"]), t(tree["w_in"]), t(tree["w_out"]),
                       t(tree["w_gate"]) if "w_gate" in tree else None, shared)


MOE_KW = dict(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1, d_ff_shared=64)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_ffn_matches_jax_in_float32(act, gather, no_drop):
    # G = 74 tokens in groups of 32: three groups, the last padded by 22
    # zero rows; C = 10 of 8 pairs an expert on average, so pairs drop
    jcfg, tcfg, p, tree = _moe_params(MOE_KW, act, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 37, D)).astype(np.float32)
    jy, jaux = jffn.moe_ffn(p, jnp.asarray(x), jcfg, act, group_size=32, no_drop=no_drop,
                            gather_dispatch=gather)
    ref.calls = 0
    ty, taux = tffn.moe_ffn(_port_moe(tree, torch.float32), torch.from_numpy(x), tcfg, act,
                            group_size=32, no_drop=no_drop, gather_dispatch=gather)
    assert ref.calls == 1  # the expert MLP took row 12's plain version, once
    assert ty.shape == (2, 37, D) and ty.dtype == torch.float32
    scale = float(np.abs(_np(jy)).max())
    assert float(np.abs(_np(ty) - _np(jy)).max()) <= 1e-5 * scale
    assert abs(float(taux["moe_aux"]) - float(jaux["moe_aux"])) <= 1e-6 * abs(float(jaux["moe_aux"]))


def test_moe_ffn_drops_pairs_at_capacity():
    """The float32 case above at its capacity really drops pairs, and a
    dropped pair is the one JAX drops: the output equals JAX's, and differs
    from the drop-free output on some tokens."""
    jcfg, tcfg, p, tree = _moe_params(MOE_KW, "swiglu", seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 37, D)).astype(np.float32))
    params = _port_moe(tree, torch.float32)
    y_cap, _ = tffn.moe_ffn(params, x, tcfg, "swiglu", group_size=32)
    y_all, _ = tffn.moe_ffn(params, x, tcfg, "swiglu", group_size=32, no_drop=True)
    assert not torch.equal(y_cap, y_all)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("gather", [False, True])
def test_moe_ffn_matches_jax_in_bf16_off_routing_ties(act, gather):
    jcfg, tcfg, p, tree = _moe_params(MOE_KW, act, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 37, D)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = jffn.moe_ffn(p, xb, jcfg, act, group_size=32, gather_dispatch=gather)
    params = _port_moe(tree, torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ty, taux = tffn.moe_ffn(params, xt, tcfg, act, group_size=32, gather_dispatch=gather)
    assert ty.dtype == torch.bfloat16
    logits64 = xt.double().reshape(-1, D) @ params.router.double()
    ties = moe_tie_mask(logits64.numpy(), tcfg.top_k)
    assert ties.mean() < 0.25, ties.mean()
    err = np.abs(_np(ty) - _np(jy)).reshape(-1, D).max(-1)
    scale = float(np.abs(_np(jy)).max())
    assert err[~ties].max() <= 4 * bf16_ulp(scale), (err[~ties].max(), bf16_ulp(scale))
    if not ties.any():  # the same routing: the same aux
        assert abs(float(taux["moe_aux"]) - float(jaux["moe_aux"])) <= 1e-6 * float(jaux["moe_aux"])


def test_moe_rows_processed_alone_match_under_no_drop():
    """``tests/test_models.py``'s ``test_moe_no_drop_capacity`` on the port:
    no drops and no coupling between tokens under ``no_drop``; and the
    port's output is JAX's."""
    cfg_kw = dict(n_experts=4, top_k=2, d_ff_expert=32)
    jcfg = JMoECfg(**cfg_kw)
    tcfg = TMoECfg(**cfg_kw)
    p = jffn.init_moe(jax.random.PRNGKey(0), 64, jcfg, "swiglu")
    params = _port_moe(jax.tree.map(np.asarray, p), torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 1, 64)).astype(np.float32))
    y1, _ = tffn.moe_ffn(params, x, tcfg, "swiglu", no_drop=True)
    rows = torch.cat([tffn.moe_ffn(params, x[i:i + 1], tcfg, "swiglu", no_drop=True)[0]
                      for i in range(8)])
    np.testing.assert_allclose(y1.numpy(), rows.numpy(), rtol=2e-5, atol=2e-5)
    jy, _ = jffn.moe_ffn(p, jnp.asarray(x.numpy()), jcfg, "swiglu", no_drop=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_moe_ffn_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="ffn_act"):
        tffn.init_moe(torch.Generator().manual_seed(0), 16, TMoECfg(4, 2, 8), "tanh")


def test_init_moe_draw_order_and_shapes():
    """JAX's leaves and shapes, drawn in the order router, w_in, w_out,
    w_gate, shared (the dense FFN's own order), each cast once."""
    cfg = TMoECfg(n_experts=4, top_k=2, d_ff_expert=8, n_shared=2, d_ff_shared=6)
    p = tffn.init_moe(torch.Generator().manual_seed(7), 16, cfg, "swiglu")
    gen = torch.Generator().manual_seed(7)
    from repro_torch.models.common import dense_init

    want = [dense_init((16, 4), gen, scale=0.02), dense_init((4, 16, 8), gen),
            dense_init((4, 8, 16), gen), dense_init((4, 16, 8), gen),
            dense_init((16, 12), gen), dense_init((12, 16), gen), dense_init((16, 12), gen)]
    got = [p.router, p.w_in, p.w_out, p.w_gate, p.shared.w_in, p.shared.w_out, p.shared.w_gate]
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    jp = jffn.init_moe(jax.random.PRNGKey(0), 16, JMoECfg(4, 2, 8, n_shared=2, d_ff_shared=6),
                       "swiglu")
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == {
        k: v.shape for k, v in _flat(jax.tree.map(np.asarray, jp)).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---- row 12's plain version --------------------------------------------------

PLAIN_COUNTS = {
    "empty_experts": [[3, 0, 5, 0, 1], [0, 0, 2, 7, 0]],
    "one_expert_full": [[0, 0, 9, 0, 0]],
    "all_empty_but_one_row": [[0, 0, 0, 0, 1], [0, 0, 0, 0, 0]],
}


def _padded64(xc, offsets, counts, C, w_in, w_gate, w_out, act):
    """JAX's capacity-padded form: ``[n, E, C, d]`` filled from the compact
    runs, the expert MLP as float64 einsums, read back per run."""
    n, E = np.asarray(counts).shape
    d = xc.shape[1]
    off = offsets.tolist()
    xe = torch.zeros((n, E, C, d), dtype=torch.float64)
    for gi in range(n):
        for e in range(E):
            a, b = off[e * n + gi], off[e * n + gi + 1]
            xe[gi, e, :b - a] = xc[a:b].double()
    h = torch.einsum("necd,edf->necf", xe, w_in.double())
    if w_gate is not None:
        g = torch.einsum("necd,edf->necf", xe, w_gate.double())
        if act == "swiglu":
            h = h * g / (1.0 + torch.exp(-g))
        else:
            h = h * 0.5 * g * (1.0 + torch.tanh((2.0 / np.pi) ** 0.5 * (g + 0.044715 * g ** 3)))
    elif act == "gelu":
        h = 0.5 * h * (1.0 + torch.tanh((2.0 / np.pi) ** 0.5 * (h + 0.044715 * h ** 3)))
    else:
        h = torch.clamp_min(h, 0.0) ** 2
    ye = torch.einsum("necf,efd->necd", h, w_out.double())
    out = torch.zeros((xc.shape[0], d), dtype=torch.float64)
    for gi in range(n):
        for e in range(E):
            a, b = off[e * n + gi], off[e * n + gi + 1]
            out[a:b] = ye[gi, e, :b - a]
    return out


@pytest.mark.parametrize("case", sorted(PLAIN_COUNTS))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_plain_version_matches_a_float64_padded_einsum(case, act, dtype):
    counts = PLAIN_COUNTS[case]
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    glu = act in ("swiglu", "geglu")
    xc, offsets, w_in, w_gate, w_out = moe_inputs(11, counts, 64, 32, glu=glu, dtype=dt)
    rows_bound = int(np.max(counts))
    ref.calls = 0
    got = kmoe.moe_expert_mlp(xc, offsets, rows_bound, w_in, w_gate, w_out, act)
    assert ref.calls == 1 and got.dtype == dt and got.shape == xc.shape
    want = _padded64(xc, offsets, counts, rows_bound, w_in, w_gate, w_out, act)
    np.testing.assert_allclose(moe_mlp64(xc, offsets, w_in, w_gate, w_out, act).numpy(),
                               want.numpy(), rtol=1e-12, atol=1e-12)
    R = int(np.sum(counts))
    assert not torch.isnan(got[:R]).any()
    assert torch.equal(got[R:], torch.zeros_like(got[R:]))  # past the runs: untouched zeros
    for a, b in zip(offsets.tolist()[:-1], offsets.tolist()[1:]):
        if a == b:
            continue
        run, run64 = got[a:b].double(), want[a:b]
        scale = float(run64.abs().max())
        tol = 1e-5 * scale if dtype == "f32" else 4 * bf16_ulp(scale)
        assert float((run - run64).abs().max()) <= tol, (a, b, float((run - run64).abs().max()))


def test_moe_plain_version_refuses_a_run_over_the_bound():
    xc, offsets, w_in, w_gate, w_out = moe_inputs(1, [[4, 1]], 32, 16)
    with pytest.raises(ValueError, match="bound"):
        kmoe.moe_expert_mlp(xc, offsets, 3, w_in, w_gate, w_out, "swiglu")


def test_moe_cpu_tensors_never_reach_the_kernel():
    """On CPU tensors the wrapper takes the plain version and launches
    nothing (the kernel call refuses them)."""
    xc, offsets, w_in, w_gate, w_out = moe_inputs(2, [[2, 3]], 128, 64, dtype=torch.bfloat16)
    kmoe.moe_launches = 0
    ref.calls = 0
    kmoe.moe_expert_mlp(xc, offsets, 3, w_in, w_gate, w_out, "swiglu")
    assert (kmoe.moe_launches, ref.calls) == (0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kmoe.moe_expert_mlp_kernel_call(xc, offsets, 3, w_in, w_gate, w_out, "swiglu")


# ---- convert: the MoE leaves under JAX's names --------------------------------

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "dbrx_132b"])
def test_convert_round_trip_of_moe_leaves(arch):
    jcfg, tcfg = jreg.get_reduced(arch), treg.get_reduced(arch)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(3)))
    params = params_from_jax(tree, tcfg, device="cpu")
    back = to_jax_layout(params, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    moe_group = tree["groups"][-1]["p0"]["moe"]
    assert ("shared" in moe_group) == (tcfg.moe.n_shared > 0)
    views = jax_layout_views(params, tcfg)
    leaf = views["groups"][-1]["p0"]["moe"]["w_in"]
    assert leaf.shape == moe_group["w_in"].shape
    np.testing.assert_array_equal(np.asarray(leaf), moe_group["w_in"])
    layer = params.groups[-1]["p0"][0]
    assert layer.ffn is None and layer.moe is not None
