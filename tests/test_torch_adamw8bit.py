"""The port's 8-bit AdamW (``repro_torch.optim.adamw8bit``) against the JAX
package's ``repro.optim.adamw8bit``, on the CPU.

``quantize_blockwise`` / ``dequantize_blockwise`` on leaves of 1, 127,
128, 129 and 7 x 99 elements, signed and unsigned: the int8 codes, the
scales and the round trip bit-identical to JAX's (measured: 0 codes
apart).  Three updates of a two-leaf tree against JAX's: the parameters
within 4 float32 ulps of their scale (measured 2: the global norm is a
sum in another order, so the clip's scale may differ by an ulp), the
codes within 1 and the scales within 4 ulps (measured: equal codes, a few
scales one ulp apart).  Then the ports of ``tests/test_substrate.py``'s
8-bit tests: the round-trip bound, a quadratic problem that tracks
float32 AdamW, and under 2.2 bytes of moments a parameter.  On the CPU
the update runs the plain version of row 11 (``kernels/ref.py``
``adamw8bit_ref``), once a step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim import adamw as jadamw
from repro.optim import adamw8bit as j8
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import ref
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import adamw8bit as t8

SHAPES = [(1,), (127,), (128,), (129,), (7, 99)]
F32_ULP = 2.0 ** -23


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_blockwise_matches_jax(shape, signed):
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    x = rng.normal(0, 0.01, shape).astype(np.float32)
    if not signed:
        x = np.abs(x)
    jq, js = j8.quantize_blockwise(jnp.asarray(x), signed=signed)
    tq, ts = t8.quantize_blockwise(torch.from_numpy(x), signed=signed)
    nb = -(-x.size // 128)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (nb, 128) and tuple(ts.shape) == (nb,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the padded tail quantizes as zeros: 0 signed, -128 unsigned
    tail = tq.numpy().reshape(-1)[x.size:]
    assert (tail == (0 if signed else -128)).all()
    back = t8.dequantize_blockwise(tq, ts, shape, signed=signed)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(j8.dequantize_blockwise(jq, js, shape, signed=signed)))


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 30)).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32)}


def test_adamw8bit_updates_match_jax():
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip=0.3, warmup_steps=2, total_steps=5)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p0 = _tree(1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = j8.adamw8bit_init(jp), t8.adamw8bit_init(tp)
    for k in p0:
        for f in ("mq", "ms", "vq", "vs"):
            np.testing.assert_array_equal(ts["m8"][k][f].numpy(), np.asarray(js["m8"][k][f]))
    for i in range(3):
        g = _tree(10 + i)
        ref.calls = kadamw.adamw8bit_launches = 0
        jp, js, jm = j8.adamw8bit_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp, ts, tm = t8.adamw8bit_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                                         tcfg)
        assert ref.calls == 1 and kadamw.adamw8bit_launches == 0
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 4 * F32_ULP * abs(float(jm[key]))
        for k in p0:
            scale = float(np.abs(np.asarray(jp[k])).max())
            assert np.abs(tp[k].numpy() - np.asarray(jp[k])).max() <= 4 * F32_ULP * scale, (i, k)
            for f in ("mq", "vq"):
                d = np.abs(ts["m8"][k][f].numpy().astype(int) - np.asarray(js["m8"][k][f]))
                assert d.max() <= 1, (i, k, f)
            for f in ("ms", "vs"):
                w = np.asarray(js["m8"][k][f])
                assert np.abs(ts["m8"][k][f].numpy() - w).max() <= 4 * F32_ULP * np.abs(w).max()


def test_adamw8bit_update_is_in_place():
    p = {"w": torch.zeros(300)}
    st = t8.adamw8bit_init(p)
    ids = [p["w"].data_ptr()] + [t.data_ptr() for t in st["m8"]["w"].values()]
    cfg = tadamw.AdamWConfig(lr=0.1, warmup_steps=0, schedule="constant")
    p2, st2, _ = t8.adamw8bit_update(p, {"w": torch.ones(300)}, st, cfg)
    assert p2 is p and st2 is st
    assert [p["w"].data_ptr()] + [t.data_ptr() for t in st["m8"]["w"].values()] == ids
    assert float(p["w"][0]) == pytest.approx(-0.1, rel=1e-5)


# the counterparts of tests/test_substrate.py's 8-bit tests

def test_adamw8bit_quantize_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.01, (7, 99)).astype(np.float32))
    q, s = t8.quantize_blockwise(x, signed=True)
    back = t8.dequantize_blockwise(q, s, x.shape, signed=True)
    assert float((back - x).abs().max()) <= float(s.max()) / 2 + 1e-7
    v = x.abs()
    qv, sv = t8.quantize_blockwise(v, signed=False)
    backv = t8.dequantize_blockwise(qv, sv, v.shape, signed=False)
    assert float((backv - v).abs().max()) <= float(sv.max()) / 2 + 1e-7


def test_adamw8bit_tracks_fp32_adam():
    """A quadratic toy problem converges under int8 moments within a few
    percent of float32 AdamW."""
    cfg = tadamw.AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
                             total_steps=200, schedule="constant")
    target = torch.from_numpy(np.random.default_rng(1).normal(0, 1, 256).astype(np.float32))

    def run(update, init):
        p = {"w": torch.zeros(256)}
        st = init(p)
        for _ in range(150):
            p, st, _ = update(p, {"w": p["w"] - target}, st, cfg)
        return float(torch.mean((p["w"] - target) ** 2))

    loss8 = run(t8.adamw8bit_update, t8.adamw8bit_init)
    loss32 = run(tadamw.adamw_update, tadamw.adamw_init)
    assert loss8 < 1e-2
    assert loss8 < max(loss32 * 3.0, 1e-2)


def test_adamw8bit_state_bytes():
    """Optimizer state about 2.06 bytes a parameter against 8."""
    p = {"w": torch.zeros((1024, 1024))}
    st = t8.adamw8bit_init(p)
    n_bytes = sum(t.numel() * t.element_size() for t in st["m8"]["w"].values())
    assert n_bytes / p["w"].numel() < 2.2


def test_fused_wrappers_refuse_mixed_devices():
    p, g = torch.zeros(4), torch.zeros(4, device="meta")
    one = torch.ones(())
    with pytest.raises(ValueError, match="more than one device"):
        kadamw.adamw_fused([p], [g], [p.clone()], [p.clone()], one, one, one, one, b1=0.9,
                           b2=0.95, eps=1e-8, weight_decay=0.0)
    st = t8.adamw8bit_init({"w": p})["m8"]["w"]
    with pytest.raises(ValueError, match="more than one device"):
        kadamw.adamw8bit_fused([p], [g], [st], one, one, one, one, b1=0.9, b2=0.95, eps=1e-8,
                               weight_decay=0.0)
