"""The port's RkNNEngine and shims against the JAX engine, on the CPU.

Masks and counts must be exactly equal between ``repro.core.engine``
and ``repro_torch.core.engine(device="cpu")`` for every ported backend:
``dense`` and ``grid-pallas`` (the JAX side runs its Pallas kernels in
interpret mode, so only at small N), ``dense-ref``, ``grid``,
``grid-pallas-ref``, ``bvh`` (counts saturated at ``k``, as in JAX) and
``brute``.  Brute counts are distance
ranks in float32 and ties may split at one ulp, so their masks are also
held against the float64 numpy oracle.
"""

import numpy as np
import pytest
import torch

from repro.core.brute import rknn_brute_np, rknn_mono_brute_np
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro.core.geometry import Rect as JRect
from repro.core.rknn import rknn_mono_query as j_mono
from repro.core.rknn import rt_rknn_query as j_query
from repro.core.rknn import rt_rknn_query_batch as j_batch
from repro_torch.core import rknn as trknn
from repro_torch.core.backends import available_backends, get_backend
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect

from tests._torch_parity import CPU, instance

BACKENDS = ("dense", "dense-ref", "grid", "grid-pallas", "grid-pallas-ref", "bvh", "brute")
#: instance sizes per backend: the JAX dense and grid-pallas paths run
#: interpret-mode Pallas
SIZES = {
    "dense": (30, 120),
    "dense-ref": (60, 400),
    "grid": (60, 400),
    "grid-pallas": (30, 120),
    "grid-pallas-ref": (60, 400),
    "bvh": (60, 400),
    "brute": (60, 400),
}


def _pair(backend, F, U, **cfg):
    j = JEngine(F, U, JConfig(backend=backend, **cfg))
    t = RkNNEngine(F, U, RkNNConfig(backend=backend, **cfg), device=CPU)
    return j, t


def _same(a_masks, a_counts, b_masks, b_counts):
    np.testing.assert_array_equal(a_masks, b_masks)
    np.testing.assert_array_equal(a_counts, b_counts)
    assert np.asarray(a_counts).dtype == np.asarray(b_counts).dtype


def test_registry_and_default_backend():
    # the ``auto`` planner is registered last, as a meta backend: the
    # registry gains it and the concrete list does not (as in JAX)
    assert available_backends() == BACKENDS + ("auto",)
    assert trknn.BACKENDS == BACKENDS
    assert get_backend("auto").is_meta
    assert RkNNConfig().backend == "dense"
    with pytest.raises(ValueError, match="backend must be one of"):
        get_backend("nope")
    with pytest.raises(ValueError):
        RkNNEngine(np.zeros((4, 2)), np.zeros((4, 2)), RkNNConfig(backend="nope"), device=CPU)


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_and_mixed_batch_match_jax(backend):
    M, N = SIZES[backend]
    F, U, rng = instance(3, M, N)
    qs = [int(q) for q in rng.integers(0, M, 3)] + [np.array([0.4, 0.6])]
    j, t = _pair(backend, F, U)
    jb, tb = j.query_batch(qs, 4), t.query_batch(qs, 4)
    _same(jb.masks, jb.counts, tb.masks, tb.counts)
    assert tb.counts.dtype == np.int32 and tb.backend == backend
    for i, q in enumerate(qs):
        js, ts = j.query(q, 4), t.query(q, 4)
        _same(js.mask, js.counts, ts.mask, ts.counts)
        np.testing.assert_array_equal(ts.mask, tb.masks[i])
        np.testing.assert_array_equal(ts.mask, rknn_brute_np(U, F, q, 4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_matches_jax(backend):
    M, N = SIZES[backend]
    F, U, _ = instance(43, M, N)
    batches = [np.array([1, 2, 3]), np.array([4, 5])]
    j, t = _pair(backend, F, U)
    want = [m for _, m in j.stream(batches, 4)]
    got = list(t.stream(batches, 4))
    assert [b is batches[i] for i, (b, _) in enumerate(got)] == [True, True]
    for (_, g), w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t.stats.n_queries == 5 and t.stats.n_batches == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_mono_self_hit_correction_matches_jax(backend):
    P = np.random.default_rng(17).random((SIZES[backend][0], 2))
    for qi, k in ((5, 3), (20, 1)):
        a = j_mono(P, qi, k, backend=backend)
        b = trknn.rknn_mono_query(P, qi, k, backend=backend, device=CPU)
        _same(a.mask, a.counts, b.mask, b.counts)
        np.testing.assert_array_equal(b.mask, rknn_mono_brute_np(P, qi, k))
        mask_from_counts = b.counts < k
        mask_from_counts[qi] = False
        np.testing.assert_array_equal(b.mask, mask_from_counts)


def test_query_mono_from_bichromatic_engine_and_explicit_rect():
    F, U, _ = instance(23)
    rect = (-0.5, -0.5, 1.5, 1.5)
    j = JEngine(F, U, rect=JRect(*rect))
    t = RkNNEngine(F, U, rect=Rect(*rect), device=CPU)
    a, b = j.query_mono(4, 3), t.query_mono(4, 3)
    _same(a.mask, a.counts, b.mask, b.counts)
    assert b.scene.rect == Rect(*rect)
    assert t.stats.n_queries == 1 and t.stats.t_verify_s > 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_batch_normalized(backend):
    F, U, _ = instance(61, M=20)
    a = j_batch(F, U, [], 3, backend=backend)
    b = trknn.rt_rknn_query_batch(F, U, [], 3, backend=backend, device=CPU)
    assert b.masks.shape == a.masks.shape == (0, len(U))
    assert b.counts.dtype == a.counts.dtype == np.int32
    assert (b.scenes is None) == (a.scenes is None)
    nonempty = trknn.rt_rknn_query_batch(F, U, [0, 1], 3, backend=backend, device=CPU)
    if backend == "brute":
        assert nonempty.scenes is None and nonempty.per_query(0).scene is None
    else:
        assert b.scenes == [] and nonempty.per_query(0).scene is nonempty.scenes[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_exactly_representable_tie_matches_jax(backend):
    """A user exactly on the q=F[0] / F[1] bisector (coordinates exact in
    float32): every edge function is computed without rounding, so both
    packages decide the ``>= 0`` tie alike."""
    F = np.array([[0.25, 0.5], [0.75, 0.5], [0.125, 0.875], [0.875, 0.125]])
    U = np.array([[0.5, 0.5], [0.5, 0.25], [0.25, 0.25], [0.625, 0.5]])
    for k in (1, 2):
        a = j_batch(F, U, [0, 1], k, backend=backend)
        b = trknn.rt_rknn_query_batch(F, U, [0, 1], k, backend=backend, device=CPU)
        _same(a.masks, a.counts, b.masks, b.counts)
        for i, qi in enumerate([0, 1]):
            s = trknn.rt_rknn_query(F, U, qi, k, backend=backend, device=CPU)
            np.testing.assert_array_equal(s.mask, b.masks[i])


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 10), (3, 25)])
def test_core_instances_match_jax_and_brute(seed, k):
    F, U, rng = instance(seed)
    qi = int(rng.integers(0, len(F)))
    truth = rknn_brute_np(U, F, qi, k)
    for backend in ("dense-ref", "brute"):
        a = j_query(F, U, qi, k, backend=backend)
        b = trknn.rt_rknn_query(F, U, qi, k, backend=backend, device=CPU)
        _same(a.mask, a.counts, b.mask, b.counts)
        np.testing.assert_array_equal(b.mask, truth)


def test_dense_kernel_path_matches_jax_pallas_at_small_n():
    F, U, rng = instance(0, M=25, N=150)
    a = j_query(F, U, 4, 3, backend="dense")
    b = trknn.rt_rknn_query(F, U, 4, 3, device=CPU)
    assert b.backend == "dense"
    _same(a.mask, a.counts, b.mask, b.counts)


def test_scene_cache_amortizes_batch_filter_phase():
    F, U, rng = instance(31, M=120, N=2000)
    qs = [int(q) for q in rng.integers(0, len(F), 8)]
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense-ref", batch_cache=0), device=CPU)
    cold = eng.query_batch(qs, 5)
    assert eng.scene_cache.misses == len(set(qs))
    warm = eng.query_batch(qs, 5)
    assert eng.scene_cache.hits >= len(qs)
    assert warm.t_filter_s < cold.t_filter_s
    np.testing.assert_array_equal(cold.masks, warm.masks)
    np.testing.assert_array_equal(
        cold.masks, j_batch(F, U, qs, 5, backend="dense-ref").masks
    )


def test_batch_cache_collapses_repeat_workload_and_keeps_the_stack_on_device():
    F, U, rng = instance(37)
    qs = [int(q) for q in rng.integers(0, len(F), 6)]
    eng = RkNNEngine(F, U, device=CPU)
    a = eng.query_batch(qs, 4)
    b = eng.query_batch(qs, 4)
    assert eng.stats.batch_cache_hits == 1
    _same(a.masks, a.counts, b.masks, b.counts)
    (_req, prepared, _scenes), = [v for v in eng._snap.batch_cache._store.values()]
    assert isinstance(prepared, torch.Tensor) and prepared.device == CPU
    c = eng.query_batch(qs, 5)  # a different k is a different workload
    assert eng.stats.batch_cache_hits == 1
    np.testing.assert_array_equal(c.masks, j_batch(F, U, qs, 5, backend="dense-ref").masks)


def test_pad_bucket_is_sticky_power_of_two():
    F, U, rng = instance(41, M=80)
    eng = RkNNEngine(F, U, device=CPU)
    eng.query_batch([0, 1, 2], 3)
    b1 = eng._pad_bucket
    assert b1 & (b1 - 1) == 0
    eng.query_batch([3, 4], 2)
    assert eng._pad_bucket >= b1
    j = JEngine(F, U)
    j.query_batch([0, 1, 2], 3)
    assert j._pad_bucket == b1


def test_stream_reraises_producer_exception():
    F, U, _ = instance(47)
    eng = RkNNEngine(F, U, device=CPU)

    def bad_batches():
        yield [0, 1]
        raise RuntimeError("batch source failed")

    stream = eng.stream(bad_batches(), 3)
    next(stream)
    with pytest.raises(RuntimeError, match="batch source failed"):
        for _ in stream:
            pass
    with pytest.raises(IndexError):
        for _ in eng.stream([[0], [len(F) + 5]], 3):
            pass


def test_default_device_is_cuda_and_never_falls_back():
    F, U, _ = instance(1, M=10, N=20)
    if torch.cuda.is_available():
        assert RkNNEngine(F, U).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        RkNNEngine(F, U)
    with pytest.raises(RuntimeError, match="cuda"):
        trknn.rt_rknn_query(F, U, 0, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        trknn.rknn_mono_query(F, 0, 3)


@pytest.mark.parametrize(
    "field,value",
    [("online_recalibration", True), ("flight_recorder", True), ("warm_store", "store")],
)
def test_unported_config_fields_raise(field, value, tmp_path):
    """No field of the JAX config is left unported: the port's config has
    every one of them, and each is accepted and runs its subsystem —
    ``online_recalibration`` (held in ``tests/test_torch_planner.py``),
    ``flight_recorder`` arms a recorder writing under ``flight_dir``, and a
    ``warm_store`` with no store behind it leaves a cold engine that
    reports why."""
    import dataclasses

    from repro_torch.obs import FlightRecorder

    assert ({f.name for f in dataclasses.fields(RkNNConfig)}
            == {f.name for f in dataclasses.fields(JConfig)})
    if field == "warm_store":
        value = str(tmp_path / value)
    cfg = RkNNConfig(**{field: value}, flight_dir=str(tmp_path / "flight"))
    assert getattr(cfg, field) == value
    F, U, _ = instance(1, M=20, N=100)
    eng = RkNNEngine(F, U, cfg, device=CPU)
    if field == "flight_recorder":
        assert isinstance(eng.flight, FlightRecorder) and eng.flight.dir == cfg.flight_dir
    if field == "warm_store":
        assert "FileNotFoundError" in eng.persist_info["error"]
    assert eng.query(0, 3).mask.shape == (len(U),)
