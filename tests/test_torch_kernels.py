"""The port's kernel ops against the JAX kernels, on their plain versions.

On this CPU the port's wrappers take the plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do, and its jnp oracles.  Tolerances:
ray-cast counts are int32 and must be exactly equal; rank counts must be
exactly equal on users with no near-tie competitor and within ±1 on the
rest (a strict-< verdict at a 1-ulp boundary is arbitrary).  The CUDA
kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py``, which skips without a card, and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.brute import rank_counts_np
from repro.core.geometry import Rect, points_in_tris_np
from repro.core.scene import build_scene
from repro.kernels import ops as jops
from repro.kernels.ref import raycast_count_ref as j_raycast_count_ref
from repro_torch.kernels import build, ops, rank_count, raycast, ref

from tests._torch_parity import edge_tie_mask, non_tie_mask

RECT = Rect(0.0, 0.0, 1.0, 1.0)


def _scene(seed, M, k=5):
    rng = np.random.default_rng(seed)
    F = rng.random((max(M, 2), 2))
    return build_scene(F, 0, k, RECT, strategy="none"), rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_users", [1, 7, 1000])
@pytest.mark.parametrize("n_fac", [2, 40, 130])
def test_raycast_plain_matches_jax_kernel(n_users, n_fac):
    sc, rng = _scene(n_users * 1000 + n_fac, n_fac)
    U = rng.random((n_users, 2)).astype(np.float32)
    got = ops.raycast_count(_t(U[:, 0]), _t(U[:, 1]), _t(sc.coeffs)).numpy()
    pallas = np.asarray(
        jops.raycast_count(U[:, 0], U[:, 1], sc.coeffs, backend="pallas", interpret=True)
    )
    jref = np.asarray(j_raycast_count_ref(U[:, 0], U[:, 1], sc.coeffs))
    host = points_in_tris_np(U.astype(np.float64), sc.coeffs.astype(np.float64)).sum(1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jref)
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("n_users,q_n", [(5, 1), (300, 3), (2500, 2)])
def test_raycast_batch_plain_matches_jax_kernel(n_users, q_n):
    rng = np.random.default_rng(n_users + q_n)
    F = rng.random((60, 2))
    coeffs = np.stack(
        [build_scene(F, qi, 6, RECT, pad_to=128).coeffs for qi in range(q_n)]
    )
    U = rng.random((n_users, 2)).astype(np.float32)
    got = ops.raycast_count_batch(_t(U[:, 0]), _t(U[:, 1]), _t(coeffs)).numpy()
    want = np.asarray(
        jops.raycast_count_batch(U[:, 0], U[:, 1], coeffs, backend="pallas", interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jops.raycast_count_batch(U[:, 0], U[:, 1], coeffs, backend="ref"))
    )


def test_raycast_plain_is_user_chunked_like_the_reference():
    """Above the chunk size both packages split users.  Counts equal the
    JAX oracle's off rounding-level ties, where XLA's fused multiply-add
    and the port's rounding contract may split; this instance holds one
    such user, and there the port agrees with the float64 oracle."""
    sc, rng = _scene(3, 40)
    U = rng.random((ops._USER_CHUNK + 77, 2)).astype(np.float32)
    xs, ys = _t(U[:, 0]), _t(U[:, 1])
    got = ops.raycast_count(xs, ys, _t(sc.coeffs)).numpy()
    want = np.asarray(jops.raycast_count(U[:, 0], U[:, 1], sc.coeffs, backend="ref"))
    host = points_in_tris_np(U.astype(np.float64), sc.coeffs.astype(np.float64)).sum(1)
    ties = edge_tie_mask(U[:, 0], U[:, 1], sc.coeffs[: sc.n_tris])
    assert ties.sum() <= 3
    np.testing.assert_array_equal(got[~ties], want[~ties])
    np.testing.assert_array_equal(got, host)
    unchunked = ref.raycast_count_ref(xs, ys, _t(sc.coeffs)).numpy()
    np.testing.assert_array_equal(got, unchunked)


def test_raycast_padding_rows_count_nothing():
    sc, rng = _scene(21, 30)
    U = _t(rng.random((400, 2)).astype(np.float32))
    real = _t(sc.coeffs[: sc.n_tris])
    padded = _t(np.concatenate([sc.coeffs, sc.coeffs[-1:].repeat(200, axis=0)]))
    assert sc.n_tris < len(sc.coeffs)  # the scene itself carries padding rows
    a = ops.raycast_count(U[:, 0], U[:, 1], real)
    for cf in (_t(sc.coeffs), padded):
        assert torch.equal(ops.raycast_count(U[:, 0], U[:, 1], cf), a)


def test_empty_inputs():
    x = torch.zeros(0)
    assert ops.raycast_count(x, x, torch.zeros(5, 3, 3)).shape == (0,)
    assert ops.raycast_count_batch(x, x, torch.zeros(2, 5, 3, 3)).shape == (2, 0)
    xs = torch.rand(9)
    assert ops.raycast_count_batch(xs, xs, torch.zeros(0, 5, 3, 3)).shape == (0, 9)
    assert torch.equal(ops.raycast_count(xs, xs, torch.zeros(0, 3, 3)), torch.zeros(9, dtype=torch.int32))
    assert ops.rank_count(torch.zeros(0, 2), torch.rand(4, 2), torch.rand(2)).shape == (0,)
    assert torch.equal(
        ops.rank_count(torch.rand(6, 2), torch.zeros(0, 2), torch.rand(2)),
        torch.zeros(6, dtype=torch.int32),
    )
    assert ops.rank_count_batch(torch.zeros(0, 2), torch.rand(4, 2), torch.rand(3, 2)).shape == (3, 0)


def test_rounding_contract_matches_numpy_order():
    """The plain version rounds ((x*a) + (y*b)) + c once per operation: its
    edge test equals numpy's float32 evaluation in that order, element for
    element, on values where an FMA would round differently."""
    rng = np.random.default_rng(0)
    xs = rng.random(2000).astype(np.float32)
    ys = rng.random(2000).astype(np.float32)
    cf = rng.normal(size=(50, 3, 3)).astype(np.float32)
    # put the third edge of every triangle exactly through a user, so many
    # edge values sit at or next to 0 where rounding decides
    cf[:, 2, 2] = -(xs[:50] * cf[:, 2, 0] + ys[:50] * cf[:, 2, 1])
    e = (xs[:, None, None] * cf[None, :, :, 0] + ys[:, None, None] * cf[None, :, :, 1]) + cf[None, :, :, 2]
    want = np.all(e >= np.float32(0), axis=-1).sum(-1)
    got = ops.raycast_count(_t(xs), _t(ys), _t(cf)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_users,n_fac", [(1, 1), (33, 9), (700, 80)])
def test_rank_count_plain_matches_jax_kernel(n_users, n_fac):
    rng = np.random.default_rng(n_users + n_fac)
    U = rng.random((n_users, 2))
    F = rng.random((n_fac, 2))
    qi = int(rng.integers(0, n_fac))
    got = ops.rank_count(_t(U), _t(F), _t(F[qi]), exclude=qi).numpy()
    pallas = np.asarray(jops.rank_count(U, F, F[qi], exclude=qi, backend="pallas", interpret=True))
    want = rank_counts_np(U, F, F[qi], exclude=qi)
    ok = non_tie_mask(U, F, qi)
    for other in (pallas, want):
        np.testing.assert_array_equal(got[ok], other[ok])
        assert np.all(np.abs(got - other) <= 1)


def test_rank_count_batch_matches_jax():
    rng = np.random.default_rng(4)
    U, F = rng.random((500, 2)), rng.random((40, 2))
    q_pts = np.concatenate([F[[3, 9]], rng.random((1, 2))])
    excl = [3, 9, None]
    got = ops.rank_count_batch(_t(U), _t(F), _t(q_pts), exclude=excl).numpy()
    want = np.asarray(jops.rank_count_batch(U, F, q_pts, exclude=excl))
    assert got.shape == (3, 500) and got.dtype == np.int32
    for i, qi in enumerate([3, 9]):
        ok = non_tie_mask(U, F, qi)
        np.testing.assert_array_equal(got[i][ok], want[i][ok])
    assert np.all(np.abs(got - want) <= 1)


def test_rank_count_exclude_leaves_caller_tensors_untouched():
    F = torch.rand(1, 2)
    before = F.clone()
    ops.rank_count(torch.rand(5, 2), F, F[0], exclude=0)
    assert torch.equal(F, before)


def test_cpu_path_takes_the_plain_version_and_no_kernel():
    sc, rng = _scene(8, 20)
    U = _t(rng.random((50, 2)).astype(np.float32))
    ref.calls = raycast.batch_launches = raycast.single_launches = rank_count.launches = 0
    ops.raycast_count(U[:, 0], U[:, 1], _t(sc.coeffs))
    ops.raycast_count_batch(U[:, 0], U[:, 1], _t(sc.coeffs[None]))
    ops.rank_count(U, U[:5], U[0])
    assert ref.calls == 3
    assert (raycast.batch_launches, raycast.single_launches, rank_count.launches) == (0, 0, 0)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_backends():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        raycast.raycast_count_batch_kernel_call(x, x, torch.zeros(1, 2, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        rank_count.rank_count_kernel_call(x, x, x, x, x)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.raycast_count(x, x, torch.zeros(2, 3, 3), backend="pallas")


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_rounding_contract_on_the_gaussian_scenario():
    """The scenario whose ties once split the JAX grid family: the port's
    plain batched count equals the JAX oracle off rounding-level ties and
    the float64 oracle wherever the float64 margin decides."""
    from repro.workloads import SCENARIOS

    w = SCENARIOS["gaussian"].generate(scale=0.1)
    coeffs = np.stack(
        [build_scene(w.facilities, q, w.k, users_hint=w.users, pad_to=256).coeffs for q in w.qs[:4]]
    )
    U = w.users.astype(np.float32)
    got = ops.raycast_count_batch(_t(U[:, 0]), _t(U[:, 1]), _t(coeffs)).numpy()
    want = np.asarray(jops.raycast_count_batch(U[:, 0], U[:, 1], coeffs, backend="ref"))
    for i in range(len(coeffs)):
        ties = edge_tie_mask(U[:, 0], U[:, 1], coeffs[i])
        assert ties.mean() < 1e-3
        np.testing.assert_array_equal(got[i][~ties], want[i][~ties])
        host = points_in_tris_np(U.astype(np.float64), coeffs[i].astype(np.float64)).sum(1)
        np.testing.assert_array_equal(got[i][~ties], host[~ties])


def _wrapper_calls():
    """Each wrapper called on host (numpy) arrays, and on the same arrays
    as CPU tensors: ``(name, call(as_array))``."""
    sc, rng = _scene(5, 12)
    U = rng.random((50, 2)).astype(np.float32)
    F = rng.random((9, 2)).astype(np.float32)
    co = sc.coeffs
    return {
        "raycast_count": lambda a: ops.raycast_count(a(U[:, 0]), a(U[:, 1]), a(co)),
        "raycast_count_batch": lambda a: ops.raycast_count_batch(
            a(U[:, 0]), a(U[:, 1]), a(np.stack([co, co]))),
        "rank_count": lambda a: ops.rank_count(a(U), a(F), a(F[2]), exclude=2),
        "rank_count_batch": lambda a: ops.rank_count_batch(a(U), a(F), a(F[:3]), exclude=[0, 1, 2]),
        "rank_count_batch_xy": lambda a: ops.rank_count_batch_xy(
            a(U[:, 0]), a(U[:, 1]), a(F), a(F[:2]), exclude=[0, 1]),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_host_arrays_go_to_the_card_never_the_plain_version(name, monkeypatch):
    """A numpy argument takes the port's default device, the card: without
    one it raises (never the plain version on the CPU), while CPU tensors
    still run the plain version."""
    call = _wrapper_calls()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = ref.calls
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call(np.asarray)
    assert ref.calls == calls
    out = call(_t)
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert ref.calls > calls
