"""Parity of the port's host filter phase with the JAX package.

The filter phase (InfZone pruning, occluder triangles, edge functions,
scene padding) is numpy carried over into ``repro_torch``: given the same
inputs it must give bit-identical scenes, prune statistics and data.
Tolerance: none — every array is compared for exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import scene as jscene
from repro.core.brute import rank_counts_np as j_rank_counts_np
from repro.core.brute import rknn_brute_np as j_rknn_brute_np
from repro.core.brute import rknn_mono_brute_np as j_rknn_mono_brute_np
from repro.data import spatial as jspatial
from repro.workloads import SCENARIOS
from repro_torch.core import brute as tbrute
from repro_torch.core import scene as tscene
from repro_torch.core.geometry import Rect as TRect
from repro_torch.data import spatial as tspatial

from tests._torch_parity import instance, non_tie_mask

#: |U| of every scenario at this scale is the 64-user floor of
#: ``Scenario.generate``: the users only widen the domain rect here.
SCALE = 1e-4
QUERIES_PER_SCENARIO = 2


def assert_scenes_equal(a, b):
    for field in ("tris", "coeffs", "owner", "keep", "heights", "q"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype, field
    assert (a.n_tris, a.n_occluders) == (b.n_tris, b.n_occluders)
    assert dataclasses.astuple(a.rect) == dataclasses.astuple(b.rect)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


@pytest.mark.parametrize("strategy", ["infzone", "conservative", "none"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_build_scene_bit_identical_on_every_scenario(scenario, strategy):
    w = SCENARIOS[scenario].generate(scale=SCALE)
    for q in w.qs[:QUERIES_PER_SCENARIO]:
        ref = jscene.build_scene(w.facilities, q, w.k, strategy=strategy, users_hint=w.users)
        got = tscene.build_scene(w.facilities, q, w.k, strategy=strategy, users_hint=w.users)
        assert_scenes_equal(got, ref)


def test_build_scene_point_query_and_explicit_rect():
    F, U, _ = instance(5)
    q = np.array([0.37, 0.61])
    for rect_args in (None, (-0.5, -0.5, 1.5, 1.5)):
        jr = None if rect_args is None else jscene.Rect(*rect_args)
        tr = None if rect_args is None else TRect(*rect_args)
        ref = jscene.build_scene(F, q, 5, jr, users_hint=U, pad_to=256)
        got = tscene.build_scene(F, q, 5, tr, users_hint=U, pad_to=256)
        assert_scenes_equal(got, ref)


def test_scene_from_arrays_carries_a_reference_scene():
    F, U, _ = instance(9, M=80)
    ref = jscene.build_scene(F, 4, 6, users_hint=U)
    got = tscene.scene_from_arrays(ref)
    assert isinstance(got, tscene.Scene) and isinstance(got.rect, TRect)
    assert_scenes_equal(got, ref)
    assert_scenes_equal(got, tscene.build_scene(F, 4, 6, users_hint=U))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129])
def test_pad_scene_arrays_and_next_pad(n):
    rng = np.random.default_rng(n)
    tris = rng.random((n, 3, 2))
    coeffs = rng.random((n, 3, 3))
    owner = np.arange(n, dtype=np.int32)
    for pad_to in (None, 384):
        ref = jscene.pad_scene_arrays(tris, coeffs, owner, pad_to)
        got = tscene.pad_scene_arrays(tris, coeffs, owner, pad_to)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
    assert tscene._next_pad(n) == jscene._next_pad(n)


def test_spatial_generators_bit_identical():
    assert tspatial.PAPER_DATASETS == jspatial.PAPER_DATASETS
    for seed in (0, 3):
        for name in ("road_network_points", "uniform_points", "clustered_points"):
            np.testing.assert_array_equal(
                getattr(tspatial, name)(5000, seed), getattr(jspatial, name)(5000, seed)
            )
        pts = jspatial.road_network_points(3000, seed)
        for r, g in zip(
            jspatial.facility_user_split(pts, 100, seed),
            tspatial.facility_user_split(pts, 100, seed),
        ):
            np.testing.assert_array_equal(g, r)


def test_numpy_oracles_bit_identical():
    F, U, rng = instance(11, M=50, N=300)
    for q in (7, np.array([0.2, 0.8])):
        np.testing.assert_array_equal(
            tbrute.rknn_brute_np(U, F, q, 4), j_rknn_brute_np(U, F, q, 4)
        )
    np.testing.assert_array_equal(
        tbrute.rank_counts_np(U, F, F[3], exclude=3), j_rank_counts_np(U, F, F[3], exclude=3)
    )
    np.testing.assert_array_equal(
        tbrute.rknn_mono_brute_np(F, 5, 3), j_rknn_mono_brute_np(F, 5, 3)
    )


def test_rank_counts_torch_matches_numpy_off_ties():
    """float64 torch mirror of the numpy oracle: exact on non-tie users."""
    F, U, _ = instance(13, M=70, N=500)
    comp = np.delete(F, 2, axis=0)
    got = tbrute.rank_counts_torch(
        torch.from_numpy(U), torch.from_numpy(comp), torch.from_numpy(F[2])
    ).numpy()
    want = j_rank_counts_np(U, F, F[2], exclude=2)
    ok = non_tie_mask(U, F, 2)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got[ok], want[ok])
