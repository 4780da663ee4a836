"""Scenario workload generators — the paper's hard regimes as data.

The port of ``repro.workloads.scenarios``: the same generators over the
port's :mod:`repro_torch.data.spatial`, so every workload equals the JAX
package's bit for bit at the same seed.

The paper's performance claim is *regime-dependent* (Figs 7–14): the RT
formulation wins when facilities are sparse, users are dense, or ``k`` is
large; filter–refine baselines win at dense facilities and small ``k``.
A planner that cost-dispatches between backends therefore needs workloads
that actually span those regimes — both to *calibrate* its cost models
(the JAX package's ``repro.planner.calibrate``) and to *grade* its
decisions (the ``scenario_sweep`` benchmark).

A :class:`Scenario` is a declarative shape — cardinalities, ``k``, batch
size, and point distribution — and :meth:`Scenario.generate` materializes
it into a concrete :class:`Workload` (facilities, users, query indices),
deterministically by seed.  Distributions reuse the generators in
:mod:`repro_torch.data.spatial` (road-network-like, uniform, Gaussian clusters)
plus a half-clustered/half-uniform mix that stresses grids whose cell
occupancy is skewed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.spatial import (
    clustered_points,
    facility_user_split,
    road_network_points,
    uniform_points,
)

__all__ = [
    "Scenario",
    "Workload",
    "SCENARIOS",
    "get_scenario",
    "scenario_names",
    "calibration_grid",
    "sharding_scenarios",
]


@dataclasses.dataclass
class Workload:
    """A materialized scenario: everything one batched query call needs."""

    name: str
    facilities: np.ndarray  # [F, 2] f64
    users: np.ndarray  # [U, 2] f64
    qs: list[int]  # query facility indices, len Q
    k: int

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(|F|, |U|, k, Q) — the planner's workload-shape tuple."""
        return len(self.facilities), len(self.users), self.k, len(self.qs)


def _points(distribution: str, n: int, seed: int) -> np.ndarray:
    if distribution == "road":
        return road_network_points(n, seed=seed)
    if distribution == "uniform":
        return uniform_points(n, seed=seed)
    if distribution == "clustered":
        return clustered_points(n, seed=seed)
    if distribution == "gaussian":
        # one broad Gaussian blob centred in the unit square
        rng = np.random.default_rng(seed)
        return np.clip(rng.normal(0.5, 0.15, (n, 2)), 0.0, 1.0)
    if distribution == "mixed":
        # half tight clusters, half uniform background — skewed grid occupancy
        a = clustered_points(n - n // 2, seed=seed, n_clusters=8, spread=0.01)
        b = uniform_points(n // 2, seed=seed + 1)
        out = np.concatenate([a, b])
        return out[np.random.default_rng(seed + 2).permutation(len(out))]
    raise ValueError(
        f"distribution must be road|uniform|clustered|gaussian|mixed, got {distribution!r}"
    )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative workload shape; ``generate()`` materializes it."""

    name: str
    n_facilities: int
    n_users: int
    k: int
    q: int  # batch size (number of queries)
    distribution: str = "road"
    seed: int = 0

    def generate(self, scale: float = 1.0) -> Workload:
        """Materialize at ``scale`` (multiplies |U| only — the paper scales
        datasets, not facility density; |F|, k, Q define the regime)."""
        n_u = max(int(self.n_users * scale), 64)
        pts = _points(self.distribution, self.n_facilities + n_u, self.seed)
        f, u = facility_user_split(pts, self.n_facilities, seed=self.seed)
        rng = np.random.default_rng(self.seed + 1)
        qs = [int(i) for i in rng.integers(0, len(f), self.q)]
        return Workload(self.name, f, u, qs, self.k)

    def generate_users(self, n_users: int) -> Workload:
        """Materialize at an *absolute* user count (the sharded-serving
        sweeps are specified as "10^6 users", not as a multiple of the
        regime's baseline |U|)."""
        return self.generate(scale=n_users / max(self.n_users, 1))


#: The paper's hard regimes (Figs 7–14) plus distribution ablations.
#: Cardinalities are sized so the full sweep stays tractable on CPU at
#: ``scale=1.0``; the benchmark harness scales |U| down further for CI.
SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        # sparse facilities, many users — the paper's headline RT regime
        Scenario("sparse_facility", n_facilities=60, n_users=30_000, k=10, q=16),
        # dense users at default facility density (Fig 13/14)
        Scenario("dense_user", n_facilities=500, n_users=60_000, k=10, q=16),
        # large k at default density (Fig 9) — scenes grow with k
        Scenario("large_k", n_facilities=400, n_users=12_000, k=64, q=8),
        # dense facilities, small k — where filter–refine methods win
        Scenario("dense_facility", n_facilities=2_000, n_users=8_000, k=4, q=16),
        # distribution ablations at default shape
        Scenario("clustered", n_facilities=300, n_users=20_000, k=10, q=16,
                 distribution="clustered"),
        Scenario("gaussian", n_facilities=300, n_users=20_000, k=10, q=16,
                 distribution="gaussian"),
        Scenario("uniform_mix", n_facilities=300, n_users=20_000, k=10, q=16,
                 distribution="mixed"),
    )
}


def scenario_names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"scenario must be one of {scenario_names()}, got {name!r}"
        ) from None


#: The two regimes the million-user sharded sweep runs: the
#: paper's headline RT regime (few facilities, a flood of users) and the
#: dense-user regime — the ones whose cost is verify-dominated, i.e.
#: where the user axis is the thing worth partitioning.
SHARDING_REGIMES: tuple[str, ...] = ("dense_user", "sparse_facility")


def sharding_scenarios(n_users: int) -> list[Workload]:
    """The sharded-serving sweep workloads at an absolute user count."""
    return [SCENARIOS[name].generate_users(n_users) for name in SHARDING_REGIMES]


def calibration_grid(fast: bool = True, seed: int = 0) -> list[Scenario]:
    """Synthetic shape grid the calibration harness micro-benchmarks.

    Spans the planner's feature axes — |F|, |U|, k, Q — with small absolute
    sizes (calibration measures *scaling*, the fitted power laws
    extrapolate).  ``fast`` keeps it to a handful of shapes for CI.

    Point distributions are rotated across shapes on purpose: scene size
    ``m`` is measured per workload and used as a fit feature, and with a
    single distribution ``m`` would be a near-deterministic function of
    (|F|, k) — the distribution mix decorrelates it so its exponent is
    identifiable.
    """
    if fast:
        spec = [
            (40, 1_500, 4, 1),
            (40, 1_500, 16, 4),
            (40, 6_000, 8, 8),  # sparse F, larger U — the brute-vs-RT frontier
            (300, 4_000, 4, 4),
            (300, 4_000, 16, 1),
            (300, 4_000, 48, 4),  # large k — scene size overtakes |F|
            (120, 8_000, 8, 8),
            (500, 12_000, 8, 8),  # dense users — brute's |F|·|U| wall
            (1_000, 2_000, 4, 4),  # dense facilities, small k
            # serving-batch shapes: the scenario sweep runs Q=16 — without
            # Q>8 support points the fitted Q exponent extrapolates badly
            # exactly where the planner is graded
            (60, 8_000, 10, 16),
            (400, 10_000, 10, 16),
        ]
    else:
        spec = [
            (f, u, k, q)
            for f in (40, 300, 1_200)
            for u in (1_500, 8_000, 30_000)
            for k in (4, 16, 48)
            for q in (1, 8)
        ]
    dists = ("road", "clustered", "uniform")
    scens = [
        Scenario(
            f"cal_F{f}_U{u}_k{k}_Q{q}",
            f, u, k, q,
            distribution=dists[i % len(dists)],
            seed=seed + i,
        )
        for i, (f, u, k, q) in enumerate(spec)
    ]
    # pad-waste identification pairs: identical (F, U, k, Q); ONLY the
    # user distribution — hence the cell-bucketing pad waste — differs.
    # The rotation above varies pw only alongside the size features, so
    # without these pairs log_pw is collinear with log_u/log_m and the
    # non-negative fit pins the grid family's occupancy exponent to zero.
    for f, u, k, q in ((200, 6_000, 8, 8), (500, 12_000, 8, 4)):
        for d in ("uniform", "clustered"):
            scens.append(
                Scenario(
                    f"cal_pw_{d}_F{f}_U{u}", f, u, k, q,
                    distribution=d, seed=seed + 101,
                )
            )
    return scens
