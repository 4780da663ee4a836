"""Parametric per-backend cost models over the workload shape.

The port of ``repro.planner.models``, carried over verbatim (pure numpy):
fits on the same data give bit-identical coefficients, so a profile
fitted by either package prices the same in the other.

Each backend gets two fitted models — one for the host *filter* phase
(scene construction + index build + batch stacking) and one for the
device *verify* phase (the counting dispatch) — mirroring the paper's
two-stage timing convention, so a scene-cache hit can be priced as
"verify only".

The model family is a **power law**: ``t ≈ exp(w · φ(shape))`` with
``φ`` a fixed vector of log-features of (|F|, |U|, k, Q, m).  Fitting is
ridge-regularized least squares on ``log t``, which is robust to the
orders-of-magnitude spread between backends, always predicts positive
times, and extrapolates scaling laws measured on small calibration shapes
to production cardinalities (the k-distance-approximation line of work
shows fitted models stand in well for exact index decisions).

``m`` is the occluder-scene triangle count — the verify phase's true size
driver for geometric backends.  When the planner prices a query *before*
building its scene, ``m`` is estimated from (|F|, k) via
:func:`est_scene_tris`; once scenes exist, the actual ``n_tris`` is used
(this per-query variation is what lets the planner split one batch across
backends).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "WorkloadShape",
    "est_scene_tris",
    "est_pad_waste",
    "FEATURE_NAMES",
    "SIGN_FREE_FEATURES",
    "featurize",
    "CostModel",
    "BackendCostModel",
]


def est_scene_tris(n_facilities: int, k: int) -> float:
    """Expected occluder-triangle count of an InfZone-pruned scene.

    Pruning retains ~O(k) influencing facilities (each contributing a
    constant number of fan triangles after clipping); the scene can never
    exceed one occluder fan per competitor facility.
    """
    return float(min(max(n_facilities - 1, 1) * 3.0, 6.0 * k + 24.0))


def est_pad_waste(n_users: int, grid_g: int = 64) -> float:
    """Pre-measurement estimate of the cell-bucketing pad-waste ratio.

    Assumes uniformly spread users: ``min(G², |U|)`` occupied cells, so
    the mean occupancy and :func:`repro_torch.kernels.grid_raycast.
    auto_cell_block`'s [8, 256] power-of-two clamp give ``padded ≈
    occupied · block``.  A pure function of |U| (perfectly collinear with
    ``log_u``), so fits that only ever see this fallback must ``drop``
    the ``log_pw`` feature; calibration passes the *measured* ratio of
    the actual workload instead."""
    u = max(int(n_users), 1)
    occ = min(int(grid_g) * int(grid_g), u)
    mean = max(int(np.ceil(u / occ)), 1)
    block = int(min(256, max(8, 1 << int(np.ceil(np.log2(mean))))))
    return max(occ * block / u, 1.0)


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The planner's view of one (possibly batched) query workload.

    ``m_tris`` is the per-query scene triangle count when known (scenes
    already built); ``None`` prices the pre-scene estimate.  ``cache_hit``
    marks the filter phase as already amortized (scene cache / prepared-
    batch LRU), so only verify cost is charged.  ``pad_waste`` is the
    measured cell-bucketing occupancy ratio (padded user rows / real
    rows, ≥ 1) when the caller knows it — the verify cost of the
    grid-pallas family tracks the padded total, not raw |U|; ``None``
    prices the uniform-density estimate.
    """

    n_facilities: int
    n_users: int
    k: int
    q: int = 1
    m_tris: float | None = None
    cache_hit: bool = False
    pad_waste: float | None = None
    #: User-axis shard count the workload is served at
    #: (the JAX package's ``repro.shard.ShardedEngine``); 1 = single-process.
    shards: int = 1

    def m(self) -> float:
        if self.m_tris is not None:
            return max(float(self.m_tris), 1.0)
        return est_scene_tris(self.n_facilities, self.k)

    def pw(self) -> float:
        if self.pad_waste is not None:
            return max(float(self.pad_waste), 1.0)
        return est_pad_waste(self.n_users)


#: Deliberately minimal: in log space any product term (Q·U, Q·U·m, …) is
#: an exact linear combination of these base features, so adding products
#: only introduces collinearity — the ridge then splits exponent weight
#: arbitrarily between aliases and extrapolation beyond the calibration
#: grid goes wrong.  Power laws compose products for free: a backend whose
#: cost is c·Q·U·m fits as exponents (1, 1, 1) on (log_q, log_u, log_m).
FEATURE_NAMES: tuple[str, ...] = (
    "const",
    "log_f",
    "log_u",
    "log_k",
    "log_q",
    "log_m",
    "log_pw",
    "log_s",
)

#: Features whose fitted exponent may legitimately be negative.  The
#: non-negativity active set below encodes "no backend gets cheaper as
#: the workload grows" — but ``log_s`` is a *resource* feature, not a
#: size feature: more shards is supposed to make verify cheaper, so its
#: honest exponent is ≤ 0 and pinning it to zero would erase exactly the
#: scaling the feature exists to price.
SIGN_FREE_FEATURES: frozenset = frozenset({"log_s"})


def featurize(shape: WorkloadShape) -> np.ndarray:
    f = float(max(shape.n_facilities, 1))
    u = float(max(shape.n_users, 1))
    k = float(max(shape.k, 1))
    q = float(max(shape.q, 1))
    m = shape.m()
    pw = shape.pw()
    s = float(max(shape.shards, 1))
    return np.array(
        [
            1.0,
            np.log(f),
            np.log(u),
            np.log(k),
            np.log(q),
            np.log(m),
            np.log(pw),
            np.log(s),
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass
class CostModel:
    """One fitted power-law phase model: ``t_s = exp(coef · φ(shape))``."""

    coef: np.ndarray  # [len(FEATURE_NAMES)]

    def predict_s(self, shape: WorkloadShape) -> float:
        return float(np.exp(np.clip(featurize(shape) @ self.coef, -50.0, 50.0)))

    def predict_many_s(self, features: np.ndarray) -> np.ndarray:
        """Vectorized prediction over a ``[Q, n_features]`` matrix (the
        batch-split hot path prices every query against every candidate)."""
        return np.exp(np.clip(features @ self.coef, -50.0, 50.0))

    @classmethod
    def fit(
        cls,
        shapes: list[WorkloadShape],
        times_s: np.ndarray,
        ridge: float = 1e-3,
        drop: tuple[str, ...] = (),
    ) -> "CostModel":
        """Ridge least squares on ``log t`` (times floored at 1 µs so a
        measured ~0 filter phase doesn't blow up the log target).

        ``drop`` names features forced to exponent 0 — physics the fit
        should not have to discover (a geometry-free backend cannot depend
        on the scene size ``m``; leaving the column in lets it steal
        correlated weight from |F| and wreck extrapolation).

        All non-``const`` exponents are constrained **non-negative**: no
        backend gets cheaper as the workload grows, so a negative exponent
        is always a collinearity artifact of the calibration grid (e.g.
        ``log_u`` stealing weight from the padded-occupancy term), and it
        extrapolates catastrophically — a benchmark once misrouted
        steady-state verify away from ``grid-pallas-ref`` exactly this
        way.  Enforced by an active-set loop: refit with every negative
        exponent pinned to 0 until none remain (NNLS on this feature
        count in ≤ ``len(FEATURE_NAMES)`` solves).

        ``log_q`` is additionally capped at **1**: a batched dispatch can
        always fall back to looping the single-query path ``q`` times, so
        per-batch cost is at most linear in ``q`` — a fitted exponent
        above 1 is the same kind of collinearity artifact (it makes the
        planner punish exactly the backends whose batch economies it
        should be exploiting).  Capped features contribute a fixed offset
        of ``1.0 x log_q`` to the target and leave the active set.
        """
        y = np.log(np.maximum(np.asarray(times_s, np.float64), 1e-6))
        A = np.stack([featurize(s) for s in shapes])
        pinned = set(drop)
        capped: set[str] = set()
        while True:
            keep = np.array(
                [name not in pinned and name not in capped for name in FEATURE_NAMES]
            )
            y_eff = y
            for name in capped:
                y_eff = y_eff - A[:, FEATURE_NAMES.index(name)]
            Ak = A[:, keep]
            n = Ak.shape[1]
            ck = np.linalg.solve(Ak.T @ Ak + ridge * np.eye(n), Ak.T @ y_eff)
            coef = np.zeros(len(FEATURE_NAMES))
            coef[keep] = ck
            for name in capped:
                coef[FEATURE_NAMES.index(name)] = 1.0
            negative = [
                name
                for name, c in zip(FEATURE_NAMES, coef)
                if name != "const" and name not in SIGN_FREE_FEATURES and c < 0.0
            ]
            superlinear_q = coef[FEATURE_NAMES.index("log_q")] > 1.0
            if not negative and not superlinear_q:
                return cls(coef=coef)
            pinned.update(negative)
            if superlinear_q:
                capped.add("log_q")

    def to_json(self) -> dict:
        return {"coef": [float(c) for c in self.coef]}

    @classmethod
    def from_json(cls, obj: dict) -> "CostModel":
        coef = np.asarray(obj["coef"], np.float64)
        if coef.ndim == 1 and coef.shape[0] == len(FEATURE_NAMES) - 1:
            # profile fitted before the newest trailing feature existed
            # (``log_s`` landed after the committed runner profiles):
            # exponent 0 on the missing feature prices it as neutral,
            # which is exactly what a fit with no variation would return.
            # Only the one-feature-behind schema is migrated — anything
            # shorter is a genuinely stale/corrupt profile and still
            # rejected below.
            coef = np.concatenate([coef, np.zeros(1)])
        if coef.shape != (len(FEATURE_NAMES),):
            raise ValueError(
                f"cost-model coefficient vector has shape {coef.shape}, "
                f"expected ({len(FEATURE_NAMES)},) — stale profile?"
            )
        return cls(coef=coef)


@dataclasses.dataclass
class BackendCostModel:
    """Filter + verify models for one backend name."""

    name: str
    filter: CostModel
    verify: CostModel

    def predict_total_s(self, shape: WorkloadShape) -> float:
        """Predicted wall time; a cache hit skips the filter phase."""
        t = self.verify.predict_s(shape)
        if not shape.cache_hit:
            t += self.filter.predict_s(shape)
        return t

    def predict_total_many_s(
        self, features: np.ndarray, cache_hit: np.ndarray
    ) -> np.ndarray:
        """Vectorized :meth:`predict_total_s` over pre-featurized shapes."""
        t = self.verify.predict_many_s(features)
        miss = ~np.asarray(cache_hit, bool)
        if miss.any():
            t = t + miss * self.filter.predict_many_s(features)
        return t

    @classmethod
    def fit(
        cls,
        name: str,
        shapes: list[WorkloadShape],
        t_filter_s: np.ndarray,
        t_verify_s: np.ndarray,
        drop: tuple[str, ...] = (),
    ) -> "BackendCostModel":
        return cls(
            name=name,
            filter=CostModel.fit(shapes, t_filter_s, drop=drop),
            verify=CostModel.fit(shapes, t_verify_s, drop=drop),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "filter": self.filter.to_json(),
            "verify": self.verify.to_json(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "BackendCostModel":
        return cls(
            name=obj["name"],
            filter=CostModel.from_json(obj["filter"]),
            verify=CostModel.from_json(obj["verify"]),
        )
