"""``auto``: the planner as a registered backend.

The port of ``repro.planner.backend``.  One change: :meth:`PlannerBackend.
candidates` takes the device.  On a CUDA device it drops the plain twins
(``dense-ref``, ``grid-pallas-ref``), so no plain version is on the card's
serving path; on the CPU it is the JAX package's set (the concrete backends
the profile prices), so CPU choices can be held against JAX's exactly.

:class:`PlannerBackend` never counts anything itself — it prices every
registered concrete backend with the active (or built-in prior) profile
and delegates to the predicted-cheapest one.  The
:class:`~repro_torch.core.engine.RkNNEngine` integrates it at the *planning*
level (``is_meta = True``): single queries are re-routed before any scene
is built (so a brute decision skips the filter phase entirely), and
batches are optionally **split** — once scenes exist, each query is
re-priced with its actual scene size and the batch is partitioned into
per-backend groups whose counts are recombined in order.

Used directly through the raw ``Backend`` protocol (no engine), it still
works: ``count``/``count_batch`` select among the backends the request
can actually feed and delegate, without splitting.

``explain()`` returns the most recent plan; the engine keeps a rolling
log of plans (``RkNNEngine.explain()``) and accumulates predicted vs.
observed cost in ``EngineStats``.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.planner.models import WorkloadShape
from repro_torch.planner.profiles import (
    PlannerProfile,
    active_or_builtin,
    get_active_profile,
    note_recalibrated,
    set_active_profile,
)

__all__ = ["PlannerBackend"]

#: Online re-calibration constants: damped step size on the log-cost
#: residual, per-observation residual clip, and the cumulative absolute
#: drift past which memoized plans are re-priced (epoch bump).
RECAL_LR = 0.2
RECAL_CLIP = 2.0
RECAL_EPOCH_DRIFT = 0.5


class PlannerBackend:
    """Cost-dispatching meta-backend (registered as ``"auto"``).

    Duck-types the :class:`repro_torch.core.backends.Backend` protocol instead
    of subclassing it: ``core.backends`` imports this module to register
    it, so this module must not import ``core.backends`` at import time
    (all core imports live inside methods, keeping the edge acyclic in
    either import order).
    """

    name = "auto"
    is_meta = True
    uses_scene = True  # may route to geometric backends
    plain_twin_of = None

    #: A heterogeneous batch is split across backends only when the
    #: predicted per-query total undercuts the best single-backend total
    #: by at least this factor — splitting costs an extra dispatch per
    #: group and per-query predictions near the frontier are the model's
    #: least certain, so close calls consolidate to one backend.
    split_margin = 0.8

    def __init__(self) -> None:
        self._last_plan: dict | None = None
        self._lock = threading.Lock()
        self._recal_drift = 0.0
        self.n_recal_nudges = 0

    # ------------------------------------------------------------------
    # pricing
    # ------------------------------------------------------------------
    def profile(self) -> PlannerProfile:
        return active_or_builtin()

    def candidates(
        self, profile: PlannerProfile | None = None, device=None
    ) -> tuple[str, ...]:
        """Concrete registered backends the profile can price, for serving
        on ``device`` (``None``: CUDA, as every entry point).  On a CUDA
        device the plain twins are left out; on the CPU every concrete
        backend stays, as in the JAX package."""
        import torch

        from repro_torch.core.backends import concrete_backends, get_backend

        prof = profile or self.profile()
        on_card = torch.device("cuda" if device is None else device).type == "cuda"
        return tuple(
            n for n in concrete_backends()
            if n in prof.models and not (on_card and get_backend(n).plain_twin_of)
        )

    def rank(
        self, shape: WorkloadShape, candidates: tuple[str, ...] | None = None
    ) -> list[tuple[str, float]]:
        """Candidates sorted cheapest-first for ``shape``."""
        prof = self.profile()
        return prof.rank(shape, candidates or self.candidates(prof))

    def select(
        self, shape: WorkloadShape, candidates: tuple[str, ...] | None = None
    ) -> tuple[str, float, dict[str, float]]:
        """(chosen backend, predicted seconds, all candidate costs)."""
        ranked = self.rank(shape, candidates)
        return ranked[0][0], ranked[0][1], dict(ranked)

    def assign_batch(
        self,
        shapes: list[WorkloadShape],
        candidates: tuple[str, ...] | None = None,
    ) -> list[tuple[str, float]]:
        """Per-query (backend, predicted seconds) for an already-filtered
        batch — shapes carry actual scene sizes and ``cache_hit=True`` so
        only verify-side cost differentiates the candidates.

        Splitting is *conservative*: the free-choice per-query assignment
        is kept only when its predicted total beats the best single
        backend's total by more than ``split_margin``; otherwise the whole
        batch consolidates onto that single backend (all costs compared at
        the same per-query granularity, so the margin is apples-to-apples).

        Queries are priced at the backend's **average per-query cost at
        this batch's scale** — ``predict(q=Q) / Q`` — not its standalone
        ``q=1`` cost: a backend with batch economies (the bucketed grid
        shares one user sort across the dispatch; its fitted q-exponent is
        well below 1) serves a query inside a Q-batch far cheaper than
        alone.  This keeps the per-query partition consistent with the
        batch-level rank (a single-backend assignment sums to exactly the
        batch prediction) instead of systematically flipping batch-economy
        backends onto their unamortized q=1 cost.
        """
        import dataclasses

        import numpy as np

        from repro_torch.planner.models import featurize

        prof = self.profile()
        cands = candidates or self.candidates(prof)
        Q = max(len(shapes), 1)
        feats = np.stack(
            [featurize(dataclasses.replace(s, q=Q)) for s in shapes]
        )  # [Q, n_features], each priced at full-batch scale
        hits = np.array([s.cache_hit for s in shapes], bool)
        costs = np.stack(
            [prof.models[c].predict_total_many_s(feats, hits) / Q for c in cands]
        )  # [C, Q] average per-query cost within this batch
        totals = costs.sum(axis=1)
        best_single = int(np.argmin(totals))
        winner = np.argmin(costs, axis=0)  # [Q]
        split_total = float(costs[winner, np.arange(len(shapes))].sum())
        if split_total < self.split_margin * float(totals[best_single]):
            return [
                (cands[int(w)], float(costs[int(w), i]))
                for i, w in enumerate(winner)
            ]
        return [
            (cands[best_single], float(costs[best_single, i]))
            for i in range(len(shapes))
        ]

    # ------------------------------------------------------------------
    # online re-calibration
    # ------------------------------------------------------------------
    def _pred_obs_pairs(self, plan: dict):
        """(backend, predicted_s, observed_s, verify_only) per dispatch
        the plan actually ran — the live residual signal."""
        mode = plan.get("mode", "")
        if mode in ("single", "stream-batch"):
            name, pred, obs = (
                plan.get("backend"),
                plan.get("predicted_s"),
                plan.get("observed_s"),
            )
            if name is None or pred is None or obs is None:
                return
            yield name, pred, obs, bool(plan.get("cache_hit") or plan.get("amortized"))
            return
        if mode == "batch":
            assigned = plan.get("assignments") or []
            per_q = plan.get("predicted_per_query") or []
            observed = plan.get("observed_group_s") or {}
            for name, obs in observed.items():
                pred = sum(c for a, c in zip(assigned, per_q) if a == name)
                # batch groups are priced post-scene (filter cost sunk)
                yield name, pred, obs, True

    def observe(self, plan: dict) -> int:
        """Damped online re-calibration from one closed-out plan.

        Each dispatched backend's log-cost residual ``log(obs / pred)``
        (clipped) nudges the **active** profile's constant coefficients —
        verify only when the filter phase was amortized away, both phases
        otherwise.  The built-in prior is never mutated in place: if no
        profile is active, a private copy is activated first.  Cumulative
        drift past ``RECAL_EPOCH_DRIFT`` bumps the profile epoch so
        memoized batch plans are re-priced.  Returns the nudge count.
        """
        import copy

        prof = get_active_profile()
        if prof is None:
            prof = copy.deepcopy(active_or_builtin())
            prof.source = prof.source + "+online"
            set_active_profile(prof)
        n = 0
        with self._lock:
            for name, pred, obs, verify_only in self._pred_obs_pairs(plan):
                model = prof.models.get(name)
                if model is None:
                    continue
                r = float(
                    np.clip(np.log(max(obs, 1e-7) / max(pred, 1e-7)),
                            -RECAL_CLIP, RECAL_CLIP)
                )
                delta = RECAL_LR * r
                model.verify.coef[0] += delta
                if not verify_only:
                    model.filter.coef[0] += delta
                self._recal_drift += abs(delta)
                n += 1
                self.n_recal_nudges += 1
            if self._recal_drift >= RECAL_EPOCH_DRIFT:
                self._recal_drift = 0.0
                note_recalibrated()
        return n

    # ------------------------------------------------------------------
    # explain
    # ------------------------------------------------------------------
    def record(self, plan: dict) -> None:
        with self._lock:
            self._last_plan = plan

    def explain(self) -> dict | None:
        """The most recent plan routed through this planner instance."""
        with self._lock:
            return self._last_plan

    # ------------------------------------------------------------------
    # raw Backend protocol (direct use, no engine): delegate, no split
    # ------------------------------------------------------------------
    def build_index(self, scene, *, grid_g: int = 64, memo: dict | None = None):
        return None

    def prepare_batch(self, req):
        return None

    def _direct_candidates(self, *, has_scene: bool, has_points: bool, device):
        from repro_torch.core.backends import get_backend

        names = []
        for n in self.candidates(device=device):
            b = get_backend(n)
            if b.uses_scene and has_scene:
                names.append(n)
            elif not b.uses_scene and has_points:
                names.append(n)
        if not names:
            raise ValueError(
                "auto backend: request carries neither a scene nor raw "
                "facility/user points any priced backend can consume"
            )
        return tuple(names)

    def count(self, req):
        from repro_torch.core.backends import get_backend

        n_u = int(req.xs.shape[0]) if req.xs is not None else len(req.users)
        n_f = len(req.facilities) if req.facilities is not None else req.k
        shape = WorkloadShape(
            n_f, n_u, req.k, 1,
            m_tris=None if req.scene is None else req.scene.n_tris,
            cache_hit=req.scene is not None,  # scene already built: verify only
        )
        cands = self._direct_candidates(
            has_scene=req.scene is not None,
            has_points=req.users is not None and req.q_pt is not None,
            device=req.device,
        )
        choice, pred, costs = self.select(shape, cands)
        self.record(
            {"mode": "direct-single", "backend": choice, "predicted_s": pred,
             "candidates": costs}
        )
        b = get_backend(choice)
        if b.uses_scene and req.index is None:
            req.index = b.build_index(req.scene, grid_g=req.grid_g)
        return b.count(req)

    def count_batch(self, req, prepared):
        from repro_torch.core.backends import get_backend

        n_u = int(req.xs.shape[0]) if req.xs is not None else len(req.users)
        n_f = len(req.facilities) if req.facilities is not None else req.k
        q = len(req.q_pts) if req.q_pts is not None else len(req.scenes or ())
        has_scenes = bool(req.scenes)
        shape = WorkloadShape(
            n_f, n_u, req.k, max(q, 1),
            m_tris=max(s.n_tris for s in req.scenes) if has_scenes else None,
            cache_hit=has_scenes,
        )
        cands = self._direct_candidates(
            has_scene=has_scenes,
            has_points=req.users is not None and req.q_pts is not None,
            device=req.device,
        )
        choice, pred, costs = self.select(shape, cands)
        self.record(
            {"mode": "direct-batch", "backend": choice, "predicted_s": pred,
             "candidates": costs}
        )
        b = get_backend(choice)
        return b.count_batch(req, b.prepare_batch(req))
