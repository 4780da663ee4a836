"""Priced refit-vs-rebuild decisions for dirtied scenes (``repro.dynamic.policy``).

When an update lands inside a cached scene's pruning certificate the
dynamic engine has two honest options:

* **refit eagerly** during ``apply_updates`` — pay a re-prune plus
  occluder patches for the moved facilities plus per-backend index
  refits now, and keep the cache hot;
* **drop** the entry — pay a full scene build lazily on the next query
  that wants it (or nothing at all, if the query never repeats).

The decision is priced the same way the query planner prices backends:
the rebuild side comes from the active profile's *filter* cost model
(scene construction is exactly what that model measures), the refit side
scales it by the share of work a refit skips.  Observed refit/rebuild
times feed back as damped EMAs, so the prior only matters until the
first few updates have been measured — the same calibrate-then-trust
pattern as :mod:`repro_torch.planner`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.planner.models import WorkloadShape
from repro_torch.planner.profiles import active_or_builtin

__all__ = ["RefitDecision", "RefitPolicy"]

#: Share of a cold scene build that a refit still pays (the re-prune);
#: the remainder (occluder fans + index build) scales with the touched
#: fraction.  A prior only — displaced by measured EMAs as updates land.
_PRUNE_SHARE = 0.55
_EMA_ALPHA = 0.3


@dataclasses.dataclass
class RefitDecision:
    """One priced decision (surfaced through ``DynamicEngine.explain_updates``)."""

    action: str  # "refit" | "rebuild"
    predicted_refit_s: float
    predicted_rebuild_s: float


class RefitPolicy:
    """EMA-corrected cost frontier between eager refit and lazy rebuild."""

    def __init__(self) -> None:
        self.ema_refit_s: float | None = None
        self.ema_rebuild_s: float | None = None
        self.n_refit = 0
        self.n_rebuild = 0

    # ------------------------------------------------------------------
    def _rebuild_cost_s(self, shape: WorkloadShape) -> float:
        if self.ema_rebuild_s is not None:
            return self.ema_rebuild_s
        prof = active_or_builtin()
        best = np.inf
        for name, model in prof.models.items():
            if name in ("brute", "slice"):
                continue  # geometry-free: no scene to rebuild
            best = min(best, model.filter.predict_s(shape))
        return best if np.isfinite(best) else 1e-3

    def price(
        self, shape: WorkloadShape, n_changed_tris: int, n_tris: int
    ) -> RefitDecision:
        """Price refitting one scene with ``n_changed_tris`` touched
        triangles against rebuilding it cold (``shape.m_tris == n_tris``)."""
        rebuild = self._rebuild_cost_s(shape)
        frac = n_changed_tris / max(n_tris, 1)
        if self.ema_refit_s is not None:
            refit = self.ema_refit_s
        else:
            refit = rebuild * (_PRUNE_SHARE + (1.0 - _PRUNE_SHARE) * frac)
        action = "refit" if refit < rebuild else "rebuild"
        return RefitDecision(action, refit, rebuild)

    def observe(self, action: str, dt_s: float) -> None:
        """Fold an observed refit/rebuild duration into the EMAs."""
        if action == "refit":
            self.n_refit += 1
            self.ema_refit_s = (
                dt_s
                if self.ema_refit_s is None
                else (1 - _EMA_ALPHA) * self.ema_refit_s + _EMA_ALPHA * dt_s
            )
        else:
            self.n_rebuild += 1
            self.ema_rebuild_s = (
                dt_s
                if self.ema_rebuild_s is None
                else (1 - _EMA_ALPHA) * self.ema_rebuild_s + _EMA_ALPHA * dt_s
            )
