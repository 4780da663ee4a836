"""Dynamic-data subsystem: versioned updates, scene refit, continuous RkNN.

The port of ``repro.dynamic``.  Public surface:

* :class:`~repro_torch.dynamic.engine.DynamicEngine` — a
  :class:`~repro_torch.core.engine.RkNNEngine` whose ``(facilities, users)``
  snapshot evolves through :meth:`apply_updates`, every version verified
  by the same kernels as the static engine;
* :class:`~repro_torch.dynamic.updates.UpdateBatch` — one atomic delta;
* :class:`~repro_torch.dynamic.continuous.ContinuousQuery` — a standing
  query handle streaming ``(version, RkNNResult)`` change events;
* :class:`~repro_torch.dynamic.policy.RefitPolicy` — the priced
  refit-vs-rebuild frontier.

The update streams that drive it are in :mod:`repro_torch.workloads`.
"""

from repro_torch.dynamic.continuous import ContinuousQuery
from repro_torch.dynamic.engine import DynamicEngine, DynamicStats, UpdateReport
from repro_torch.dynamic.policy import RefitDecision, RefitPolicy
from repro_torch.dynamic.refit import refit_scene, remap_scene, scene_update_safe
from repro_torch.dynamic.updates import UpdateBatch, apply_to_points, changed_positions

__all__ = [
    "DynamicEngine",
    "DynamicStats",
    "UpdateReport",
    "UpdateBatch",
    "ContinuousQuery",
    "RefitPolicy",
    "RefitDecision",
    "apply_to_points",
    "changed_positions",
    "refit_scene",
    "remap_scene",
    "scene_update_safe",
]
