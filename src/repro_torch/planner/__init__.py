"""Adaptive query planner: calibrated per-backend cost models + dispatch.

The port of ``repro.planner`` (numpy and PyTorch only).  The paper's
claim is regime-dependent — ray casting wins at sparse facilities / dense
users / large ``k``, filter–refine methods elsewhere — so the engine picks
the execution path *per request*:

* :mod:`repro_torch.planner.models` — parametric (power-law) cost models
  over the workload shape (|F|, |U|, k, Q, scene size, cache hit/miss);
* :mod:`repro_torch.planner.calibrate` — an on-device harness that
  micro-benchmarks every timeable backend on synthetic shape grids and
  fits the models;
* :mod:`repro_torch.planner.profiles` — a versioned JSON store for fitted
  profiles (the JAX package's schema), the process-wide *active* profile,
  a built-in prior fallback and the committed profiles of runner classes
  (:data:`~repro_torch.planner.profiles.PROFILE_STORE`);
* :mod:`repro_torch.planner.backend` — :class:`PlannerBackend`, registered
  as ``"auto"``: cost-dispatches each request to the predicted-cheapest
  concrete backend (on a CUDA device never a plain twin), splitting
  heterogeneous batches.
"""

from repro_torch.planner.models import (
    BackendCostModel,
    CostModel,
    WorkloadShape,
    est_scene_tris,
)
from repro_torch.planner.profiles import (
    PROFILE_STORE,
    PROFILE_VERSION,
    PlannerProfile,
    builtin_profile,
    get_active_profile,
    load_profile,
    load_runner_profile,
    set_active_profile,
)

__all__ = [
    "WorkloadShape",
    "CostModel",
    "BackendCostModel",
    "est_scene_tris",
    "PlannerProfile",
    "PROFILE_VERSION",
    "PROFILE_STORE",
    "builtin_profile",
    "get_active_profile",
    "set_active_profile",
    "load_profile",
    "load_runner_profile",
]
