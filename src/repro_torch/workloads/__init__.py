"""Scenario workload generators for calibration and regime benchmarks.

The port of ``repro.workloads``.  Its update-stream generators
(``drifting_users``, ``facility_churn``, ``facility_jitter`` of
``repro/workloads/updates.py``) build the dynamic subsystem's
``UpdateBatch`` and come with that subsystem; they are not here yet.
"""

from repro_torch.workloads.scenarios import (
    SCENARIOS,
    SHARDING_REGIMES,
    Scenario,
    Workload,
    calibration_grid,
    get_scenario,
    scenario_names,
    sharding_scenarios,
)

__all__ = [
    "Scenario",
    "Workload",
    "SCENARIOS",
    "get_scenario",
    "scenario_names",
    "calibration_grid",
    "sharding_scenarios",
    "SHARDING_REGIMES",
]
