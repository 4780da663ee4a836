"""Scenario workload generators for calibration and regime benchmarks,
and the update streams the dynamic subsystem serves.

The port of ``repro.workloads``: every generator is host numpy and equals
the JAX package's bit for bit at the same seeds.
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
from repro_torch.workloads.updates import (
    drifting_users,
    facility_churn,
    facility_jitter,
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
    "drifting_users",
    "facility_churn",
    "facility_jitter",
]
