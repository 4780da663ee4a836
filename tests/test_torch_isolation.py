"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` and the
modules ``chip_smoke.py`` imports, then must hold no ``jax*`` and no
``repro`` / ``repro.*`` module: the machine with the card need not have
JAX, and the port keeps its own copy of what it needs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ROOT)
import chip_smoke
chip_smoke.run  # the phases import lazily: run's imports are the package's
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference_package():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + _PROBE],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"repro_torch.core.engine", "repro_torch.core.grid", "repro_torch.kernels.ops",
            "repro_torch.kernels.grid_raycast", "repro_torch.kernels.build",
            "repro_torch.core.bvh", "repro_torch.kernels.bvh",
            "repro_torch.workloads.scenarios",
            "repro_torch.core.baselines.tpl"} <= set(report["modules"])
    assert report["leaked"] == []
