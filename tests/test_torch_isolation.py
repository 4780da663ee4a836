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
            "repro_torch.core.baselines.tpl", "repro_torch.shard", "repro_torch.shard.engine",
            "repro_torch.shard.mesh", "repro_torch.shard.reduce",
            "repro_torch.distributed.sharding", "repro_torch.launch.serve",
            "repro_torch.obs.export", "repro_torch.obs.promtext", "repro_torch.obs.jitmon",
            "repro_torch.obs.sentinel", "repro_torch.obs.flight", "repro_torch.obs.health",
            "repro_torch.obs.health.server", "repro_torch.obs.__main__",
            "repro_torch.checkpoint", "repro_torch.checkpoint.store",
            "repro_torch.persist", "repro_torch.persist.store",
            "repro_torch.persist.__main__",
            "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.registry",
            "repro_torch.configs.qwen2_7b", "repro_torch.configs.llama3_405b",
            "repro_torch.configs.whisper_medium", "repro_torch.data.tokens",
            "repro_torch.models", "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.ffn", "repro_torch.models.decoder", "repro_torch.models.convert",
            "repro_torch.models.registry", "repro_torch.steps", "repro_torch.steps.train",
            "repro_torch.kernels.attention", "repro_torch.steps.loss", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.runtime",
            "repro_torch.runtime.compression", "repro_torch.runtime.watchdog",
            "repro_torch.runtime.elastic", "repro_torch.runtime.driver",
            "repro_torch.launch.train", "repro_torch.optim.adamw8bit",
            "repro_torch.kernels.adamw", "repro_torch.kernels.moe",
            "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.dbrx_132b",
            "repro_torch.models.rglru", "repro_torch.kernels.rglru",
            "repro_torch.configs.recurrentgemma_9b"} <= set(report["modules"])
    assert report["leaked"] == []
