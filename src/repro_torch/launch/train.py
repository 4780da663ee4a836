"""Training launcher: config -> model -> data -> fault-tolerant driver
(``repro.launch.train``).

:func:`train_main` builds the model of ``arch`` (``get_reduced`` with
``reduced_overrides``, or the published config), its float32 training
state (:func:`repro_torch.steps.train.init_train_state`), the token
pipeline and the train step, and runs them under
:class:`repro_torch.runtime.driver.TrainDriver`, on the card unless
``device`` names another (``"cpu"`` runs the plain versions of the
kernels, as the tests do).  Batches are uploaded to that device.

Checkpoints are written in the JAX package's layout, under its leaf names
(:func:`repro_torch.models.convert.jax_layout_views`): either package
restores the other's ``step_N``.  A restore writes each leaf into the live
parameters and moments in place.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --steps 20 --batch 4 --seq 64 --ckpt /tmp/run1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.tokens import ShardedTokenPipeline, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models.convert import jax_layout_views
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.steps.train import init_train_state, make_train_step

__all__ = ["train_main", "main"]

_DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_ckpt")


def train_main(
    arch: str,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 256,
    reduced: bool = True,
    reduced_overrides: dict | None = None,
    ckpt_dir: str = _DEFAULT_CKPT,
    save_every: int = 50,
    lr: float = 3e-4,
    n_microbatches: int = 1,
    seed: int = 0,
    log_every: int = 10,
    device=None,
    inject_failure=None,
    on_remesh=None,
) -> dict:
    """Trains ``arch`` for ``steps`` steps; returns the JAX launcher's
    summary (``arch``, ``steps``, ``wall_s``, ``first_loss``,
    ``last_loss``, ``min_loss``, ``params``, ``events``), the driver's
    ``metrics_log`` (per step) and ``saves``, and its watchdog's mean step
    seconds ``step_s`` and straggler count ``stragglers``.  ``inject_failure`` and
    ``on_remesh`` go to the driver (:class:`TrainDriver`)."""
    dev = resolve_device(device)
    cfg = get_reduced(arch, **(reduced_overrides or {})) if reduced else get_config(arch)
    model = build_model(cfg, device=dev)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps)
    pipe = ShardedTokenPipeline(
        TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
    )

    def init_state():
        return init_train_state(model, seed, opt_cfg)

    step_fn = make_train_step(model, opt_cfg, n_microbatches=n_microbatches)
    extras = {k: torch.zeros(shp, dtype=torch.float32, device=dev)
              for k, (shp, _dt) in model.extras_shapes(batch).items()}

    def batch_fn(step):
        b = pipe.batch_at(step)
        return {"tokens": torch.from_numpy(b["tokens"]).to(dev, torch.long),
                "labels": torch.from_numpy(b["labels"]).to(dev, torch.long), **extras}

    drv = TrainDriver(
        ckpt_dir,
        DriverConfig(total_steps=steps, save_every=save_every),
        init_state=init_state,
        step_fn=step_fn,
        batch_fn=batch_fn,
        on_remesh=on_remesh,
        inject_failure=inject_failure,
        state_tree=lambda state: jax_layout_views(state, cfg),
    )
    t0 = time.perf_counter()
    state, done = drv.run()
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in drv.metrics_log]
    return dict(
        arch=cfg.name,
        steps=done,
        wall_s=wall,
        first_loss=losses[0] if losses else None,
        last_loss=losses[-1] if losses else None,
        min_loss=min(losses) if losses else None,
        params=int(sum(p.numel() for p in state["params"].parameters())),
        events=drv.events,
        metrics_log=drv.metrics_log,
        saves=drv.saves,
        step_s=drv.watchdog.mean,
        stragglers=drv.watchdog.flags,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", default=_DEFAULT_CKPT)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = train_main(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        reduced=args.reduced,
        ckpt_dir=args.ckpt,
        lr=args.lr,
        n_microbatches=args.microbatches,
        device=args.device,
    )
    out.pop("metrics_log")
    print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
