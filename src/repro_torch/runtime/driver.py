"""Fault-tolerant training driver: checkpoint and restart, stragglers,
elastic re-meshing (``repro.runtime.driver``).

The loop a cluster job runs:

    while budget:
        state <- restore the latest checkpoint (or init)
        try:   step, step, ... (watchdog timing, periodic async snapshots)
        except DeviceLoss: plan_remesh(survivors) -> restore on the new mesh
        except transient:  retry with backoff, restart from the last snapshot

Failure injection (``inject_failure``) exercises every path on the CPU: an
exception mid-run loses at most ``save_every - 1`` steps, restarts are
bit-deterministic (an index-based data pipeline and the optimizer state in
the checkpoint), and straggler flags feed the mitigation counter.

The port's states may hold what the checkpoint store cannot walk (the
training state's parameters are an ``nn.Module``): ``state_tree`` then
gives the tree a checkpoint holds of a state, over its live tensors
(:func:`repro_torch.models.convert.jax_layout_views`), which a restore
fills in place, leaf by leaf.  Before a restart the driver drops the old
state, so the card never holds two.  Each save copies the state to the
host before the steps go on; ``saves`` records its step, its bytes, the
seconds spent waiting for the previous save's write and the seconds of
the copy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.runtime.watchdog import StepWatchdog

__all__ = ["DriverConfig", "TrainDriver", "DeviceLoss"]


class DeviceLoss(RuntimeError):
    """Raised (or injected) when participating devices disappear."""

    def __init__(self, n_alive: int):
        super().__init__(f"device loss: {n_alive} alive")
        self.n_alive = n_alive


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    save_every: int = 50
    keep: int = 3
    max_retries: int = 3
    retry_backoff_s: float = 0.2
    straggler_k_sigma: float = 4.0


def _wait_for(metrics: dict) -> None:
    """Waits for the card that computed the metrics (nothing on the CPU)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            return


class TrainDriver:
    def __init__(
        self,
        ckpt_dir: str,
        cfg: DriverConfig,
        *,
        init_state: Callable[[], Any],
        step_fn: Callable[[Any, dict], tuple[Any, dict]],
        batch_fn: Callable[[int], dict],
        on_remesh: Callable[[int], None] | None = None,
        inject_failure: Callable[[int], None] | None = None,
        state_tree: Callable[[Any], Any] | None = None,
    ):
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self.init_state = init_state
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.on_remesh = on_remesh
        self.inject_failure = inject_failure
        self.state_tree = state_tree
        self.watchdog = StepWatchdog(k_sigma=cfg.straggler_k_sigma)
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=cfg.keep)
        self.events: list[str] = []
        self.metrics_log: list[dict] = []
        self.saves: list[dict] = []

    def _restore_or_init(self):
        step = latest_step(self.ckpt_dir)
        state = self.init_state()
        if step is None:
            self.events.append("init:fresh")
            return state, 0
        if self.state_tree is None:
            state, manifest = restore_checkpoint(self.ckpt_dir, state)
        else:
            _, manifest = restore_checkpoint(self.ckpt_dir, self.state_tree(state), into=True)
        self.events.append(f"restore:step_{manifest['step']}")
        return state, int(manifest["step"])

    def run(self) -> tuple[Any, int]:
        retries = 0
        while True:
            state, start = self._restore_or_init()
            try:
                state, done = self._run_from(state, start)
                self.ckpt.wait()
                return state, done
            except DeviceLoss as e:
                state = None  # the restart's init must not meet the old state
                self.events.append(f"device_loss:{e.n_alive}")
                self.ckpt.wait()
                if self.on_remesh is not None:
                    self.on_remesh(e.n_alive)
                    self.events.append("remesh")
                retries = 0  # re-meshed: reset the transient budget
            except Exception as e:  # noqa: BLE001 — the transient failure path
                state = None
                retries += 1
                self.events.append(f"retry{retries}:{type(e).__name__}")
                if retries > self.cfg.max_retries:
                    raise
                self.ckpt.wait()
                time.sleep(self.cfg.retry_backoff_s * retries)

    def _run_from(self, state, start: int):
        for step in range(start, self.cfg.total_steps):
            if self.inject_failure is not None:
                self.inject_failure(step)
            batch = self.batch_fn(step)
            self.watchdog.start()
            state, metrics = self.step_fn(state, batch)
            _wait_for(metrics)
            straggler = self.watchdog.stop()
            if straggler:
                self.events.append(f"straggler:step_{step}")
            self.metrics_log.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
            done = step + 1
            if done % self.cfg.save_every == 0 or done == self.cfg.total_steps:
                self._save(done, state)
                self.events.append(f"save:step_{done}")
        return state, self.cfg.total_steps

    def _save(self, done: int, state) -> None:
        t0 = time.perf_counter()
        self.ckpt.wait()
        t1 = time.perf_counter()
        tree = state if self.state_tree is None else self.state_tree(state)
        n_bytes = self.ckpt.save(done, tree)
        self.saves.append({"step": done, "bytes": n_bytes, "wait_s": t1 - t0,
                           "host_copy_s": time.perf_counter() - t1})
