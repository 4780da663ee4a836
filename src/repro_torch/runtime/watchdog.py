"""Straggler and hang detection for the training driver
(``repro.runtime.watchdog``, host code with no JAX).

* ``StepWatchdog`` keeps a streaming mean and variance of step times
  (Welford); a step beyond ``mean + k * sigma`` (and an absolute floor)
  flags a straggler, and is left out of the statistics so that one slow
  step does not raise the baseline.  The driver counts the flags
  (:mod:`repro_torch.runtime.driver`).
* ``HangTimer`` is a hard wall-clock deadline per step (the lost-node case,
  where the step never completes); it fires a callback from a daemon
  thread.
"""

from __future__ import annotations

import threading
import time

__all__ = ["StepWatchdog", "HangTimer"]


class StepWatchdog:
    def __init__(self, k_sigma: float = 4.0, min_steps: int = 8, abs_floor_s: float = 0.05):
        self.k = k_sigma
        self.min_steps = min_steps
        self.abs_floor = abs_floor_s
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.flags = 0
        self._t0: float | None = None

    def _update(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def sigma(self) -> float:
        return (self.m2 / max(self.n - 1, 1)) ** 0.5

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record the step; returns True if it was a straggler step."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record a step of ``dt`` seconds (the offline form of
        start/stop); returns True if it was a straggler step."""
        is_straggler = (
            self.n >= self.min_steps
            and dt > max(self.mean + self.k * self.sigma, self.abs_floor)
        )
        if is_straggler:
            self.flags += 1
        else:
            self._update(dt)
        return is_straggler


class HangTimer:
    """Hard per-step deadline; calls ``on_hang`` from a daemon thread.

    ``flight`` (optional) is a :class:`repro_torch.obs.flight.FlightRecorder`:
    a hang dumps a postmortem bundle *before* the mitigation callback runs,
    so the spans and metrics of the wedged step survive whatever the
    mitigation does to the process.
    """

    def __init__(self, deadline_s: float, on_hang, *, flight=None):
        self.deadline = deadline_s
        self.on_hang = on_hang
        self.flight = flight
        self._timer: threading.Timer | None = None

    def _fire(self) -> None:
        if self.flight is not None:
            try:
                self.flight.dump("hang")
            except Exception:
                pass  # the black box must never mask the mitigation
        self.on_hang()

    def __enter__(self):
        self._timer = threading.Timer(self.deadline, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False
