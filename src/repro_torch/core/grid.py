"""Build-throttle helpers of the grid index (``repro.core.grid``).

Only the per-thread cooperative-yield helpers that scene pruning reads
(:func:`repro_torch.core.pruning.prune_facilities`) live here so far; the
uniform-grid occluder index itself is not yet part of this package.
"""

from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["build_yield_ratio", "build_throttle", "build_sleep", "build_slept_s"]


#: Per-thread cooperative deprioritization for heavy index builds.  A
#: background maintenance thread (the MVCC writer prewarming scenes) sets
#: a positive ratio; the classify chunk loop then sleeps ``ratio x`` the
#: time each chunk of C-level work took, handing the GIL to foreground
#: query threads.  Foreground builds leave it at 0 and pay nothing.
_build_priority = threading.local()


def build_yield_ratio() -> float:
    """Current thread's cooperative-yield ratio (0.0 = foreground).

    Re-sampled inside the hot loops (per chunk / per iteration), so a
    callable ratio can engage or release mid-build as contention changes.
    """
    v = getattr(_build_priority, "yield_ratio", 0.0)
    return float(v()) if callable(v) else v


@contextlib.contextmanager
def build_throttle(ratio):
    """Make grid builds on THIS thread yield ``ratio x`` their CPU time.

    ``ratio=2.0`` caps the building thread at ~1/3 of a contended core, so
    concurrent readers keep ~2/3 instead of the fair-scheduling half — the
    single-core analogue of running index maintenance at low priority.

    ``ratio`` may be a zero-arg callable returning the current ratio —
    the MVCC writer passes one that flips from 0 to 2.0 the moment a
    concurrent reader is observed, so an uncontended engine never sleeps.
    """
    prev = getattr(_build_priority, "yield_ratio", 0.0)
    _build_priority.yield_ratio = ratio if callable(ratio) else float(ratio)
    try:
        yield
    finally:
        _build_priority.yield_ratio = prev


def build_sleep(seconds: float) -> None:
    """Cooperative-yield sleep with duty-cycle accounting.

    Every deprioritization sleep (the classify chunk loop here, the
    pruning iteration loop, the prewarm backstop) routes through this so
    the MVCC writer can report its throttle duty cycle — slept wall time
    over total update time — as an obs gauge."""
    if seconds <= 0.0:
        return
    time.sleep(seconds)
    _build_priority.slept_total = (
        getattr(_build_priority, "slept_total", 0.0) + seconds
    )


def build_slept_s() -> float:
    """This thread's cumulative :func:`build_sleep` time (monotone —
    callers diff two readings around a throttled region)."""
    return getattr(_build_priority, "slept_total", 0.0)


