"""Flight recorder: a crash / SLO-breach black box for serving engines.

When something goes wrong in production — a writer exception mid-update,
a reader exception under traffic, a watchdog hang, a sustained SLO
breach — the record of *what the engine was doing* is usually gone by
the time anyone looks.  The flight recorder freezes it: one call to
:meth:`FlightRecorder.dump` writes a versioned postmortem bundle
(``flight/<stamp>_<reason>.json``) containing

* the last-N span records across **all** thread rings (plus exact
  dropped / intern-overflow counts, so "the trace is incomplete" is a
  stated fact, not a surprise),
* the full metrics snapshot (engine registry merged with the
  process-wide registry: intern overflows, flight activity),
* the engine config, snapshot version + facility fingerprint, dataset
  cardinalities, shard partition summary,
* the active planner profile id/epoch,
* the exception type/message/traceback when one triggered the dump,
* the sentinel's rule states when a sentinel is attached.

Arming: ``RkNNConfig(flight_recorder=True)`` attaches a recorder at
engine construction; or use the recorder as a context manager around a
risky region (it attaches to the engine for the block and dumps on any
exception leaving the block).  Dumps are rate-limited (a crash loop
writes one bundle per ``min_interval_s``, the rest are counted in
``flight.suppressed``) and everything read is lock-free — rings via
seqlock, metrics via GIL-published objects — so dumping never perturbs
concurrent serving beyond the serialization cost itself.

Bundles replay in the CLI: ``python -m repro_torch.obs --postmortem <bundle>``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import traceback
from datetime import datetime, timezone

from .export import spans as _decode_spans
from .metrics import process_registry
from .trace import get_tracer

__all__ = ["FlightRecorder", "SCHEMA"]

SCHEMA = "rknn-flight/1"


def _jsonable(obj):
    """Best-effort JSON coercion for config/metrics payloads."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    item = getattr(obj, "item", None)  # numpy scalars
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return str(obj)


class FlightRecorder:
    """Black-box bundle writer bound to one engine.

    Thread-safe: any reader/writer/watchdog thread may call
    :meth:`dump`; the internal lock only serializes bundle writes (never
    the serving path, which merely *holds a reference* to the recorder).
    """

    def __init__(
        self,
        engine,
        dir: str = "flight",
        *,
        max_spans: int = 512,
        min_interval_s: float = 5.0,
    ):
        self.engine = engine
        self.dir = dir
        self.max_spans = int(max_spans)
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._last_dump = -float("inf")
        self._seq = 0
        reg = process_registry()
        self._bundles = reg.counter("flight.bundles")
        self._suppressed = reg.counter("flight.suppressed")
        self.last_path: str | None = None

    # ---- arming -----------------------------------------------------------
    def __enter__(self) -> "FlightRecorder":
        """Arm for a block: the engine carries this recorder while the
        block runs, and any exception leaving the block dumps."""
        self._prev = getattr(self.engine, "flight", None)
        self.engine.flight = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.engine.flight = self._prev
        if exc is not None:
            self.dump("exception:block", exc=exc)

    # ---- capture ----------------------------------------------------------
    def record_exception(self, where: str, exc: BaseException) -> str | None:
        """Dump with the exception attached; returns the bundle path (or
        ``None`` when rate-limited).  Never raises — a broken recorder
        must not mask the original failure."""
        try:
            return self.dump(f"exception:{where}", exc=exc)
        except Exception:
            return None

    def dump(self, reason: str, *, exc: BaseException | None = None) -> str | None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < self.min_interval_s:
                self._suppressed.inc()
                return None
            self._last_dump = now
            self._seq += 1
            seq = self._seq
        bundle = self._bundle(reason, exc)
        os.makedirs(self.dir, exist_ok=True)
        stamp = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%S")
        safe = "".join(c if (c.isalnum() or c in "-_") else "-" for c in reason)
        path = os.path.join(self.dir, f"{stamp}_{seq:03d}_{safe}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
            f.write("\n")
        self._bundles.inc()
        self.last_path = path
        return path

    def _bundle(self, reason: str, exc: BaseException | None) -> dict:
        engine = self.engine
        tracer = get_tracer()
        recs = sorted(_decode_spans(tracer), key=lambda r: r["t1"])[-self.max_spans:]
        snap = getattr(engine, "_snap", None)
        shard_state = getattr(snap, "shard_state", None)
        try:
            from repro_torch.planner.profiles import get_active_profile, profile_epoch

            prof = get_active_profile()
            planner = dict(
                profile=getattr(prof, "version", None),
                hardware=getattr(prof, "hardware", None),
                epoch=profile_epoch(),
            )
        except Exception:
            planner = None
        metrics = {}
        m = getattr(engine, "metrics", None)
        if m is not None:
            metrics.update(m.snapshot())
        metrics.update(process_registry().snapshot())
        sentinel = getattr(engine, "_sentinel", None)
        return dict(
            schema=SCHEMA,
            reason=reason,
            wall_time=datetime.now(timezone.utc).isoformat(),
            engine=dict(
                **{"class": type(engine).__name__},
                config=_jsonable(getattr(engine, "config", None)),
                version=getattr(snap, "version", None),
                fingerprint=snap.fingerprint() if snap is not None else None,
                n_facilities=(
                    len(snap.facilities) if snap is not None else None
                ),
                n_users=len(snap.users) if snap is not None else None,
                shards=(
                    shard_state.summary() if shard_state is not None else None
                ),
                persist=_jsonable(getattr(engine, "persist_info", None)),
            ),
            planner=planner,
            metrics=_jsonable(metrics),
            spans=_jsonable(recs),
            spans_dropped=tracer.dropped,
            intern_overflows=tracer.intern_overflows,
            exception=(
                None
                if exc is None
                else dict(
                    type=type(exc).__name__,
                    message=str(exc),
                    traceback=traceback.format_exception(
                        type(exc), exc, exc.__traceback__
                    ),
                )
            ),
            sentinel=(sentinel.state() if sentinel is not None else None),
        )
