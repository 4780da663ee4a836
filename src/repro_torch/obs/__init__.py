"""Unified observability: spans, metrics, trace export and the health layer.

Carried over from ``repro.obs`` (pure Python; it reads no device).  Two
layers with different cost contracts:

* **Metrics** (:mod:`repro_torch.obs.metrics`) are always on — every
  engine owns a :class:`MetricsRegistry` and its ``EngineStats`` fields
  are views over it.
* **Span tracing** (:mod:`repro_torch.obs.trace`) is off by default; a
  :func:`span` still *times* its block (the engine consumes the elapsed
  time), but recording into the per-thread ring costs one branch until
  :func:`enable_tracing` flips it on.  Export the recording with
  :func:`write_chrome_trace` and open it in ``chrome://tracing``.

Over them sit the health layer's pieces: Prometheus text
(:mod:`.promtext`), the regression :class:`Sentinel`, the
:class:`FlightRecorder` (postmortem bundles, ``rknn-flight/1``), the live
endpoints (:mod:`.health`, ``engine.serve_obs()``) and the CLI
(``python -m repro_torch.obs``).  :func:`track_jit` is kept for API
parity and wraps nothing in this package (see :mod:`.jitmon`).

Quickstart::

    from repro_torch import obs
    obs.enable_tracing()
    eng.query_batch(qs, k=8)
    obs.write_chrome_trace("trace.json")
    print(obs.metrics_snapshot(eng.metrics))
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, process_registry
from .trace import (
    Span,
    SpanRing,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    set_tracer,
    span,
)
from .export import (
    chrome_trace,
    metrics_snapshot,
    spans,
    summarize,
    write_chrome_trace,
)
from .flight import FlightRecorder
from .jitmon import track_jit
from .promtext import render_registries, render_snapshot
from .sentinel import Rule, Sentinel, engine_rules

# Process-wide obs self-telemetry: ring saturation and intern-table
# saturation of the *current* global tracer, visible on every /metrics
# scrape and in every flight bundle (derived → zero hot-path cost).
process_registry().derived(
    "obs.intern_overflow", lambda: float(get_tracer().intern_overflows)
)
process_registry().derived(
    "obs.spans_dropped", lambda: float(get_tracer().dropped)
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanRing",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "set_tracer",
    "span",
    "chrome_trace",
    "metrics_snapshot",
    "spans",
    "summarize",
    "write_chrome_trace",
    "process_registry",
    "FlightRecorder",
    "track_jit",
    "render_registries",
    "render_snapshot",
    "Rule",
    "Sentinel",
    "engine_rules",
]
