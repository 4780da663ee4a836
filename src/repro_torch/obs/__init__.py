"""Spans and metrics the engine times and counts itself with.

Carried over from ``repro.obs`` (pure Python): :func:`span` is the
engine's timing primitive and :class:`MetricsRegistry` backs
``EngineStats``.  Export, flight recorder, sentinel and health endpoints
are not part of this package yet.
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
    "process_registry",
]
