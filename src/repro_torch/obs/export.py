"""Serialize a span recording: Chrome ``trace_event`` JSON + summaries.

``chrome://tracing`` / Perfetto load the output of
:func:`chrome_trace` directly: each span becomes a complete event
(``ph: "X"``) with microsecond ``ts``/``dur``, the ring's thread id as
``tid``, and the span attrs as ``args`` — so a sharded ``query_batch``
renders as a ``batch`` bar with nested ``filter``/``verify`` bars and
per-shard children under them.

:func:`summarize` is the text twin for terminals/CI logs, and
:func:`metrics_snapshot` just re-exports the registry's flat dict so
benches import one module.
"""

from __future__ import annotations

import json

from .metrics import Histogram, MetricsRegistry
from .trace import Tracer, get_tracer

__all__ = [
    "spans",
    "chrome_trace",
    "write_chrome_trace",
    "summarize",
    "metrics_snapshot",
]


def spans(tracer: Tracer | None = None) -> list[dict]:
    """Stable decoded span records, globally time-ordered."""
    tracer = tracer or get_tracer()
    return sorted(tracer.records(), key=lambda r: r["t0"])


def chrome_trace(tracer: Tracer | None = None) -> dict:
    """The recording as a Chrome ``trace_event`` JSON object."""
    tracer = tracer or get_tracer()
    recs = spans(tracer)
    t_base = recs[0]["t0"] if recs else 0.0
    events: list[dict] = []
    seen_tids: set[int] = set()
    for r in recs:
        if r["tid"] not in seen_tids:
            seen_tids.add(r["tid"])
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 0,
                    "tid": r["tid"],
                    "args": {"name": f"thread-{len(seen_tids)}"},
                }
            )
        events.append(
            {
                "ph": "X",
                "name": r["name"],
                "pid": 0,
                "tid": r["tid"],
                "ts": (r["t0"] - t_base) * 1e6,
                "dur": (r["t1"] - r["t0"]) * 1e6,
                "args": {**r["attrs"], "seq": r["seq"], "parent": r["parent"]},
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_spans": tracer.dropped},
    }


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> dict:
    """Write :func:`chrome_trace` to ``path``; returns the object."""
    obj = chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


def metrics_snapshot(registry: MetricsRegistry) -> dict:
    """Flat bench-friendly dict of one registry (see
    :meth:`MetricsRegistry.snapshot`)."""
    return registry.snapshot()


def summarize(recs: list[dict]) -> dict:
    """Per-(name, backend) latency digest of decoded span records.

    Works on live :func:`spans` output *or* a reloaded Chrome trace's
    ``traceEvents`` (the CLI path) — pass records through
    :func:`_from_chrome` for the latter.
    """
    groups: dict[tuple, Histogram] = {}
    for r in recs:
        key = (r["name"], r["attrs"].get("backend", "-"))
        h = groups.get(key)
        if h is None:
            h = groups[key] = Histogram()
        h.observe(r["t1"] - r["t0"])
    out = {}
    for (name, backend), h in sorted(groups.items()):
        label = name if backend == "-" else f"{name}[{backend}]"
        out[label] = h.summary()
    return out


def _from_chrome(obj: dict) -> list[dict]:
    """Decode a Chrome trace JSON back into summarizable records."""
    recs = []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        seq = args.pop("seq", -1)
        parent = args.pop("parent", -1)
        t0 = ev["ts"] / 1e6
        recs.append(
            {
                "tid": ev.get("tid", 0),
                "seq": seq,
                "parent": parent,
                "name": ev["name"],
                "attrs": args,
                "t0": t0,
                "t1": t0 + ev.get("dur", 0.0) / 1e6,
                "depth": 0,
            }
        )
    return recs
