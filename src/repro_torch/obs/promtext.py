"""Prometheus text exposition over :class:`~repro_torch.obs.metrics.MetricsRegistry`.

Two render paths share the formatting core:

* :func:`render_registries` walks live registry objects — counters and
  gauges become single samples, histograms become the standard
  cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` triple (only
  occupied buckets plus the mandatory ``+Inf`` are emitted; cumulative
  counts stay exact because empty buckets add nothing).  Derived gauges
  are evaluated at render time, like :meth:`MetricsRegistry.snapshot`.
* :func:`render_snapshot` re-renders a *flat* snapshot dict (the
  ``name{k=v}`` → value/summary shape benches and flight bundles store)
  — histogram summaries become Prometheus *summary* quantile rows since
  the bucket counts are gone by then.

Names are sanitized to the Prometheus grammar (``.`` and any other
illegal character → ``_``); label values are escaped per the text
format.  No external client library — the text format is ~20 lines of
string assembly, and the container must not grow dependencies.
"""

from __future__ import annotations

import math
import re

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["render_registries", "render_snapshot", "sanitize_name"]

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_FLAT_KEY = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$")


def sanitize_name(name: str) -> str:
    """Map a registry metric name onto the Prometheus grammar."""
    out = _NAME_BAD.sub("_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _esc_label(v: object) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict, extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [(sanitize_name(str(k)), _esc_label(v)) for k, v in sorted(labels.items())]
    pairs += list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _num(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return repr(f)


def _le(edge: float) -> str:
    if math.isinf(edge):
        return "+Inf"
    return f"{edge:.6g}"


class _Family:
    """One exposition family: TYPE header + accumulated sample lines."""

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        self.lines: list[str] = []


def _families_from_registry(reg: MetricsRegistry, fams: dict[str, _Family]) -> None:
    for name, labels, m in reg.items():
        pname = sanitize_name(name)
        if isinstance(m, Counter):
            fam = fams.setdefault(pname, _Family(pname, "counter"))
            fam.lines.append(f"{pname}{_labels(labels)} {_num(m.value)}")
        elif isinstance(m, Gauge):
            fam = fams.setdefault(pname, _Family(pname, "gauge"))
            fam.lines.append(f"{pname}{_labels(labels)} {_num(m.value)}")
        elif isinstance(m, Histogram):
            fam = fams.setdefault(pname, _Family(pname, "histogram"))
            for edge, cum in m.cumulative_buckets():
                fam.lines.append(
                    f"{pname}_bucket{_labels(labels, (('le', _le(edge)),))} {cum}"
                )
            fam.lines.append(
                f"{pname}_bucket{_labels(labels, (('le', '+Inf'),))} {m.count}"
            )
            fam.lines.append(f"{pname}_sum{_labels(labels)} {_num(m.sum)}")
            fam.lines.append(f"{pname}_count{_labels(labels)} {m.count}")
    for name, labels, v in reg.derived_items():
        pname = sanitize_name(name)
        fam = fams.setdefault(pname, _Family(pname, "gauge"))
        fam.lines.append(f"{pname}{_labels(labels)} {_num(v)}")


def _emit(fams: dict[str, _Family]) -> str:
    out: list[str] = []
    for name in sorted(fams):
        fam = fams[name]
        out.append(f"# TYPE {name} {fam.kind}")
        out.extend(fam.lines)
    return "\n".join(out) + "\n" if out else ""


def render_registries(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition of one or more live registries (the
    engine registry plus :func:`~repro_torch.obs.metrics.process_registry`).
    Read-only and lock-free on the serving path: it reads GIL-published
    metric objects the same way the snapshot path does."""
    fams: dict[str, _Family] = {}
    for reg in registries:
        _families_from_registry(reg, fams)
    return _emit(fams)


def _parse_flat_key(key: str) -> tuple[str, dict]:
    m = _FLAT_KEY.match(key)
    if m is None:
        return key, {}
    name = m.group("name")
    raw = m.group("labels")
    labels: dict = {}
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def render_snapshot(snapshot: dict) -> str:
    """Re-render a flat ``MetricsRegistry.snapshot()`` dict (e.g. the
    ``metrics`` section of a flight bundle) as Prometheus text.
    Histogram summaries become summary-type quantile rows."""
    fams: dict[str, _Family] = {}
    for key in sorted(snapshot):
        value = snapshot[key]
        name, labels = _parse_flat_key(key)
        pname = sanitize_name(name)
        if isinstance(value, dict):  # histogram summary row
            fam = fams.setdefault(pname, _Family(pname, "summary"))
            for q in ("p50", "p90", "p99"):
                if q in value:
                    qv = str(float(q[1:]) / 100.0)
                    fam.lines.append(
                        f"{pname}{_labels(labels, (('quantile', qv),))} "
                        f"{_num(value[q])}"
                    )
            fam.lines.append(f"{pname}_sum{_labels(labels)} {_num(value.get('sum', 0.0))}")
            fam.lines.append(f"{pname}_count{_labels(labels)} {value.get('count', 0)}")
        elif isinstance(value, (int, float)):
            fam = fams.setdefault(pname, _Family(pname, "gauge"))
            fam.lines.append(f"{pname}{_labels(labels)} {_num(value)}")
    return _emit(fams)
