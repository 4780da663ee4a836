"""Counters, gauges, and log-bucketed histograms for serving telemetry.

Metrics are the always-on half of the obs subsystem (spans are the
optional recording half): every engine owns a :class:`MetricsRegistry`
and the legacy ``EngineStats`` surface is rebuilt as *views* over it.

Histograms are **log-bucketed**: values land in geometric buckets of
ratio ``10^(1/20)`` (20 per decade, ≈12% width), so p50/p90/p99 come
from bucket counts alone — no samples stored, O(1) memory per metric,
O(1) ``observe``.  Signed mode mirrors the buckets around a zero bucket
so the planner's pred/obs *log-residuals* (which are signed) get the
same treatment.

Metric identity is ``(name, labels)`` where labels is a sorted tuple of
``(key, value)`` pairs — the engines key phase timings by
``(phase, backend, shard)`` per the paper's filter/verify split.
Derived gauges are registered as callables evaluated at snapshot time
(hit ratios, MVCC lag, throttle duty cycle), so the hot path never pays
for them.
"""

from __future__ import annotations

import math
import threading

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "process_registry",
]

#: Geometric bucket layout: ratio 10^(1/BUCKETS_PER_DECADE) between
#: bucket edges.  20/decade bounds the relative quantile error at
#: ~±6% (half a bucket width) — comfortably inside the 15% tolerance
#: the percentile tests assert against numpy.
BUCKETS_PER_DECADE = 20
#: Magnitudes below LO collapse into the zero bucket; above HI into the
#: overflow bucket.  [1e-8, 1e4) covers nanosecond spans to hour-long
#: phases, and (signed) planner log-residuals of every plausible size.
LO = 1e-8
HI = 1e4
_N_MAG = int(round(BUCKETS_PER_DECADE * math.log10(HI / LO)))  # per sign
_LOG_LO = math.log10(LO)


def _mag_bucket(mag: float) -> int:
    """Bucket index of a positive magnitude in [0, _N_MAG]."""
    if mag < LO:
        return -1  # caller folds into the zero bucket
    if mag >= HI:
        return _N_MAG  # overflow bucket (open-ended)
    return int((math.log10(mag) - _LOG_LO) * BUCKETS_PER_DECADE)


def _mag_value(idx: int) -> float:
    """Geometric midpoint of magnitude bucket ``idx``."""
    if idx >= _N_MAG:
        return HI
    return 10.0 ** (_LOG_LO + (idx + 0.5) / BUCKETS_PER_DECADE)


class Counter:
    """Monotone counter (GIL-atomic ``inc`` — single Python add).

    Increments are usually integers (events); float increments are
    allowed for monotone accumulated quantities (``compile.time_s``).
    """

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-value (or max-tracking) instantaneous metric."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Log-bucketed distribution: quantiles without stored samples.

    ``signed=True`` adds a mirrored negative range (and a zero bucket)
    for values like log-residuals; plain timing histograms clamp
    negatives to the zero bucket.
    """

    __slots__ = ("signed", "counts", "count", "sum", "min", "max")

    def __init__(self, signed: bool = False):
        self.signed = signed
        # layout: [neg _N_MAG..0] ++ [zero] ++ [pos 0.._N_MAG]
        n = (2 * (_N_MAG + 1) + 1) if signed else (_N_MAG + 2)
        self.counts = np.zeros(n, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        if self.signed:
            zero = _N_MAG + 1
            if v > 0:
                b = _mag_bucket(v)
                return zero if b < 0 else zero + 1 + b
            if v < 0:
                b = _mag_bucket(-v)
                return zero if b < 0 else zero - 1 - b
            return zero
        b = _mag_bucket(v) if v > 0 else -1
        return 0 if b < 0 else 1 + b

    def _value(self, idx: int) -> float:
        if self.signed:
            zero = _N_MAG + 1
            if idx == zero:
                return 0.0
            if idx > zero:
                return _mag_value(idx - zero - 1)
            return -_mag_value(zero - 1 - idx)
        return 0.0 if idx == 0 else _mag_value(idx - 1)

    def observe(self, v: float) -> None:
        self.counts[self._index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        """Accumulate another histogram (same signedness) in place."""
        if other.signed != self.signed:
            raise ValueError("cannot merge signed with unsigned histogram")
        self.counts += other.counts
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def reset(self) -> None:
        self.counts[:] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def percentile(self, q: float) -> float:
        """Bucket-midpoint quantile estimate, clamped to observed
        min/max (exact at the tails, ≲½-bucket error inside)."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        acc = 0
        for idx, c in enumerate(self.counts):
            acc += int(c)
            if acc >= target and c:
                return min(max(self._value(idx), self.min), self.max)
        return self.max

    def abs_percentile(self, q: float) -> float:
        """Quantile of |value| — the planner drift gate's median
        |log-residual| (folds the signed mirror onto magnitudes)."""
        if self.count == 0:
            return 0.0
        if not self.signed:
            return abs(self.percentile(q))
        zero = _N_MAG + 1
        folded = np.zeros(_N_MAG + 2, np.int64)
        folded[0] = self.counts[zero]
        for b in range(_N_MAG + 1):
            folded[1 + b] = self.counts[zero + 1 + b] + self.counts[zero - 1 - b]
        target = q / 100.0 * self.count
        acc = 0
        cap = max(abs(self.min), abs(self.max))
        for idx, c in enumerate(folded):
            acc += int(c)
            if acc >= target and c:
                return min((0.0 if idx == 0 else _mag_value(idx - 1)), cap)
        return cap

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _upper_edge(self, idx: int) -> float:
        """Upper bucket boundary (the Prometheus ``le`` value) of slot
        ``idx``; ``inf`` for the positive overflow bucket."""
        if self.signed:
            zero = _N_MAG + 1
            if idx == zero:
                return LO  # zero bucket covers (-LO, LO)
            if idx > zero:
                b = idx - zero - 1  # positive magnitude bucket
                if b >= _N_MAG:
                    return math.inf
                return 10.0 ** (_LOG_LO + (b + 1) / BUCKETS_PER_DECADE)
            b = zero - 1 - idx  # negative magnitude bucket
            # covers (-10^(lo+(b+1)/BPD), -10^(lo+b/BPD)]
            return -(10.0 ** (_LOG_LO + b / BUCKETS_PER_DECADE))
        if idx == 0:
            return LO
        b = idx - 1
        if b >= _N_MAG:
            return math.inf
        return 10.0 ** (_LOG_LO + (b + 1) / BUCKETS_PER_DECADE)

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Non-empty buckets as Prometheus-style cumulative
        ``(upper_edge, count_le)`` pairs, ascending.  Only occupied
        buckets are emitted (the renderer appends ``+Inf`` = count), so
        exposition size tracks the observed spread, not the layout."""
        out: list[tuple[float, int]] = []
        acc = 0
        for idx, c in enumerate(self.counts):
            if c:
                acc += int(c)
                out.append((self._upper_edge(idx), acc))
        return out

    def summary(self) -> dict:
        """Flat snapshot row: count/sum/mean and the headline quantiles."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_key(name: str, key: tuple) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class MetricsRegistry:
    """Get-or-create store of metrics keyed by ``(name, labels)``.

    Lookup is a dict hit (no lock on the hot path — creation is locked,
    reads ride the GIL like the rest of the MVCC read path); engines
    additionally cache handles for their per-query metrics so steady
    state is attribute access + int add.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._store: dict[tuple, object] = {}
        self._derived: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        m = self._store.get(key)
        if m is None:
            with self._lock:
                m = self._store.get(key)
                if m is None:
                    m = cls(**kw)
                    self._store[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {key} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, signed: bool = False, **labels) -> Histogram:
        return self._get(Histogram, name, labels, signed=signed)

    def derived(self, name: str, fn, **labels) -> None:
        """Register a gauge computed at snapshot time; ``fn`` returning
        ``None`` omits the row (signal not available yet)."""
        with self._lock:
            self._derived[(name, _label_key(labels))] = fn

    # ---- read side --------------------------------------------------------
    def items(self) -> list[tuple[str, dict, object]]:
        """Every live metric as ``(name, labels, metric)`` — the object
        view the Prometheus renderer needs (bucket counts, not just the
        quantile summary :meth:`snapshot` flattens to)."""
        with self._lock:
            items = sorted(self._store.items())
        return [(k[0], dict(k[1]), m) for k, m in items]

    def derived_items(self) -> list[tuple[str, dict, float]]:
        """Derived gauges evaluated now, as ``(name, labels, value)``;
        rows whose callable fails or returns ``None`` are omitted."""
        with self._lock:
            derived = sorted(self._derived.items())
        out = []
        for (name, key), fn in derived:
            try:
                v = fn()
            except Exception:
                v = None
            if v is not None:
                out.append((name, dict(key), float(v)))
        return out

    def find(self, name: str) -> list[tuple[dict, object]]:
        """All metrics registered under ``name`` as (labels, metric)."""
        with self._lock:
            items = list(self._store.items())
        return [(dict(k[1]), m) for k, m in items if k[0] == name]

    def snapshot(self) -> dict:
        """Flat ``{"name{k=v}": value-or-summary}`` dict for benches and
        the export CLI.  Derived gauges are evaluated here, never on the
        serving path."""
        with self._lock:
            items = sorted(self._store.items())
            derived = sorted(self._derived.items())
        out: dict = {}
        for key, m in items:
            k = _fmt_key(*key)
            if isinstance(m, Counter):
                out[k] = m.value
            elif isinstance(m, Gauge):
                out[k] = m.value
            else:
                out[k] = m.summary()
        for key, fn in derived:
            try:
                v = fn()
            except Exception:
                v = None
            if v is not None:
                out[_fmt_key(*key)] = v
        return out


#: Process-wide registry for metrics that are not per-engine: jit
#: compile counts, span-ring intern overflows, flight-recorder activity.
#: Engines merge it into their own exposition (``/metrics``, flight
#: bundles) so process facts travel with every engine's scrape.
_PROCESS = MetricsRegistry()


def process_registry() -> MetricsRegistry:
    return _PROCESS
