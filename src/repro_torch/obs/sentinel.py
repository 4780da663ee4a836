"""Online regression sentinel: EWMA+MAD drift tripwires with hysteresis.

The paper's performance claim is regime-dependent (ray-cast filtering
wins exactly where R-tree pruning degrades), so a serving engine can
regress *silently* when the workload drifts — the planner keeps routing,
latency creeps, cache hit ratios sag, and nothing fails.  The sentinel
watches a small set of metric families and trips when one drifts beyond
its own learned baseline (or past an absolute SLO bound):

* **Baseline**: per rule, an exponentially-weighted mean of the observed
  value plus an EWMA of absolute deviation (a robust MAD-style scale).
  A sample *breaches* when it lands more than ``k_mad`` deviations on
  the rule's bad side of the baseline — or past the rule's absolute
  ``limit`` when one is declared.
* **Hysteresis**: a rule trips only after ``trip_after`` consecutive
  breaching samples and clears only after ``clear_after`` consecutive
  healthy ones, so single outliers (a GC pause, one cold kernel build)
  never flap ``/healthz``.  While tripped the baseline is **frozen** — a
  sustained regression must recover, not merely persist long enough to
  be learned as the new normal.
* **Surfacing**: every breaching sample bumps
  ``sentinel.breach{rule=...}``; trips flip the per-rule
  ``sentinel.tripped`` gauge (and therefore ``/healthz``), and a trip
  triggers the engine's flight recorder when one is armed — the
  postmortem bundle then carries the exact rule states.

Default rules for an engine (:func:`engine_rules`) cover the JAX
package's families: per-backend query-phase latency (discovered lazily as
the engine creates its per-``(phase, backend)`` histograms), scene/batch
cache hit ratios, planner ``|ln(obs/pred)|`` medians, MVCC version lag,
and shard imbalance.  Everything the sentinel reads is lock-free (the
same GIL-published metric objects the snapshot path reads).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

from .metrics import MetricsRegistry, process_registry

__all__ = ["Rule", "Sentinel", "engine_rules"]

#: Planner drift bound shared with the scenario-sweep CI gate: median
#: |ln(observed/predicted)| per assigned backend must stay under this.
DRIFT_LIMIT = 1.5


@dataclasses.dataclass
class Rule:
    """One watched signal.

    ``value`` is pulled at every :meth:`Sentinel.observe`; ``None``
    means "no signal yet" and is skipped entirely (no baseline update,
    no breach).  ``direction`` names the *bad* side: ``"high"`` rules
    breach above baseline (latency, lag, imbalance), ``"low"`` rules
    breach below it (hit ratios).  ``limit`` is an optional absolute SLO
    bound breached regardless of the learned baseline.
    """

    name: str
    value: Callable[[], float | None]
    direction: str = "high"  # "high" | "low"
    limit: float | None = None
    k_mad: float = 6.0
    trip_after: int = 3
    clear_after: int = 2
    warmup: int = 8
    alpha: float = 0.2
    rel_floor: float = 0.05  # deviation floor as a fraction of |baseline|


class _RuleState:
    __slots__ = (
        "rule", "mean", "dev", "n", "breach_streak", "ok_streak",
        "tripped", "trips", "last", "last_breach",
    )

    def __init__(self, rule: Rule):
        self.rule = rule
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0
        self.breach_streak = 0
        self.ok_streak = 0
        self.tripped = False
        self.trips = 0
        self.last: float | None = None
        self.last_breach: str | None = None


class Sentinel:
    """Evaluates a rule set against live metrics; owns ``/healthz``.

    ``observe()`` is cheap (a handful of metric reads per rule) and
    lock-free on everything it touches; call it from a poller thread
    (:meth:`start`) or let the health server call it per ``/healthz``
    request.  ``discover`` — when given — runs before each observation
    and may register additional rules (used to pick up per-backend
    histograms the engine creates lazily).
    """

    def __init__(
        self,
        rules: list[Rule] | None = None,
        *,
        registry: MetricsRegistry | None = None,
        on_trip: Callable[["_RuleState"], None] | None = None,
        discover: Callable[["Sentinel"], None] | None = None,
    ):
        self._states: dict[str, _RuleState] = {}
        self._reg = registry if registry is not None else process_registry()
        self._on_trip = on_trip
        self._discover = discover
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        for r in rules or []:
            self.add_rule(r)

    def add_rule(self, rule: Rule) -> None:
        """Idempotent by name — re-adding an existing rule is a no-op,
        which is what lazy discovery needs."""
        if rule.name not in self._states:
            self._states[rule.name] = _RuleState(rule)

    @property
    def rules(self) -> list[str]:
        return list(self._states)

    # ---- evaluation -------------------------------------------------------
    def _eval(self, st: _RuleState, v: float) -> str | None:
        """Breach reason for sample ``v`` under ``st``'s baseline, or
        ``None`` when healthy."""
        rule = st.rule
        if rule.limit is not None:
            if rule.direction == "high" and v > rule.limit:
                return f"limit({v:.4g}>{rule.limit:.4g})"
            if rule.direction == "low" and v < rule.limit:
                return f"limit({v:.4g}<{rule.limit:.4g})"
        if st.n < rule.warmup:
            return None
        floor = rule.rel_floor * abs(st.mean)
        thr = rule.k_mad * max(st.dev, floor, 1e-12)
        if rule.direction == "high" and v > st.mean + thr:
            return f"drift({v:.4g}>{st.mean:.4g}+{thr:.4g})"
        if rule.direction == "low" and v < st.mean - thr:
            return f"drift({v:.4g}<{st.mean:.4g}-{thr:.4g})"
        return None

    def observe(self) -> bool:
        """Pull every rule once; returns the post-observation health."""
        if self._discover is not None:
            try:
                self._discover(self)
            except Exception:
                pass
        for st in list(self._states.values()):
            rule = st.rule
            try:
                v = rule.value()
            except Exception:
                v = None
            if v is None:
                continue
            v = float(v)
            st.last = v
            breach = self._eval(st, v)
            if breach is not None:
                st.last_breach = breach
                st.breach_streak += 1
                st.ok_streak = 0
                self._reg.counter("sentinel.breach", rule=rule.name).inc()
                if not st.tripped and st.breach_streak >= rule.trip_after:
                    st.tripped = True
                    st.trips += 1
                    self._reg.gauge("sentinel.tripped", rule=rule.name).set(1.0)
                    if self._on_trip is not None:
                        try:
                            self._on_trip(st)
                        except Exception:
                            pass
            else:
                st.ok_streak += 1
                st.breach_streak = 0
                if st.tripped and st.ok_streak >= rule.clear_after:
                    st.tripped = False
                    self._reg.gauge("sentinel.tripped", rule=rule.name).set(0.0)
                if not st.tripped:
                    # frozen while tripped: a sustained regression must
                    # recover, not get adopted as the new baseline
                    a = rule.alpha if st.n else 1.0
                    st.mean += a * (v - st.mean)
                    st.dev += a * (abs(v - st.mean) - st.dev)
                    st.n += 1
        return self.healthy

    @property
    def healthy(self) -> bool:
        return not any(st.tripped for st in self._states.values())

    def state(self) -> dict:
        """JSON-able per-rule digest for ``/healthz`` and flight bundles."""
        return {
            name: dict(
                tripped=st.tripped,
                trips=st.trips,
                last=st.last,
                baseline=(st.mean if st.n else None),
                dev=(st.dev if st.n else None),
                samples=st.n,
                breach_streak=st.breach_streak,
                last_breach=st.last_breach,
            )
            for name, st in sorted(self._states.items())
        }

    # ---- background poller ------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "Sentinel":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                self.observe()

        self._thread = threading.Thread(
            target=loop, name="rknn-sentinel", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


# ---------------------------------------------------------------------------
# default rule families for an engine
# ---------------------------------------------------------------------------
def engine_rules(engine) -> tuple[list[Rule], Callable[[Sentinel], None]]:
    """The default watch list for one engine: static rules over
    the always-present families plus a discovery hook that adds a
    latency rule per ``(phase, backend)`` histogram as the engine
    creates them lazily."""
    m = engine.metrics

    def derived_value(name: str) -> Callable[[], float | None]:
        def value() -> float | None:
            for n, _labels, v in m.derived_items():
                if n == name:
                    return v
            return None

        return value

    def gauge_value(name: str) -> Callable[[], float | None]:
        def value() -> float | None:
            found = m.find(name)
            return found[0][1].value if found else None

        return value

    def drift_value() -> float | None:
        worst = None
        for _labels, h in m.find("planner.residual"):
            if h.count >= 8:
                med = h.abs_percentile(50.0)
                worst = med if worst is None else max(worst, med)
        return worst

    rules = [
        Rule("scene_cache.hit_ratio", derived_value("scene_cache.hit_ratio"),
             direction="low"),
        Rule("batch_cache.hit_ratio", derived_value("batch_cache.hit_ratio"),
             direction="low"),
        Rule("mvcc.version_lag", gauge_value("mvcc.version_lag"),
             direction="high"),
        Rule("shard.imbalance", gauge_value("shard.imbalance"),
             direction="high"),
        Rule("planner.drift", drift_value, direction="high",
             limit=DRIFT_LIMIT),
    ]

    def discover(sentinel: Sentinel) -> None:
        for labels, h in m.find("phase_s"):
            phase = labels.get("phase", "-")
            backend = labels.get("backend", "-")
            for q in (50.0, 99.0):
                hist = h

                def value(hist=hist, q=q) -> float | None:
                    return hist.percentile(q) if hist.count >= 8 else None

                sentinel.add_rule(
                    Rule(f"p{int(q)}.{phase}.{backend}", value,
                         direction="high")
                )

    return rules, discover
