"""Low-overhead nestable span tracing over preallocated ring buffers.

The serving engine's timing story used to be ~20 scattered
``time.perf_counter()`` pairs whose sums landed in ad-hoc ``EngineStats``
fields.  This module replaces the *measurement* half of that: a
:func:`span` context manager times one phase (it is the perf-counter
pair, so the engine's stats and the planner's observed costs keep their
exact semantics) and — only when tracing is enabled — appends one
fixed-size record to a per-thread ring buffer that
:mod:`repro.obs.export` can serialize as a Chrome ``trace_event`` JSON.

Design constraints, in order:

* **Hot-path overhead is one branch when disabled.**  A span always
  takes its two ``perf_counter`` readings (the engine needs the elapsed
  time regardless — that cost predates this module); everything else
  (string interning, ring write) sits behind a single
  ``if tracer.enabled`` test at span exit.
* **Lock-free under the MVCC read path.**  Each thread owns exactly one
  :class:`SpanRing` (single writer); record columns are preallocated
  numpy arrays, so a write is a handful of scalar stores with no
  allocation and no lock.  Readers (the exporter) never block writers:
  they snapshot the columns and use a seqlock-style double read of the
  monotone ``total`` counter to discard any slot a concurrent wrap
  may have been overwriting — a torn record is *unobservable*, not
  merely unlikely.
* **Never blocks when full.**  The ring wraps: the newest ``capacity``
  records are kept, the overwritten ones are counted in the ring's
  monotone ``dropped`` counter (exact, because the writer is single).

Span *attribution* (which backend, which shard, which snapshot version)
travels as keyword attrs, interned process-wide into small integer ids
so the record stays fixed-size; nesting is recorded explicitly
(per-thread parent seq + depth) rather than inferred from timestamps.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator

import numpy as np

__all__ = [
    "Span",
    "SpanRing",
    "Tracer",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "span",
]

#: Default per-thread ring capacity (records).  At ~6 spans per served
#: batch this holds tens of thousands of batches; a long recording wraps
#: and keeps the newest window, which is what a trace viewer wants.
DEFAULT_CAPACITY = 1 << 16

#: Intern-table safety cap: attr combinations beyond this map to id 0
#: ("overflow") instead of growing the table without bound (e.g. a
#: version= attr on an engine applying millions of updates).
MAX_INTERNED = 1 << 16


class _Interner:
    """Process-wide value → small-int id table (insert-locked reads-free).

    Saturation is *counted*, not silent: once the table is full every
    novel value maps to the pre-seeded sentinel id 0 and bumps
    ``overflows``, which the obs layer surfaces as the
    ``obs.intern_overflow`` gauge so a postmortem can tell "these spans
    all collapsed to <overflow>" from "the workload really was uniform".
    """

    def __init__(self, cap: int = MAX_INTERNED):
        self._lock = threading.Lock()
        self._ids: dict = {}
        self._values: list = []
        self._cap = cap
        self.overflows = 0  # novel values refused after saturation

    def intern(self, value) -> int:
        hit = self._ids.get(value)  # GIL-atomic read, no lock
        if hit is not None:
            return hit
        with self._lock:
            hit = self._ids.get(value)
            if hit is not None:
                return hit
            if len(self._values) >= self._cap:
                self.overflows += 1
                return 0  # overflow sentinel (id 0 is always pre-seeded)
            idx = len(self._values)
            self._values.append(value)
            self._ids[value] = idx
            return idx

    def value(self, idx: int):
        try:
            return self._values[idx]
        except IndexError:
            return self._values[0]


class SpanRing:
    """One thread's preallocated span-record ring (single writer).

    Columns are plain numpy arrays; slot ``i`` of record ``seq`` is
    ``seq % capacity``.  ``total`` (a monotone Python int, assigned
    *after* the record's columns) doubles as the seqlock publication
    point for concurrent readers.
    """

    __slots__ = (
        "tid", "capacity", "total",
        "name_id", "attr_id", "t0", "t1", "depth", "parent",
    )

    def __init__(self, tid: int, capacity: int):
        self.tid = int(tid)
        self.capacity = int(capacity)
        self.total = 0  # records ever written (monotone)
        self.name_id = np.zeros(capacity, np.int32)
        self.attr_id = np.zeros(capacity, np.int32)
        self.t0 = np.zeros(capacity, np.float64)
        self.t1 = np.zeros(capacity, np.float64)
        self.depth = np.zeros(capacity, np.int16)
        self.parent = np.full(capacity, -1, np.int64)

    @property
    def dropped(self) -> int:
        """Records overwritten by wraparound (exact; single writer)."""
        return max(self.total - self.capacity, 0)

    def write(self, name_id: int, attr_id: int, t0: float, t1: float,
              depth: int, parent: int) -> int:
        """Append one record; returns its seq.  Never blocks: a full
        ring wraps, dropping the oldest record (counted via ``total``)."""
        seq = self.total
        i = seq % self.capacity
        self.name_id[i] = name_id
        self.attr_id[i] = attr_id
        self.t0[i] = t0
        self.t1[i] = t1
        self.depth[i] = depth
        self.parent[i] = parent
        self.total = seq + 1  # publish last (seqlock point)
        return seq

    def stable_records(self) -> tuple[dict, int, int]:
        """Seqlock read: snapshot the columns and the seq window
        ``[lo, hi)`` guaranteed torn-free (slots a concurrent wrap may
        have touched during the copy are excluded)."""
        before = self.total
        cols = dict(
            name_id=self.name_id.copy(),
            attr_id=self.attr_id.copy(),
            t0=self.t0.copy(),
            t1=self.t1.copy(),
            depth=self.depth.copy(),
            parent=self.parent.copy(),
        )
        after = self.total
        lo = max(after - self.capacity, 0)
        return cols, lo, before


class Span:
    """One timed phase.  Always measures (``elapsed_s`` is the replaced
    ``perf_counter`` pair); records into the thread's ring only when the
    owning tracer is enabled at exit."""

    __slots__ = ("tracer", "name", "attrs", "t0", "t1", "seq", "_parent", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.seq = -1

    @property
    def elapsed_s(self) -> float:
        return (self.t1 if self.t1 else time.perf_counter()) - self.t0

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1].seq if stack else -1
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.t1:
            return  # idempotent: a manually closed span exits its `with` too
        self.t1 = time.perf_counter()
        tracer = self.tracer
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate exception-skewed exits
            stack.remove(self)
        if tracer.enabled:  # the one hot-path branch
            self.seq = tracer._record(self)


class Tracer:
    """Process-wide span collector: one :class:`SpanRing` per thread.

    Disabled by default — :func:`span` still times, nothing is recorded.
    ``enable()`` / ``disable()`` flip recording; rings persist across
    flips so a recording can be inspected after disabling.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_interned: int = MAX_INTERNED):
        self.capacity = int(capacity)
        self.enabled = False
        self.names = _Interner(max_interned)
        self.attrs = _Interner(max_interned)
        self.names.intern("<overflow>")  # seed id 0 for both tables
        self.attrs.intern(())
        self._local = threading.local()
        self._rings: dict[int, SpanRing] = {}
        self._rings_lock = threading.Lock()

    # ---- per-thread state -------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _ring(self) -> SpanRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            tid = threading.get_ident()
            ring = SpanRing(tid, self.capacity)
            self._local.ring = ring
            with self._rings_lock:
                self._rings[tid] = ring
        return ring

    def _record(self, sp: Span) -> int:
        name_id = self.names.intern(sp.name)
        attr_id = (
            self.attrs.intern(tuple(sorted(sp.attrs.items())))
            if sp.attrs
            else 0
        )
        return self._ring().write(
            name_id, attr_id, sp.t0, sp.t1, sp._depth, sp._parent
        )

    # ---- control ----------------------------------------------------------
    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        """Drop all recorded rings (not the intern tables)."""
        with self._rings_lock:
            self._rings.clear()
        self._local = threading.local()

    # ---- read side --------------------------------------------------------
    @property
    def intern_overflows(self) -> int:
        """Novel names/attr-tuples refused since the intern tables
        saturated (their spans carry the sentinel id 0)."""
        return self.names.overflows + self.attrs.overflows

    @property
    def dropped(self) -> int:
        with self._rings_lock:
            rings = list(self._rings.values())
        return sum(r.dropped for r in rings)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs or None)

    def records(self) -> Iterator[dict]:
        """Decoded stable records across all rings (oldest-first per
        thread).  Safe to call while writers are live — see
        :meth:`SpanRing.stable_records`."""
        with self._rings_lock:
            rings = list(self._rings.values())
        for ring in rings:
            cols, lo, hi = ring.stable_records()
            for seq in range(lo, hi):
                i = seq % ring.capacity
                yield dict(
                    tid=ring.tid,
                    seq=seq,
                    name=self.names.value(int(cols["name_id"][i])),
                    attrs=dict(self.attrs.value(int(cols["attr_id"][i]))),
                    t0=float(cols["t0"][i]),
                    t1=float(cols["t1"][i]),
                    depth=int(cols["depth"][i]),
                    parent=int(cols["parent"][i]),
                )


#: The global tracer every engine span routes through.  Swappable for
#: test isolation via :func:`set_tracer`.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Install a fresh tracer (tests; returns the previous one)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def enable_tracing(capacity: int | None = None) -> Tracer:
    """Enable span recording on the global tracer.  ``capacity`` replaces
    the tracer (fresh rings) when given."""
    if capacity is not None:
        set_tracer(Tracer(capacity))
    return get_tracer().enable()


def disable_tracing() -> Tracer:
    return get_tracer().disable()


def span(name: str, **attrs) -> Span:
    """A nestable timed span on the global tracer.

    Always measures (use ``sp.elapsed_s`` after the block — this *is*
    the engine's perf-counter pair); records into the per-thread ring
    only while tracing is enabled.
    """
    return Span(_TRACER, name, attrs or None)
