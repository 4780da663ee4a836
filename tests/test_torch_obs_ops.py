"""The port's ops layer (``repro_torch.obs``) against ``repro.obs``, on the CPU.

Both packages are handed the same metric values and the same recorded
spans, and must give the same answers.  Tolerance: exact everywhere —
Prometheus text byte for byte, Chrome traces, span digests and sentinel
states equal as JSON values, flight bundles equal in their keys and
schema (their values hold times, paths and process-salted fingerprints).

* ``promtext``: ``render_registries`` and ``render_snapshot`` of
  registries filled alike in both packages, and ``sanitize_name``;
* ``export``: ``chrome_trace``, ``summarize`` and ``_from_chrome`` over one
  recording (a port ``Tracer`` handed to both packages' exporters);
* ``sentinel``: the state sequence of a rule fed one value series, for
  each rule family's options, and the rule names ``engine_rules``
  discovers on an engine of each package after the same queries;
* ``flight``: a bundle written for a failed query by each package's
  ``RkNNEngine``, ``DynamicEngine`` and ``ShardedEngine`` — keys and
  ``schema`` equal; both packages' CLIs digest the port's bundle;
* ``jitmon``: callables without a compile-cache probe come back
  unchanged; the process gauges of ``repro_torch.obs`` are JAX's.
"""

import json
import math
import threading

import numpy as np
import pytest

import repro.obs as jobs
import repro.obs.__main__ as jmain
import repro.obs.export as jexport
import repro.obs.promtext as jprom
import repro_torch.obs as tobs
import repro_torch.obs.__main__ as tmain
import repro_torch.obs.export as texport
import repro_torch.obs.promtext as tprom
from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro_torch.core.engine import RkNNConfig, RkNNEngine

from tests._torch_parity import CPU, instance


# ---------------------------------------------------------------------------
# promtext
# ---------------------------------------------------------------------------
def _fill(mod, case: str):
    """A registry of ``mod`` (either package's ``obs``) holding ``case``'s
    metric values."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(len(case))
    if case in ("scalars", "mixed"):
        reg.counter("queries").inc(17)
        reg.counter("batch_cache.hits").inc(3.5)
        reg.gauge("m_max").set(123)
        reg.gauge("mvcc.version_lag").set(0.0)
        reg.gauge("persist.bytes", category="scenes", op="save").set(2.5e9)
    if case in ("histograms", "mixed"):
        for phase in ("filter", "verify"):
            h = reg.histogram("phase_s", phase=phase, backend="grid-pallas")
            for v in rng.lognormal(-4.0, 1.5, 200):
                h.observe(float(v))
        s = reg.histogram("planner.residual", signed=True, backend="dense")
        for v in rng.normal(0.0, 0.4, 50):
            s.observe(float(v))
        reg.histogram("empty_s")
    if case == "labels":
        reg.counter("odd name-with.dots", **{"a b": 'x"y', "c": "new\nline"}).inc()
        reg.gauge("9starts.with_digit", path="C:\\dir").set(-1.25)
        reg.gauge("special", v="inf").set(math.inf)
        reg.gauge("special", v="-inf").set(-math.inf)
        reg.gauge("special", v="nan").set(math.nan)
        reg.gauge("flag").set(True)
    if case in ("derived", "mixed"):
        reg.derived("scene_cache.hit_ratio", lambda: 0.75)
        reg.derived("mem.bytes", lambda: 4096.0, category="users")
        reg.derived("mem.bytes", lambda: 0.0, category="total")
        reg.derived("none_yet", lambda: None)
        reg.derived("broken", lambda: 1 / 0)
    return reg


PROM_CASES = ("scalars", "histograms", "labels", "derived", "mixed")


@pytest.mark.parametrize("case", PROM_CASES)
def test_render_registries_byte_identical(case):
    got = tprom.render_registries(_fill(tobs, case))
    want = jprom.render_registries(_fill(jobs, case))
    assert got == want
    assert got  # every case renders something


@pytest.mark.parametrize("case", PROM_CASES)
def test_render_snapshot_byte_identical(case):
    snap = _fill(tobs, case).snapshot()
    assert snap == _fill(jobs, case).snapshot()
    assert tprom.render_snapshot(snap) == jprom.render_snapshot(snap)


def test_render_of_two_registries_byte_identical():
    got = tprom.render_registries(_fill(tobs, "scalars"), _fill(tobs, "derived"))
    want = jprom.render_registries(_fill(jobs, "scalars"), _fill(jobs, "derived"))
    assert got == want


@pytest.mark.parametrize(
    "name", ["phase_s", "mem.bytes", "a-b c", "9x", "_ok:colon", "ünïcode", ""]
)
def test_sanitize_name_equal(name):
    assert tprom.sanitize_name(name) == jprom.sanitize_name(name)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def _record(case: str) -> "tobs.Tracer":
    """A port recording of ``case``: nested spans, spans on two threads, or
    a ring that wrapped (dropped records)."""
    tr = tobs.Tracer(capacity=8 if case == "wrapped" else 1 << 10)
    tr.enable()
    if case == "nested":
        with tr.span("batch", backend="dense", q=4):
            with tr.span("filter", backend="dense"):
                pass
            with tr.span("verify", backend="dense", n=3):
                with tr.span("shard-verify", shard=0):
                    pass
        with tr.span("batch", backend="grid-pallas"):
            pass
    elif case == "threads":
        def work(i):
            for j in range(3):
                with tr.span("scene-build", version=i):
                    with tr.span("verify", backend="bvh", j=j):
                        pass

        ths = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    else:
        for i in range(20):
            with tr.span("update", version=i):
                pass
    return tr


SPAN_CASES = ("nested", "threads", "wrapped")


@pytest.mark.parametrize("case", SPAN_CASES)
def test_chrome_trace_and_summary_equal_on_one_recording(case):
    tr = _record(case)
    got, want = texport.chrome_trace(tr), jexport.chrome_trace(tr)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["otherData"]["dropped_spans"] == tr.dropped
    if case == "wrapped":
        assert tr.dropped > 0
    recs = texport.spans(tr)
    assert recs == jexport.spans(tr) and recs
    assert texport.summarize(recs) == jexport.summarize(recs)
    back = texport._from_chrome(got)
    assert back == jexport._from_chrome(got)
    assert texport.summarize(back).keys() == texport.summarize(recs).keys()


def test_write_chrome_trace_and_trace_cli(tmp_path, capsys):
    tr = _record("nested")
    path = str(tmp_path / "trace.json")
    obj = texport.write_chrome_trace(path, tr)
    assert json.load(open(path)) == json.loads(json.dumps(obj))
    assert tmain.main([path, "--slowest", "2"]) == 0
    got = capsys.readouterr().out
    assert jmain.main([path, "--slowest", "2"]) == 0
    assert got == capsys.readouterr().out
    assert "batch[dense]" in got


def test_metrics_snapshot_is_the_registry_snapshot():
    reg = _fill(tobs, "mixed")
    assert tobs.metrics_snapshot(reg) == reg.snapshot() == jobs.metrics_snapshot(_fill(jobs, "mixed"))


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------
SERIES = {
    # (rule options, values); None means "no signal yet"
    "outlier": (dict(direction="high", warmup=4), [1.0] * 10 + [50.0] + [1.0] * 5),
    "shift": (dict(direction="high", warmup=4, trip_after=3, clear_after=2),
              [1.0] * 10 + [9.0] * 6 + [1.0] * 6),
    "low": (dict(direction="low", warmup=5), [0.9] * 8 + [0.1] * 5 + [0.9] * 4),
    "limit": (dict(direction="high", limit=1.5, warmup=100), [0.5, 2.0, 2.0, 2.0, 0.1, 0.1, 0.1]),
    "gaps": (dict(direction="high", warmup=2), [None, 1.0, None, 1.0, 1.0, 30.0, 30.0, 30.0, None]),
    "noisy": (dict(direction="high", k_mad=3.0, alpha=0.3),
              list(np.random.default_rng(5).lognormal(0.0, 0.5, 40))),
}


@pytest.mark.parametrize("case", sorted(SERIES))
def test_sentinel_state_sequence_equal(case):
    opts, values = SERIES[case]
    seqs = []
    for mod in (tobs, jobs):
        vals: list = []
        rule = mod.Rule("lat", lambda vals=vals: vals[-1] if vals else None, **opts)
        reg = mod.MetricsRegistry()
        s = mod.Sentinel([rule], registry=reg)
        seq = []
        for v in values:
            vals.append(None if v is None else float(v))
            seq.append((s.observe(), s.state()))
        seqs.append((seq, reg.snapshot()))
    assert json.dumps(seqs[0], sort_keys=True) == json.dumps(seqs[1], sort_keys=True)
    if case in ("shift", "low", "limit", "gaps"):
        assert any(not healthy for healthy, _ in seqs[0][0])


def test_engine_rules_discovered_equal():
    """The same queries on an engine of each package: the sentinel's rule
    names, static and discovered per ``phase_s`` histogram, are equal."""
    F, U, _ = instance(3, M=40, N=300)
    tq = RkNNEngine(F, U, RkNNConfig(backend="grid"), device=CPU)
    jq = JEngine(F, U, JConfig(backend="grid"))
    for eng in (tq, jq):
        for _ in range(3):
            eng.query_batch([0, 4, 9], 5)
            eng.query(2, 5)
    for eng in (tq, jq):
        eng.sentinel.observe()
    assert tq.sentinel.rules == jq.sentinel.rules
    assert "p99.verify.grid" in tq.sentinel.rules
    assert tq.sentinel is tq.sentinel  # built once


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _engines(kind: str, F, U, flight_dir: str):
    cfg = dict(backend="grid", flight_recorder=True, flight_dir=flight_dir)
    if kind == "RkNNEngine":
        return RkNNEngine(F, U, RkNNConfig(**cfg), device=CPU), JEngine(F, U, JConfig(**cfg))
    if kind == "DynamicEngine":
        import repro.dynamic as jd
        import repro_torch.dynamic as td

        return (td.DynamicEngine(F, U, RkNNConfig(**cfg), device=CPU),
                jd.DynamicEngine(F, U, JConfig(**cfg)))
    import repro.shard as js
    import repro_torch.shard as ts

    return (ts.ShardedEngine(F, U, RkNNConfig(**cfg), shards=2, device=CPU),
            js.ShardedEngine(F, U, JConfig(**cfg), shards=2))


def _keys(obj, depth=2):
    """The nested key structure of a JSON object, ``depth`` levels deep."""
    if not isinstance(obj, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


@pytest.mark.parametrize("kind", ["RkNNEngine", "DynamicEngine", "ShardedEngine"])
def test_flight_bundle_keys_and_schema_equal(kind, tmp_path):
    F, U, _ = instance(4, M=30, N=200)
    bundles = []
    for i, eng in enumerate(_engines(kind, F, U, str(tmp_path / "x"))):
        eng.flight.dir = str(tmp_path / str(i))
        eng.query_batch([0, 3], 4)
        with pytest.raises(IndexError):
            eng.query(len(F) + 5, 4)
        [path] = sorted((tmp_path / str(i)).glob("*.json"))
        bundles.append(json.loads(path.read_text()))
    got, want = bundles
    assert got["schema"] == want["schema"] == "rknn-flight/1"
    assert got["reason"] == want["reason"] == "exception:query"
    assert got.keys() == want.keys()
    # the metrics differ only by the JAX package's jit compile counters
    assert _keys({k: v for k, v in got.items() if k != "metrics"}) == _keys(
        {k: v for k, v in want.items() if k != "metrics"})
    assert got["exception"]["type"] == want["exception"]["type"] == "IndexError"
    assert got["engine"]["class"] == want["engine"]["class"] == kind
    assert got["engine"]["n_users"] == want["engine"]["n_users"] == len(U)
    cfg_t, cfg_j = got["engine"]["config"], want["engine"]["config"]
    assert cfg_t.keys() == cfg_j.keys()
    assert {k: v for k, v in cfg_t.items() if k != "backend"} == {
        k: v for k, v in cfg_j.items() if k != "backend"}
    assert {k for k in got["metrics"] if not k.startswith("compile.")} <= set(want["metrics"])
    if kind == "ShardedEngine":
        assert got["engine"]["shards"].keys() == want["engine"]["shards"].keys()


def test_postmortem_and_prom_clis_digest_a_port_bundle(tmp_path, capsys):
    F, U, _ = instance(5, M=30, N=200)
    eng = RkNNEngine(F, U, RkNNConfig(backend="grid", flight_recorder=True,
                                      flight_dir=str(tmp_path)), device=CPU)
    tr = tobs.Tracer(capacity=1 << 10)
    prev = tobs.set_tracer(tr)
    tr.enable()
    try:
        eng.query_batch([0, 1], 4)
        with pytest.raises(IndexError):
            eng.query(10_000, 4)
    finally:
        tobs.set_tracer(prev)
    [path] = sorted(tmp_path.glob("*.json"))
    bundle = json.loads(path.read_text())
    assert bundle["spans"] and bundle["spans_dropped"] == 0
    assert tmain.main(["--postmortem", str(path), "--slowest", "3"]) == 0
    ours = capsys.readouterr().out
    assert "rknn-flight/1" in ours and "exception:query" in ours
    assert jmain._digest_postmortem(str(path), slowest=3) == 0
    assert capsys.readouterr().out == ours
    assert tmain.main(["--prom", str(path)]) == 0
    prom = capsys.readouterr().out
    assert prom == jprom.render_snapshot(bundle["metrics"]) and "# TYPE queries" in prom


def test_flight_context_manager_and_rate_limit(tmp_path):
    F, U, _ = instance(6, M=30, N=200)
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    with pytest.raises(RuntimeError):
        with tobs.FlightRecorder(eng, dir=str(tmp_path), min_interval_s=0.0):
            raise RuntimeError("boom")
    assert eng.flight is None  # disarmed on exit
    [bundle] = sorted(tmp_path.glob("*.json"))
    payload = json.loads(bundle.read_text())
    assert payload["reason"] == "exception:block"
    assert payload["exception"]["message"] == "boom"

    rec = tobs.FlightRecorder(eng, dir=str(tmp_path / "rl"), min_interval_s=60.0)
    suppressed = tobs.process_registry().counter("flight.suppressed").value
    assert rec.dump("one") is not None
    assert rec.dump("two") is None
    assert tobs.process_registry().counter("flight.suppressed").value == suppressed + 1
    assert len(list((tmp_path / "rl").glob("*.json"))) == 1


def test_config_arms_a_recorder_and_a_failing_engine_dumps(tmp_path):
    F, U, _ = instance(7, M=30, N=200)
    eng = RkNNEngine(F, U, RkNNConfig(flight_recorder=True, flight_dir=str(tmp_path)),
                     device=CPU)
    assert isinstance(eng.flight, tobs.FlightRecorder)
    assert eng.flight.dir == str(tmp_path)
    with pytest.raises(IndexError):
        eng.query_batch([0, 10_000], 4)
    [bundle] = sorted(tmp_path.glob("*.json"))
    assert json.loads(bundle.read_text())["reason"] == "exception:query_batch"
    assert RkNNEngine(F, U, device=CPU).flight is None


# ---------------------------------------------------------------------------
# jitmon and the process gauges
# ---------------------------------------------------------------------------
def test_track_jit_returns_plain_callables_unchanged():
    def f(x):
        return x + 1

    assert tobs.track_jit(f, "plain-f") is f
    assert tobs.track_jit(RkNNEngine.query_batch, "plain-qb") is RkNNEngine.query_batch
    assert not [k for k in tobs.process_registry().snapshot() if "fn=plain-" in k]


def test_track_jit_counts_growth_of_a_cache_probe():
    """A callable with a compile-cache probe (none exists in this package)
    is counted as JAX's wrapper counts it."""
    class Probed:
        def __init__(self):
            self.n = 0

        def _cache_size(self):
            return self.n

        def __call__(self, grow):
            self.n += grow
            return grow

    counts = []
    for mod in (tobs, jobs):
        fn = Probed()
        wrapped = mod.track_jit(fn, f"probe-{mod.__name__}")
        for g in (1, 0, 2):
            wrapped(g)
        reg = mod.process_registry()
        counts.append(reg.counter("compile.count", fn=f"probe-{mod.__name__}").value)
    assert counts == [3, 3]


def test_process_gauges_registered_as_in_jax():
    names = {k for k in tobs.process_registry().snapshot() if k.startswith("obs.")}
    assert names == {"obs.intern_overflow", "obs.spans_dropped"}
    assert names <= set(jobs.process_registry().snapshot())
    assert set(tobs.__all__) == set(jobs.__all__)
