"""The port's live endpoints (``repro_torch.obs.health``) on the CPU.

Every engine here runs on ``device="cpu"``.  Checked exactly (no
tolerance): every route answers while a ``DynamicEngine`` writer
publishes versions; ``/snapshot`` versions are monotone, one facility
fingerprint throughout a user-only stream, and the final version is the
writer's last once the writer has been joined — the assertions read
versions and fingerprints, never wall time.  ``/snapshot``'s keys and
values equal the JAX server's for the same data; ``/metrics`` is the
Prometheus text of the engine's and the process's registries;
``/healthz`` follows the sentinel; ``/explain`` serves ``explain()``.
"""

import http.client
import json
import threading

import numpy as np
import pytest

from repro.core.engine import RkNNConfig as JConfig
from repro.core.engine import RkNNEngine as JEngine
from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.dynamic import DynamicEngine
from repro_torch.obs import Rule, process_registry, render_registries
from repro_torch.shard import ShardedEngine

from tests._torch_parity import CPU

ROUTES = ("/metrics", "/snapshot", "/spans?n=8", "/explain", "/healthz", "/")


def _small(seed=0, M=40, N=200):
    rng = np.random.default_rng(seed)
    return rng.random((M, 2)), rng.random((N, 2))


def _get(conn: http.client.HTTPConnection, route: str):
    conn.request("GET", route)
    r = conn.getresponse()
    return r.status, r.read()


@pytest.mark.parametrize("backend", ["dense", "grid-pallas"])
def test_every_route_serves_while_a_writer_publishes(backend):
    F, U = _small()
    dyn = DynamicEngine(F, U, RkNNConfig(backend=backend), device=CPU)
    dyn.query_batch([0, 3], 4)
    srv = dyn.serve_obs(port=0)
    n_updates = 10
    errors: list = []

    def writer():
        rng = np.random.default_rng(1)
        try:
            for _ in range(n_updates):
                ids = rng.choice(len(U), 20, replace=False)
                dyn.apply_updates(user_move=(ids, rng.random((20, 2))))
                dyn.query_batch([0, 3], 4)
        except Exception as e:  # surfaced after the join
            errors.append(e)

    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        th = threading.Thread(target=writer)
        th.start()
        versions, fps, users, codes = [], set(), set(), {}
        while th.is_alive() or not versions:
            for route in ROUTES:
                code, body = _get(conn, route)
                codes.setdefault(route, set()).add(code)
                if route == "/snapshot":
                    snap = json.loads(body)
                    versions.append(snap["version"])
                    fps.add(snap["fingerprint"])
                    users.add(snap["n_users"])
        th.join()
        assert not errors
        assert codes == {r: {200} for r in ROUTES}
        assert versions == sorted(versions)  # monotone under the stream
        assert len(fps) == 1  # facilities untouched: one fingerprint only
        assert users == {len(U)}  # moves never change cardinality
        final = json.loads(_get(conn, "/snapshot")[1])
        assert final["version"] == dyn.version == n_updates
        assert final["device_bytes"]["total"] > 0
        code, body = _get(conn, "/spans?n=8")
        assert {"spans", "dropped", "intern_overflows", "tracing_enabled"} <= json.loads(body).keys()
        assert _get(conn, "/nope")[0] == 404
    finally:
        conn.close()
        srv.close()


def test_snapshot_payload_equals_the_jax_servers():
    F, U = _small(seed=2)
    ours = RkNNEngine(F, U, RkNNConfig(backend="grid"), device=CPU)
    theirs = JEngine(F, U, JConfig(backend="grid"))
    payloads = []
    for eng in (ours, theirs):
        eng.query_batch([1, 2, 5], 4)
        srv = eng.serve_obs(port=0)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            code, body = _get(conn, "/snapshot")
            assert code == 200
            payloads.append(json.loads(body))
            assert json.loads(_get(conn, "/")[1]) == {
                "routes": ["/metrics", "/spans", "/explain", "/snapshot", "/healthz"]}
        finally:
            conn.close()
            srv.close()
    got, want = payloads
    assert got.keys() == want.keys()
    assert got["device_bytes"].keys() == want["device_bytes"].keys()
    for key in ("version", "fingerprint", "n_facilities", "n_users", "rect", "mesh_n",
                "shards", "scene_cache_len", "persist"):
        assert got[key] == want[key], key
    assert got["device_bytes"] == ours._snap.device_bytes()
    assert got["device_bytes"]["indexes"] > 0  # the three grids


def test_metrics_route_is_the_engine_and_process_registries():
    F, U = _small(seed=3)
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    eng.query_batch([0, 1], 4)
    with eng.serve_obs(port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        code, body = _get(conn, "/metrics")
        conn.close()
    text = body.decode()
    assert code == 200
    want = render_registries(eng.metrics, process_registry())
    types = lambda t: sorted(ln for ln in t.splitlines() if ln.startswith("# TYPE"))  # noqa: E731
    assert types(text) == types(want)
    for family in ("queries", "mem_bytes", "pad_waste", "obs_intern_overflow", "phase_s"):
        assert f"# TYPE {family} " in text
    assert 'mem_bytes{category="total"}' in text


def test_healthz_follows_the_sentinel():
    F, U = _small(seed=4)
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    value = [0.0]
    eng.sentinel.add_rule(Rule("probe", lambda: value[0], limit=1.0, trip_after=2))
    with eng.serve_obs(port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        code, body = _get(conn, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        value[0] = 5.0
        codes = [_get(conn, "/healthz")[0] for _ in range(2)]
        assert codes == [200, 503]  # trips on the second breach
        payload = json.loads(_get(conn, "/healthz")[1])
        assert payload["ok"] is False and payload["rules"]["probe"]["tripped"] is True
        value[0] = 0.0
        codes = [_get(conn, "/healthz")[0] for _ in range(2)]
        assert codes == [503, 200]  # clears after two healthy samples
        conn.close()


def test_sharded_snapshot_serves_the_partition():
    F, U = _small(seed=5, N=300)
    eng = ShardedEngine(F, U, RkNNConfig(backend="grid"), shards=3, device=CPU)
    eng.query_batch([0, 2], 4)
    with eng.serve_obs(port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        snap = json.loads(_get(conn, "/snapshot")[1])
        conn.close()
    assert snap["shards"] == eng._snap.shard_state.summary()
    assert snap["shards"]["n_shards"] == 3 and snap["shards"]["n_users"] == len(U)
    assert snap["device_bytes"]["shards"] > 0


def test_explain_route_serves_the_planners_plans():
    F, U = _small(seed=6)
    eng = RkNNEngine(F, U, RkNNConfig(backend="auto"), device=CPU)
    eng.query_batch([0, 1, 2], 4)
    eng.query(3, 4)
    with eng.serve_obs(port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        plans = json.loads(_get(conn, "/explain")[1])["plans"]
        conn.close()
    assert len(plans) == len(eng.explain()) == 2
    assert [p["mode"] for p in plans] == [p["mode"] for p in eng.explain()]


def test_spans_route_caps_and_a_bad_request_is_a_500():
    from repro_torch.obs import Tracer, set_tracer

    F, U = _small(seed=7)
    eng = RkNNEngine(F, U, RkNNConfig(backend="dense"), device=CPU)
    tr = Tracer(capacity=1 << 10)
    prev = set_tracer(tr)
    tr.enable()
    try:
        for _ in range(3):
            eng.query_batch([0, 1], 4)
        with eng.serve_obs(port=0) as srv:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            spans = json.loads(_get(conn, "/spans?n=2")[1])
            code, body = _get(conn, "/spans?n=abc")
            conn.close()
    finally:
        set_tracer(prev)
    assert len(spans["spans"]) == 2 and spans["tracing_enabled"] is True
    assert code == 500 and "ValueError" in json.loads(body)["error"]
    assert eng._obs_servers == [srv]
