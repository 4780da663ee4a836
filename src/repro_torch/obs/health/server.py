"""Live introspection HTTP endpoint for a serving engine.

``engine.serve_obs(port=0)`` boots a stdlib
:class:`~http.server.ThreadingHTTPServer` on a daemon thread and serves:

=============  ============================================================
``/metrics``   Prometheus text exposition of the engine's registry merged
               with the process registry (intern overflows, flight
               activity); histograms as cumulative
               ``_bucket{le=...}`` rows.
``/spans``     The most recent decoded span records across all thread
               rings as JSON (``?n=`` caps the count, default 256) plus
               exact dropped / intern-overflow counts.
``/explain``   The engine's recent ``auto`` plans (``engine.explain()``).
``/snapshot``  The served MVCC version: version number, facility
               fingerprint, dataset cardinalities, rect, shard partition
               summary, and per-category device-memory bytes.
``/healthz``   SLO evaluation via the engine's sentinel — 200 + ``ok``
               while healthy, 503 with the tripped rule states otherwise.
=============  ============================================================

Read-only and **lock-free by construction**: every handler reads the
same seqlock span rings, GIL-published metric objects, and atomically
swapped snapshot reference the serving path uses — no handler acquires
a lock a query path could ever wait on, so scraping cannot perturb
tail latency beyond its own CPU cost.  Each request resolves
``engine._snap`` exactly once, like a query does, so a concurrent
update stream yields monotone versions and never a torn mix.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..export import spans as _decode_spans
from ..flight import _jsonable
from ..metrics import process_registry
from ..promtext import render_registries
from ..trace import get_tracer

__all__ = ["ObsServer", "serve"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "rknn-obs/1"
    protocol_version = "HTTP/1.1"

    # set per server class in ObsServer
    engine = None

    def log_message(self, fmt, *args):  # quiet: scrapers are chatty
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload, code: int = 200) -> None:
        body = json.dumps(_jsonable(payload), indent=1).encode()
        self._send(code, body, "application/json")

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        url = urlparse(self.path)
        route = url.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                text = render_registries(self.engine.metrics, process_registry())
                self._send(200, text.encode(), "text/plain; version=0.0.4")
            elif route == "/spans":
                qs = parse_qs(url.query)
                n = int(qs.get("n", ["256"])[0])
                tracer = get_tracer()
                recs = _decode_spans(tracer)[-max(n, 0):]
                self._send_json(
                    dict(
                        spans=recs,
                        dropped=tracer.dropped,
                        intern_overflows=tracer.intern_overflows,
                        tracing_enabled=tracer.enabled,
                    )
                )
            elif route == "/explain":
                self._send_json(dict(plans=self.engine.explain()))
            elif route == "/snapshot":
                self._send_json(self._snapshot_payload())
            elif route == "/healthz":
                sentinel = self.engine.sentinel
                ok = sentinel.observe()
                self._send_json(
                    dict(ok=ok, rules=sentinel.state()),
                    code=200 if ok else 503,
                )
            elif route == "/":
                self._send_json(
                    dict(routes=["/metrics", "/spans", "/explain",
                                 "/snapshot", "/healthz"])
                )
            else:
                self._send_json(dict(error=f"no route {route}"), code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # a broken scrape must not kill the server
            try:
                self._send_json(
                    dict(error=f"{type(e).__name__}: {e}"), code=500
                )
            except Exception:
                pass

    def _snapshot_payload(self) -> dict:
        engine = self.engine
        snap = engine._snap  # resolved ONCE, like a query entry point
        rect = snap.rect
        shard_state = snap.shard_state
        return dict(
            version=snap.version,
            fingerprint=snap.fingerprint(),
            n_facilities=len(snap.facilities),
            n_users=len(snap.users),
            rect=dict(
                xmin=rect.xmin, ymin=rect.ymin, xmax=rect.xmax, ymax=rect.ymax
            ),
            mesh_n=snap.mesh_n,
            shards=(shard_state.summary() if shard_state is not None else None),
            device_bytes=engine._device_bytes_cached(snap),
            scene_cache_len=(
                len(snap.scene_cache) if snap.scene_cache is not None else 0
            ),
            persist=getattr(engine, "persist_info", None),
        )


class ObsServer:
    """One engine's introspection endpoint (daemon threads; ephemeral
    port by default so tests and co-located engines never collide)."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,), {"engine": engine})
        self.engine = engine
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"rknn-obs-{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self) -> "ObsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(engine, port: int = 0, host: str = "127.0.0.1") -> ObsServer:
    return ObsServer(engine, port=port, host=host)
