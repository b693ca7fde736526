"""Live exposition: a tiny stdlib HTTP server for Prometheus scrapes and
trace debugging — no dependencies, daemon-threaded, safe to run inside a
serving process.

Routes:

* ``/metrics``  — Prometheus text format (0.0.4) of ``registry.snapshot()``
* ``/trace?last=N`` — chrome-trace JSON of the tracer's last N spans
  (default 512): save the response body, load it in Perfetto
* ``/snapshot`` — the raw JSON snapshot (the same dict the benches attach)
* ``/healthz``  — liveness

``port=0`` binds an ephemeral port (tests); ``server.port``/``server.url``
report the bound address after ``start()``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .export import render_prometheus, spans_to_chrome
from .registry import get_registry
from .trace import get_tracer

__all__ = ["MetricsServer"]


class MetricsServer:
    """Serve ``/metrics`` + ``/trace`` for one registry/tracer pair."""

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry=None, tracer=None):
        self._registry = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self._want = (host, int(port))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry, tracer = self._registry, self._tracer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # keep serving stdout clean
                return None

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/metrics":
                    body = render_prometheus(registry.snapshot())
                    self._send(body.encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif u.path == "/trace":
                    q = parse_qs(u.query)
                    last = int(q.get("last", ["512"])[0])
                    doc = spans_to_chrome(tracer.spans(last=last))
                    self._send(json.dumps(doc).encode(), "application/json")
                elif u.path == "/snapshot":
                    self._send(json.dumps(registry.snapshot()).encode(),
                               "application/json")
                elif u.path == "/healthz":
                    self._send(b"ok\n", "text/plain")
                else:
                    self._send(b"not found\n", "text/plain", 404)

        self._httpd = ThreadingHTTPServer(self._want, Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="telemetry-metrics",
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        if self._httpd is None:
            return None
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
