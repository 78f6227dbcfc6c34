"""HTTP telemetry endpoint: /metrics, /statusz, /profilez over stdlib http.

A tiny, dependency-free scrape surface beside :class:`QueryServer` (or any
process holding a registry):

- ``GET /metrics``  — Prometheus text exposition (format 0.0.4) of the
  bound registry, byte-identical to ``registry.prometheus_text()``;
- ``GET /statusz``  — JSON snapshot: serving stats, cache hit rates, SLO
  state, profile-history and flight-recorder summaries;
- ``GET /profilez`` — profile-history overview; ``?fingerprint=<hash>``
  drills into one fingerprint's streaming statistics + cost estimate.

Design stance: the endpoint is **read-only**, binds loopback by default, and
serves each request from a snapshot taken at request time — it holds no lock
while formatting. ``port=0`` binds an ephemeral port (the bound port is on
``.port``), which is also what keeps the tests sandbox/CI safe.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["TelemetryEndpoint", "PROMETHEUS_CONTENT_TYPE"]

#: the content type Prometheus expects for text format 0.0.4
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryEndpoint:
    """Threaded HTTP server publishing one registry + optional providers.

    ``status_fn`` returns the /statusz dict; ``history`` is a
    :class:`~hyperspace_tpu_torch.obs.history.ProfileHistory`; ``flight`` a
    :class:`~hyperspace_tpu_torch.obs.history.FlightRecorder`. All optional —
    absent providers make their sections/endpoints answer 404/empty rather
    than fail.
    """

    def __init__(
        self,
        registry,
        host: str = "127.0.0.1",
        port: int = 0,
        status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        history=None,
        flight=None,
    ):
        self.registry = registry
        self.status_fn = status_fn
        self.history = history
        self.flight = flight
        self._requests = registry.counter(
            "hs_http_requests_total", "telemetry endpoint requests served", path="/metrics"
        )  # ensure the family exists before first scrape; per-path below
        endpoint = self

        class _Handler(BaseHTTPRequestHandler):
            # one transient worker thread per request (ThreadingHTTPServer);
            # daemon so a live scrape never blocks interpreter exit
            daemon_threads = True

            def log_message(self, fmt, *args):  # no stderr chatter per scrape
                pass

            def do_GET(self):
                try:
                    endpoint._handle(self)
                except BrokenPipeError:
                    pass  # scraper went away mid-response
                except Exception as exc:  # defensive: never kill the server loop
                    try:
                        self.send_error(500, explain=str(exc))
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TelemetryEndpoint":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name=f"hs-telemetry-{self.port}",
                daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "TelemetryEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- request handling ----------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        self.registry.counter(
            "hs_http_requests_total", "telemetry endpoint requests served", path=path
        ).inc()
        if path == "/metrics":
            body = self.registry.prometheus_text().encode("utf-8")
            self._reply(req, 200, PROMETHEUS_CONTENT_TYPE, body)
        elif path == "/statusz":
            status = self.status_fn() if self.status_fn is not None else {}
            self._reply_json(req, 200, status)
        elif path == "/profilez":
            self._profilez(req, parse_qs(parsed.query))
        else:
            self._reply_json(
                req, 404,
                {"error": "not found", "endpoints": ["/metrics", "/statusz", "/profilez"]},
            )

    def _profilez(self, req: BaseHTTPRequestHandler, query: Dict[str, Any]) -> None:
        if self.history is None:
            self._reply_json(req, 404, {"error": "profile history disabled"})
            return
        fp = (query.get("fingerprint") or [None])[0]
        if fp is None:
            self._reply_json(req, 200, self.history.snapshot())
            return
        detail = self.history.get(fp)
        if detail is None:
            self._reply_json(req, 404, {"error": f"unknown fingerprint {fp!r}"})
            return
        est = self.history.estimate_cost(fp)
        detail["estimate"] = est.to_json() if est else None
        if self.flight is not None:
            detail["slowQueries"] = [
                e.to_json() for e in self.flight.last_slow_queries()
                if e.fingerprint == fp
            ]
        self._reply_json(req, 200, detail)

    @staticmethod
    def _reply(req: BaseHTTPRequestHandler, code: int, ctype: str, body: bytes) -> None:
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    @classmethod
    def _reply_json(cls, req: BaseHTTPRequestHandler, code: int, obj: Any) -> None:
        cls._reply(req, code, "application/json; charset=utf-8",
                   json.dumps(obj, default=str).encode("utf-8"))
