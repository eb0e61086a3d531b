"""The broker's HTTP front, trimmed from ``ColoniesHttpServer`` of the
reference's ``repro/core/http_transport.py`` (paper §3.3).

``POST /api`` takes a signed JSON envelope and answers with the server's
reply, its error status as the HTTP status, and a W3C ``Server-Timing``
header: the recovery of the signer (``recover``) and the rest of the
request's handling (``handle``), in ms; ``GET /health`` answers
``{"status": "ok"}``. Each request runs on its own thread, so a hanging
long-poll ``assign`` never blocks the others. Executors always dial the
broker, never the reverse. A fault injected in the server's crash windows
(``runtime/faults.py``) closes the connection without a reply. Stdlib
only.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime import faults
from .server import ColoniesServer


class _Handler(BaseHTTPRequestHandler):
    server_version = "ColoniesHTTP/1.0"
    colonies: ColoniesServer = None  # type: ignore[assignment]

    def log_message(self, fmt: str, *args) -> None:  # silence default logging
        pass

    def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
        if self.path.rstrip("/") != "/api":
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            envelope = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._reply(400, {"error": "malformed request", "status": 400})
            return
        timing: dict[str, float] = {}
        t0 = time.perf_counter()
        try:
            resp = self.colonies.handle(envelope, timing)  # may hang (long-poll)
        except faults.FaultInjected:
            # Injected server crash window: die without replying, so the
            # client sees a reset connection, not a clean error body.
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return
        recover = timing.get("recover")
        metrics = [] if recover is None else [f"recover;dur={1e3 * recover:.3f}"]
        metrics.append(f"handle;dur={1e3 * (time.perf_counter() - t0 - (recover or 0.0)):.3f}")
        self._reply(int(resp.get("status", 200)) if "error" in resp else 200, resp,
                    {"Server-Timing": ", ".join(metrics)})

    def do_GET(self) -> None:  # noqa: N802
        if self.path.rstrip("/") == "/health":
            self._reply(200, {"status": "ok", "server": self.colonies.name})
        else:
            self.send_error(404)

    def _reply(self, status: int, body: dict, headers: dict[str, str] | None = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)


class ColoniesHttpServer:
    """Serve one ``ColoniesServer`` over HTTP; ``port=0`` picks a free port."""

    def __init__(self, colonies: ColoniesServer, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"colonies": colonies})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
