"""HTTP transport (paper §3.3): signed JSON envelopes over POST /api.

A copy of the client class ``HttpTransport`` of the reference's
``repro/core/http_transport.py``, with its client-side fault sites
(``transport.send``, ``transport.recv``, and the ``"duplicate"`` action
that delivers a request twice), plus ``health()`` for the broker's
``GET /health``; the broker's ``Server-Timing`` header becomes the spans
``broker.recover`` and ``broker.handle`` of the RPC (``trace.py``). The
broker hangs ``assign`` requests (long-poll) until a process matches or
the timer expires; executors always dial the broker, never the reverse,
so they can live behind firewalls/NATs exactly as the paper argues. The
server is the broker's and is not copied.

Stdlib only: urllib.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request

from .. import trace
from ..runtime import faults
from .retry import RetryPolicy, send_with_retry


def server_timing(header: str | None) -> dict[str, float]:
    """Seconds by metric name of a W3C ``Server-Timing`` header
    (``recover;dur=47.5, handle;dur=3.1``, durations in ms)."""
    out: dict[str, float] = {}
    for metric in (header or "").split(","):
        name, *params = (p.strip() for p in metric.split(";"))
        for param in params:
            key, _, value = param.partition("=")
            if name and key.strip() == "dur":
                try:
                    out[name] = float(value) / 1e3
                except ValueError:
                    pass
    return out


def _record_broker(headers, sent: float) -> None:
    """The broker's recovery of the signer and its handler, from a reply's
    ``Server-Timing``, as spans of the current RPC placed from the send."""
    timing = server_timing(headers.get("Server-Timing") if headers is not None else None)
    start = sent
    for name in ("recover", "handle"):
        if name in timing:
            trace.record(f"broker.{name}", timing[name], start)
            start += timing[name]


class HttpTransport:
    """Client side; compatible with client.Colonies.

    One pass rotates over all endpoints — 421 means "follower, try the
    next host" (leader failover), connection errors rotate the same way.
    ``retry=RetryPolicy(...)`` re-runs the pass with capped jittered
    backoff when every endpoint failed retryably (mid-election cluster,
    restarting server) — see retry.py; safe for mutating RPCs because
    the envelope's msgid makes the retry exactly-once server-side."""

    def __init__(
        self,
        host: str,
        port: int,
        fallbacks: list[tuple[str, int]] | None = None,
        retry: RetryPolicy | None = None,
    ):
        self.endpoints = [(host, port)] + list(fallbacks or [])
        self.retry = retry
        self._preferred = 0

    def health(self, timeout: float = 5.0) -> dict:
        """``GET /health`` of the first endpoint (``{"status": "ok", ...}``)."""
        host, port = self.endpoints[0]
        with urllib.request.urlopen(f"http://{host}:{port}/health", timeout=timeout) as resp:
            return json.loads(resp.read())

    def send(self, envelope: dict, timeout: float = 90.0) -> dict:
        return send_with_retry(lambda: self._send_once(envelope, timeout), self.retry)

    def _send_once(self, envelope: dict, timeout: float) -> dict:
        data = json.dumps(envelope).encode()
        ptype = envelope.get("payloadtype", "")
        last: dict = {"error": "no endpoints", "status": 500}
        order = list(range(len(self.endpoints)))
        order = order[self._preferred :] + order[: self._preferred]
        for idx in order:
            host, port = self.endpoints[idx]
            req = urllib.request.Request(
                f"http://{host}:{port}/api",
                data=data,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                action = faults.hit("transport.send", payloadtype=ptype)
                sent = time.time()
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    body = json.loads(resp.read())
                    headers = resp.headers
                if action == "duplicate":  # at-least-once delivery: send twice
                    sent = time.time()
                    with urllib.request.urlopen(req, timeout=timeout) as resp:
                        body = json.loads(resp.read())
                        headers = resp.headers
                faults.hit("transport.recv", payloadtype=ptype)
                _record_broker(headers, sent)
            except urllib.error.HTTPError as e:
                _record_broker(e.headers, sent)
                try:
                    body = json.loads(e.read())
                except (ValueError, json.JSONDecodeError):
                    body = {"error": str(e), "status": e.code}
            except (
                urllib.error.URLError,
                TimeoutError,
                ConnectionError,
                http.client.HTTPException,
            ) as e:
                # Includes injected transport faults and a broker that dies
                # mid-request: it closes the socket without a reply, which
                # surfaces here as RemoteDisconnected/ConnectionError.
                last = {"error": f"transport: {e}", "status": 503}
                continue
            if body.get("status") == 421:  # follower — try next replica
                last = body
                continue
            self._preferred = idx
            return body
        return last
