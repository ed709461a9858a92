"""Serving gateway: streaming token HTTP API over the ServingEngine — the
port's copy of `nanorlhf_tpu/serving/gateway.py` (it imports neither jax
nor the JAX package; `tests/test_torch_serving.py` runs JAX's gateway
cases against it).

Same stdlib-HTTP discipline as `telemetry/exporter.py` — a
`ThreadingHTTPServer` on a daemon thread, non-streaming responses built
fully then written once with a Content-Length, per-request stderr
silenced — plus one streaming endpoint:

- `POST /generate`  body `{"tokens": [int, ...]}` with optional
  `temperature` / `top_p` / `greedy` / `max_tokens` / `stream`.
  Non-streaming: one JSON object `{"request_id", "tokens"}` once the
  request finishes. `"stream": true`: chunked `application/x-ndjson`,
  one `{"token": t}` line as each token lands, then a final
  `{"done": true, "n": count}` line. Admission control answers 429
  with the shed reason (`queue_full` / `slo_ttft_p95`) and a
  `Retry-After` hint instead of queueing unboundedly.
- `GET /metrics`    Prometheus text: the engine's serving/* gauges
  plus the LatencyHub histogram families when the engine has one.
- `GET /healthz`    200 `ok` while the engine loop runs, 503 after
  close — the k8s-style liveness shape.
- `GET /statusz`    one JSON blob: engine occupancy, counters, SLO
  config, and the radix prefix cache's snapshot.

The gateway binds LOOPBACK ONLY (`127.0.0.1`): the fleet transport's
listener auth (ROADMAP item 2) has not landed, so exposing the port
beyond the host would ship an unauthenticated text API — docs/FLEET.md
records the same rule for the RPC listener. Port semantics follow the
exporter: 0 → disabled no-op, -1 → ephemeral (tests), >0 → that port.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nanorlhf_tpu_torch.resilience.faults import InjectedFault
from nanorlhf_tpu_torch.telemetry.exporter import (
    render_prometheus, render_prometheus_histograms,
)

_LOOPBACK = ("127.0.0.1", "localhost", "::1")

# Retry-After seconds by shed cause: queue_full clears as soon as a row
# frees (~one decode round), an SLO breach needs the p95 window to move,
# and a closed engine is not coming back on this port soon. Advisory for
# well-behaved closed-loop clients — the open-loop loadgen driver
# records the header but never obeys it.
_RETRY_AFTER = {"queue_full": 1, "slo_ttft_p95": 5, "closed": 30}


class ServingGateway:
    """HTTP front for one ServingEngine. `close()` stops the listener
    only — the engine has its own lifecycle (the caller that built it
    closes it).

    `faults` arms the `gw.disconnect` site (docs/RESILIENCE.md): a fire
    mid-stream simulates the client's socket vanishing, driving the same
    `engine.cancel()` path a real write failure takes — the row's KV
    pages are released and in-flight counters decremented either way."""

    def __init__(self, engine, port: int = -1, host: str = "127.0.0.1",
                 faults=None):
        if host not in _LOOPBACK:
            raise ValueError(
                f"gateway binds loopback only until listener auth lands "
                f"(ROADMAP item 2, docs/FLEET.md); got host {host!r}")
        self.engine = engine
        self._faults = faults
        self.enabled = bool(port)
        self.host = host
        self.port = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if not self.enabled:
            return
        gw = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # ---- reads: exporter-style full-body single writes ------ #

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        status, ctype, body = gw._metrics()
                    elif path == "/healthz":
                        status, ctype, body = gw._healthz()
                    elif path in ("/statusz", "/"):
                        status, ctype, body = gw._statusz()
                    else:
                        status, ctype, body = 404, "text/plain", b"not found\n"
                except Exception as e:  # a scrape must never kill itself
                    status, ctype = 500, "text/plain"
                    body = f"{type(e).__name__}: {e}\n".encode()
                self._write(status, ctype, body)

            def do_POST(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path != "/generate":
                    self._write(404, "text/plain", b"not found\n")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    spec = json.loads(self.rfile.read(n) or b"{}")
                    self._generate(spec)
                except (ValueError, KeyError, TypeError) as e:
                    self._write(400, "application/json",
                                json.dumps({"error": str(e)}).encode())

            def _generate(self, spec: dict):
                tokens = spec.get("tokens")
                if (not isinstance(tokens, list) or not tokens
                        or not all(isinstance(t, int) for t in tokens)):
                    raise ValueError("'tokens' must be a non-empty "
                                     "list of ints")
                req, reason = gw.engine.submit(
                    tokens,
                    temperature=float(spec.get("temperature", 1.0)),
                    top_p=float(spec.get("top_p", 1.0)),
                    greedy=bool(spec.get("greedy", False)),
                    max_tokens=spec.get("max_tokens"),
                )
                if req is None:
                    self._write(
                        429, "application/json",
                        json.dumps({"error": "shed",
                                    "reason": reason}).encode(),
                        headers={"Retry-After":
                                 str(_RETRY_AFTER.get(reason, 5))})
                    return
                if spec.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    count = 0
                    try:
                        for tok in gw.engine.stream(req):
                            if gw._disconnect_fires():
                                raise ConnectionResetError(
                                    "injected client disconnect")
                            self._chunk(json.dumps({"token": tok}) + "\n")
                            count += 1
                        self._chunk(json.dumps({"done": True, "n": count})
                                    + "\n")
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        # the client vanished mid-stream (gw.disconnect, or
                        # a real broken pipe): stop decoding and free the
                        # row — a dead socket must not pin KV pages or
                        # in-flight counters
                        gw.engine.cancel(req)
                        self.close_connection = True
                    return
                toks = list(gw.engine.stream(req))
                self._write(200, "application/json", json.dumps(
                    {"request_id": req.request_id, "tokens": toks}).encode())

            # ---- plumbing ------------------------------------------ #

            def _write(self, status, ctype, body: bytes, headers=None):
                self.send_response(status)
                self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _chunk(self, text: str):
                data = text.encode()
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

        bind_port = port if port > 0 else 0  # -1 → ephemeral
        self._server = ThreadingHTTPServer((host, bind_port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serving-gateway",
            daemon=True,
        )
        self._thread.start()

    # ----------------------------------------------------------------- #
    # endpoint bodies (HTTP threads; engine accessors are thread-safe)
    # ----------------------------------------------------------------- #

    def _disconnect_fires(self) -> bool:
        """True when the gw.disconnect site fires (any action — a raising
        schedule is the same vanished client as a returning one here)."""
        if self._faults is None:
            return False
        try:
            return self._faults.fire("gw.disconnect") is not None
        except InjectedFault:
            return True

    def _metrics(self) -> tuple:
        text = render_prometheus(self.engine.metrics())
        hub = getattr(self.engine, "_hub", None)
        if hub is not None and hub.enabled:
            text += render_prometheus_histograms(hub.states())
        return 200, "text/plain", text.encode()

    def _healthz(self) -> tuple:
        running = getattr(self.engine, "_running", False)
        return (200 if running else 503, "text/plain",
                b"ok\n" if running else b"closed\n")

    def _statusz(self) -> tuple:
        body = json.dumps(self.engine.snapshot(), default=str).encode()
        return 200, "application/json", body

    # ----------------------------------------------------------------- #

    def close(self) -> None:
        """Stop the listener and release the port. Idempotent; safe on
        the disabled no-op. Does NOT close the engine."""
        if self._closed or self._server is None:
            self._closed = True
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
