"""Live status exporter: /metrics · /healthz · /statusz over stdlib HTTP.

The write side of observability (tracer, blackbox, metrics.jsonl) is
post-mortem; this is the read side — a `ThreadingHTTPServer` on a daemon
thread that lets a human `curl` a running trainer or a monitor scrape it:

- `/metrics`  Prometheus text exposition of the latest scalar metrics row
              (MetricsLogger.latest()) merged with the live health gauges,
              plus the latency histogram families (`_bucket`/`_sum`/
              `_count`) when a LatencyHub is attached
- `/healthz`  200/503 straight from the HealthMonitor verdict — the shape
              k8s-style liveness probes expect
- `/statusz`  one JSON blob of run state: step, policy version, staleness,
              queue depth, fleet membership + lease table, MFU (flagged
              when the peak-FLOPs table doesn't know the chip), and the
              last N health events

Off by default (`cfg.status_port=0` constructs a no-op). `status_port=-1`
binds an ephemeral port (tests, CI); the bound port is in `self.port`.
Responses are built fully, then written once with a Content-Length — a
scrape racing a trainer update sees a complete payload or none, never a
torn one. stdlib-only and jax-free, like the rest of the telemetry plane.

The port's copy of `nanorlhf_tpu/telemetry/exporter.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# exposition line: name{labels} value [timestamp]
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)( [0-9]+)?$"
)
_VALUE_RE = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                       r"|Inf|NaN)$", re.IGNORECASE)


def render_prometheus(metrics: dict, prefix: str = "nanorlhf_") -> str:
    """Render a flat {name: scalar} dict as Prometheus text exposition
    (version 0.0.4). Metric names like `perf/mfu` sanitize to
    `nanorlhf_perf_mfu`; non-numeric values are skipped; NaN/±Inf are
    legal exposition values and pass through. A key carrying a label set
    (`lineage/dropped_total{reason="stale_drop"}`) keeps its labels
    verbatim — only the name part is sanitized — and shares one # TYPE
    line with its sibling series."""
    lines: list[str] = []
    seen: set = set()
    typed: set = set()
    for key in sorted(metrics):
        try:
            v = float(metrics[key])
        except (TypeError, ValueError):
            continue
        raw, labels = str(key), ""
        if raw.endswith("}") and "{" in raw:
            raw, _, tail = raw.partition("{")
            labels = "{" + tail
        name = prefix + _NAME_RE.sub("_", raw)
        if (name, labels) in seen:  # two raw keys can sanitize the same
            continue
        seen.add((name, labels))
        if v != v:
            val = "NaN"
        elif v == float("inf"):
            val = "+Inf"
        elif v == float("-inf"):
            val = "-Inf"
        else:
            val = repr(v)
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {val}")
    return "\n".join(lines) + "\n"


def render_prometheus_histograms(states: dict, prefix: str = "nanorlhf_") -> str:
    """Render {metric key: StreamingHistogram.state()} as Prometheus
    histogram exposition (version 0.0.4): per family one `# TYPE name
    histogram` line, cumulative `name_bucket{le="..."}` series at the
    sketch's coarse export edges (exact — the edges align with internal
    bucket boundaries), the mandatory `le="+Inf"` bucket equal to
    `name_count`, then `name_sum` and `name_count`. Keys sanitize exactly
    like `render_prometheus` (`latency/ttft_s` → `nanorlhf_latency_ttft_s`)
    so the gauge and histogram surfaces share one naming rule."""
    from nanorlhf_tpu_torch.telemetry.hist import StreamingHistogram

    lines: list[str] = []
    for key in sorted(states):
        try:
            h = StreamingHistogram.load(states[key])
        except Exception:
            continue  # a torn/foreign state must not kill the scrape
        name = prefix + _NAME_RE.sub("_", str(key))
        lines.append(f"# TYPE {name} histogram")
        for edge, cum in h.cumulative_buckets():
            lines.append(f'{name}_bucket{{le="{edge:.6g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{name}_sum {repr(h.sum)}")
        lines.append(f"{name}_count {h.count}")
    return "\n".join(lines) + "\n" if lines else ""


def validate_prometheus_text(text: str) -> list[str]:
    """Validate Prometheus text exposition; return a list of problems
    (empty == valid). Shared by the test suite and the CI health-smoke
    step so 'parseable' means the same thing in both."""
    problems: list[str] = []
    samples = 0
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not (line.startswith("# TYPE ") or line.startswith("# HELP ")
                    or line.startswith("# EOF")):
                problems.append(f"line {i}: bad comment {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        if not _VALUE_RE.match(m.group(3)):
            problems.append(f"line {i}: bad value {m.group(3)!r}")
            continue
        samples += 1
    if samples == 0:
        problems.append("no samples")
    return problems


class StatusExporter:
    """Serve /metrics, /healthz, /statusz for a running trainer.

    port semantics: 0 → disabled no-op (enabled=False, close() is safe);
    -1 → bind an ephemeral port (self.port holds the real one); >0 → bind
    that port. `metrics_fn` returns the latest flat scalar row,
    `statusz_fn` a JSON-able dict, `health` a HealthMonitor (or None)."""

    def __init__(self, port: int, *,
                 metrics_fn: Optional[Callable[[], dict]] = None,
                 statusz_fn: Optional[Callable[[], dict]] = None,
                 health=None, latency=None, host: str = "127.0.0.1"):
        self.enabled = bool(port)
        self.host = host
        self.port = 0
        self._metrics_fn = metrics_fn
        self._statusz_fn = statusz_fn
        self._health = health
        self._latency = latency  # LatencyHub: /metrics histogram families
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if not self.enabled:
            return
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        status, ctype, body = exporter._metrics()
                    elif path == "/healthz":
                        status, ctype, body = exporter._healthz()
                    elif path in ("/statusz", "/"):
                        status, ctype, body = exporter._statusz()
                    else:
                        status, ctype, body = 404, "text/plain", b"not found\n"
                except Exception as e:  # a scrape must never kill itself
                    status, ctype = 500, "text/plain"
                    body = f"{type(e).__name__}: {e}\n".encode()
                self.send_response(status)
                self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                # one write of the full body: no torn payloads under
                # concurrent scrape
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

        bind_port = port if port > 0 else 0  # -1 → ephemeral
        self._server = ThreadingHTTPServer((host, bind_port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="status-exporter",
            daemon=True,
        )
        self._thread.start()
        print(f"[status] serving /metrics /healthz /statusz on "
              f"http://{self.host}:{self.port}")

    # ----------------------------------------------------------------- #
    # endpoint bodies (run on HTTP threads; providers are thread-safe)
    # ----------------------------------------------------------------- #

    def _metrics(self) -> tuple:
        merged: dict = {}
        if self._metrics_fn is not None:
            merged.update(self._metrics_fn() or {})
        if self._health is not None:
            merged.update(self._health.gauges())
        text = render_prometheus(merged)
        if self._latency is not None and self._latency.enabled:
            text += render_prometheus_histograms(self._latency.states())
        return 200, "text/plain", text.encode()

    def _healthz(self) -> tuple:
        verdict = self._health.verdict if self._health is not None else "ok"
        status = 503 if verdict == "crit" else 200
        return status, "text/plain", f"{verdict}\n".encode()

    def _statusz(self) -> tuple:
        payload = self._statusz_fn() if self._statusz_fn is not None else {}
        body = json.dumps(payload, default=str).encode()
        return 200, "application/json", body

    # ----------------------------------------------------------------- #

    def close(self) -> None:
        """Stop serving and release the port. Idempotent; safe on the
        disabled no-op."""
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
