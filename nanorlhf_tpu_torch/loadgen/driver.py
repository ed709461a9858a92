"""Open-loop traffic driver (docs/TRAFFIC.md §3).

(the port's copy of `nanorlhf_tpu/loadgen/driver.py`, in-process against
the port's `ServingEngine` or over HTTP against its `ServingGateway`.)

Fires a materialized workload (workload.py) at a serving target on the
spec's arrival schedule, OPEN LOOP: the scheduler sleeps to each
request's `t_offset` and fires regardless of how many earlier requests
are still in flight — completion never gates arrival, so offered load is
exactly what the spec says and saturation shows up as shedding and TTFT
degradation instead of being silently absorbed by a closing loop (the
measurement honesty arxiv 2605.25645's goodput curves depend on).

Two targets, same records:

- in-process (`engine=`): `ServingEngine.submit()`/`stream()` directly —
  the CPU-CI mode the `traffic-smoke` tier-1 step and bench
  `detail.traffic` use (no sockets, deterministic shed reasons).
- HTTP (`base_url=`): `POST /generate` with `"stream": true` against a
  ServingGateway; a 429 is recorded as a shed with the gateway's JSON
  reason and its `Retry-After` header — which the driver deliberately
  IGNORES (an open-loop client never retries or backs off; the header
  exists for well-behaved closed-loop clients and dashboards).

Per-request outcomes land in three places: the shared LatencyHub
(`latency/client_ttft_s` / `latency/client_total_s` — CLIENT-side, so
queue wait inside the engine is included, unlike the engine's own
`latency/ttft_s` which starts at submit), the driver's `loadgen/*`
counters (METRICS.md), and one `traffic` lineage event per request plus
a `traffic_run` header event — enough for `tools/inspect_run.py
--traffic` to rebuild the offered/goodput/shed timeline jax-free from
the ledger alone.

Lock order: `loadgen.driver` is ranked BELOW every lock the firing path
takes (serving.engine, telemetry.hist, telemetry.lineage) in LOCK_ORDER;
the driver still never calls out while holding its lock — the lock only
guards the counters and the per-run record list.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
from nanorlhf_tpu_torch.resilience.faults import InjectedFault
from nanorlhf_tpu_torch.loadgen.workload import (
    KEY_PATH, WorkloadSpec, sample_requests, spec_digest,
)

_COUNTER_KEYS = ("offered", "completed", "shed", "errors")


@dataclasses.dataclass
class RequestRecord:
    """One fired request's observed outcome (client side)."""

    index: int
    t_offset: float
    outcome: str                  # "completed" | "shed" | "error"
    reason: Optional[str] = None  # shed reason / error class
    ttft_s: Optional[float] = None
    total_s: Optional[float] = None
    tokens: int = 0               # generated tokens observed
    retry_after_s: Optional[float] = None  # HTTP 429 header (recorded,
                                           # never obeyed — open loop)


@dataclasses.dataclass
class TrafficSummary:
    """One run's aggregate — the row a sweep point (report.py) keeps."""

    offered: int
    completed: int
    shed: int
    errors: int
    duration_s: float
    offered_rps: float
    goodput_rps: float
    shed_frac: float
    shed_reasons: dict
    p50_ttft_s: Optional[float]
    p95_ttft_s: Optional[float]
    records: list


class TrafficDriver:
    """Open-loop load generator over one target. Reusable across runs;
    counters are cumulative, rates are per-run. `time_scale` compresses
    the spec's arrival timeline (0.1 = 10× faster) without changing the
    sequence — CI runs the same replayable workload, just denser."""

    def __init__(self, *, engine=None, base_url: Optional[str] = None,
                 latency=None, lineage=None, tracer=None, faults=None,
                 stream_timeout_s: float = 120.0, time_scale: float = 1.0):
        if (engine is None) == (base_url is None):
            raise ValueError(
                "exactly one of engine= (in-process) or base_url= (HTTP) "
                "selects the target")
        self._engine = engine
        # gw.disconnect for the in-process target: the driver IS the
        # client, so a fire makes THIS client vanish mid-stream and call
        # engine.cancel — the same page-release path the gateway drives
        # for HTTP clients (where the site is armed on the gateway side)
        self._faults = faults
        self._base_url = base_url.rstrip("/") if base_url else None
        self._hub = latency if (latency is not None
                                and latency.enabled) else None
        self._lineage = lineage
        self._tracer = tracer
        self.stream_timeout_s = float(stream_timeout_s)
        self.time_scale = float(time_scale)
        self._lock = make_lock("loadgen.driver")
        self._counters = {k: 0 for k in _COUNTER_KEYS}
        self._shed_reasons: dict = {}
        self._records: list = []
        self._last_duration_s = 0.0
        self._last_offered = 0
        self._last_completed = 0

    # ------------------------------------------------------------- #
    # run
    # ------------------------------------------------------------- #

    def run(self, spec) -> TrafficSummary:
        """Fire one workload to completion (all request threads joined or
        timed out). `spec` is a WorkloadSpec or a pre-materialized
        request sequence."""
        if isinstance(spec, WorkloadSpec):
            reqs = sample_requests(spec)
            digest = spec_digest(spec)
            meta = {"n_requests": spec.n_requests,
                    "rate_rps": spec.rate_rps, "arrival": spec.arrival,
                    "seed": spec.seed}
        else:
            reqs = tuple(spec)
            digest = None
            meta = {"n_requests": len(reqs)}
        with self._lock:
            self._records = []
        if self._lineage is not None and self._lineage.enabled:
            self._lineage.event(
                "traffic_run", spec_digest=digest, key_path=KEY_PATH,
                time_scale=self.time_scale,
                mode="inprocess" if self._engine is not None else "http",
                **meta)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("traffic.run_start", n=len(reqs))

        t0 = time.perf_counter()
        threads = []
        for rq in reqs:
            # open loop: sleep to the arrival offset, fire, move on —
            # in-flight count never gates the schedule
            delay = t0 + rq.t_offset * self.time_scale - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(
                target=self._fire, args=(rq,), daemon=True,
                name=f"loadgen-{rq.index}")
            th.start()
            threads.append(th)
        deadline = time.perf_counter() + self.stream_timeout_s
        for th in threads:
            th.join(timeout=max(0.1, deadline - time.perf_counter()))
        duration = time.perf_counter() - t0

        with self._lock:
            records = sorted(self._records, key=lambda r: r.index)
            self._last_duration_s = duration
            self._last_offered = len(reqs)
            self._last_completed = sum(
                1 for r in records if r.outcome == "completed")
        summary = self._summarize(records, duration)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "traffic.run_end", completed=summary.completed,
                shed=summary.shed)
        return summary

    def _summarize(self, records, duration: float) -> TrafficSummary:
        completed = [r for r in records if r.outcome == "completed"]
        shed = [r for r in records if r.outcome == "shed"]
        errors = [r for r in records if r.outcome == "error"]
        reasons: dict = {}
        for r in shed:
            reasons[r.reason or "unknown"] = (
                reasons.get(r.reason or "unknown", 0) + 1)
        ttfts = sorted(r.ttft_s for r in completed if r.ttft_s is not None)

        def pct(q: float):
            if not ttfts:
                return None
            pos = q * (len(ttfts) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(ttfts) - 1)
            return ttfts[lo] + (ttfts[hi] - ttfts[lo]) * (pos - lo)

        n = len(records)
        return TrafficSummary(
            offered=n, completed=len(completed), shed=len(shed),
            errors=len(errors), duration_s=duration,
            offered_rps=n / duration if duration > 0 else 0.0,
            goodput_rps=len(completed) / duration if duration > 0 else 0.0,
            shed_frac=len(shed) / n if n else 0.0,
            shed_reasons=reasons, p50_ttft_s=pct(0.50),
            p95_ttft_s=pct(0.95), records=records,
        )

    # ------------------------------------------------------------- #
    # firing paths (one thread per request)
    # ------------------------------------------------------------- #

    def _fire(self, rq) -> None:
        t_send = time.perf_counter()
        try:
            if self._engine is not None:
                rec = self._fire_inprocess(rq, t_send)
            else:
                rec = self._fire_http(rq, t_send)
        except Exception as e:  # a client bug must not kill the run
            rec = RequestRecord(index=rq.index, t_offset=rq.t_offset,
                                outcome="error",
                                reason=type(e).__name__)
        if self._hub is not None:
            if rec.ttft_s is not None:
                self._hub.record("latency/client_ttft_s", rec.ttft_s)
            if rec.total_s is not None:
                self._hub.record("latency/client_total_s", rec.total_s)
        if self._lineage is not None and self._lineage.enabled:
            self._lineage.event(
                "traffic", request_index=rq.index,
                t_offset=round(rq.t_offset, 6), outcome=rec.outcome,
                reason=rec.reason,
                ttft_s=(round(rec.ttft_s, 6)
                        if rec.ttft_s is not None else None),
                total_s=(round(rec.total_s, 6)
                         if rec.total_s is not None else None),
                tokens=rec.tokens,
                prefix_group=(rq.prefix_group
                              if rq.prefix_group >= 0 else None))
        with self._lock:
            self._records.append(rec)
            self._counters["offered"] += 1
            self._counters[rec.outcome if rec.outcome in _COUNTER_KEYS
                           else "errors"] += 1
            if rec.outcome == "shed":
                key = rec.reason or "unknown"
                self._shed_reasons[key] = self._shed_reasons.get(key, 0) + 1

    def _fire_inprocess(self, rq, t_send: float) -> RequestRecord:
        req, reason = self._engine.submit(
            list(rq.tokens), temperature=rq.temperature, top_p=rq.top_p,
            greedy=rq.greedy, max_tokens=rq.max_tokens)
        if req is None:
            return RequestRecord(index=rq.index, t_offset=rq.t_offset,
                                 outcome="shed", reason=reason)
        ttft = None
        n = 0
        for _tok in self._engine.stream(req, timeout=self.stream_timeout_s):
            if n == 0:
                ttft = time.perf_counter() - t_send
            n += 1
            if self._disconnect_fires():
                # this client vanishes mid-stream: tell the engine so the
                # row stops decoding and its KV pages are released
                self._engine.cancel(req)
                return RequestRecord(
                    index=rq.index, t_offset=rq.t_offset, outcome="error",
                    reason="disconnect", ttft_s=ttft,
                    total_s=time.perf_counter() - t_send, tokens=n)
        if n == 0:
            # an admitted request whose stream ended with zero tokens:
            # the engine aborted it (pool shed) or the stream timed out
            return RequestRecord(index=rq.index, t_offset=rq.t_offset,
                                 outcome="shed", reason="engine_abort")
        return RequestRecord(
            index=rq.index, t_offset=rq.t_offset, outcome="completed",
            ttft_s=ttft, total_s=time.perf_counter() - t_send, tokens=n)

    def _fire_http(self, rq, t_send: float) -> RequestRecord:
        body = json.dumps({
            "tokens": list(rq.tokens), "temperature": rq.temperature,
            "top_p": rq.top_p, "greedy": rq.greedy,
            "max_tokens": rq.max_tokens, "stream": True,
        }).encode()
        http_req = urllib.request.Request(
            self._base_url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            resp = urllib.request.urlopen(
                http_req, timeout=self.stream_timeout_s)
        except urllib.error.HTTPError as e:
            if e.code == 429:
                try:
                    reason = json.loads(e.read()).get("reason", "unknown")
                except (ValueError, OSError):
                    reason = "unknown"
                ra = e.headers.get("Retry-After")
                return RequestRecord(
                    index=rq.index, t_offset=rq.t_offset, outcome="shed",
                    reason=reason,
                    retry_after_s=float(ra) if ra else None)
            return RequestRecord(index=rq.index, t_offset=rq.t_offset,
                                 outcome="error", reason=f"http_{e.code}")
        ttft = None
        n = 0
        saw_done = False
        with resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "token" in obj:
                    if n == 0:
                        ttft = time.perf_counter() - t_send
                    n += 1
                if obj.get("done"):
                    saw_done = True
                    break
        if n == 0:
            return RequestRecord(index=rq.index, t_offset=rq.t_offset,
                                 outcome="shed", reason="engine_abort")
        if not saw_done:
            # the stream ended without the final done line — the gateway
            # aborted it (its gw.disconnect site, or a server-side write
            # failure); an unfinished stream must not count as goodput
            return RequestRecord(
                index=rq.index, t_offset=rq.t_offset, outcome="error",
                reason="disconnect", ttft_s=ttft,
                total_s=time.perf_counter() - t_send, tokens=n)
        return RequestRecord(
            index=rq.index, t_offset=rq.t_offset, outcome="completed",
            ttft_s=ttft, total_s=time.perf_counter() - t_send, tokens=n)

    def _disconnect_fires(self) -> bool:
        """True when the gw.disconnect site fires for this client (any
        action — a raising schedule is the same vanished client)."""
        if self._faults is None:
            return False
        try:
            return self._faults.fire("gw.disconnect") is not None
        except InjectedFault:
            return True

    # ------------------------------------------------------------- #
    # observability
    # ------------------------------------------------------------- #

    def metrics(self) -> dict:
        """Flat `loadgen/*` rows (docs/METRICS.md): cumulative counters
        plus the LAST run's offered/goodput rates."""
        with self._lock:
            c = dict(self._counters)
            dur = self._last_duration_s
            offered = self._last_offered
            done = self._last_completed
            reasons = dict(self._shed_reasons)
        out = {
            "loadgen/offered": c["offered"],
            "loadgen/completed": c["completed"],
            "loadgen/shed": c["shed"],
            "loadgen/errors": c["errors"],
            "loadgen/offered_rps": round(offered / dur, 4) if dur else 0.0,
            "loadgen/goodput_rps": round(done / dur, 4) if dur else 0.0,
            "loadgen/shed_frac": round(c["shed"] / c["offered"], 4)
                                 if c["offered"] else 0.0,
        }
        for reason, count in sorted(reasons.items()):
            out[f'loadgen/shed_total{{reason="{reason}"}}'] = count
        return out
