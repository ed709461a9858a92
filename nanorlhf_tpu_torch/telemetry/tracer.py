"""Cross-thread span tracer + flight recorder (docs/OBSERVABILITY.md).

The async pipeline (orchestrator producer thread, checkpoint I/O, reward
dispatch, the trainer loop itself) made "where did this update's 40 s go"
unanswerable from the flat `time/*_s` scalars: a phase split cannot show
that the producer's generation for rollout k+1 ran UNDER update k's
backward, or that a sentinel trip landed mid-checkpoint. The tracer records
named spans with correlation args (policy_version, rollout_index,
staleness, step) on per-thread tracks and writes them as Chrome
trace-event JSON (`trace.json`) — load it at https://ui.perfetto.dev or
chrome://tracing and the producer/trainer overlap is a picture, not an
inference.

Three consumers share the one event stream:

- `write_trace(path)` — the full bounded event buffer as a Chrome
  trace-event file (`{"traceEvents": [...]}`; complete "X" events with
  `ts`/`dur` in µs, thread-name "M" metadata, counter "C" events).
- the **flight recorder** — a ring of the most recent completed spans plus
  the latest counter snapshots and the per-thread in-flight span stacks;
  `dump_blackbox()` writes it as `blackbox_<step>.json` when something
  dies (sentinel trip, producer failure, SIGTERM) so the post-mortem has
  "what was every thread doing" even when the run never reached
  `write_trace`.
- live counters (`counter()`) — queue depth, staleness — snapshotted into
  both sinks.

Clock: `time.perf_counter_ns()` relative to tracer construction —
monotonic and process-wide consistent across threads (CLOCK_MONOTONIC), so
cross-thread span overlap is real overlap; an NTP step cannot reorder
tracks (the same reason PhaseTimer uses perf_counter).

Disabled (the default) the tracer is a cheap no-op: `span()` yields an
empty dict without touching the lock, `add_complete`/`instant`/`counter`
return immediately — the enabled/disabled bench A/B is the acceptance
gate for keeping the instrumentation inline unconditionally.

jax-free on purpose: unit-testable (and bench-parent-importable) with
plain Python threads.

The port's copy of `nanorlhf_tpu/telemetry/tracer.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
import time
from typing import Optional

# synthetic tids for logical tracks (work that happens ON some host thread
# but belongs to one conceptual lane — checkpoint I/O, reward dispatch,
# async rollout readiness). Real thread idents are huge (pthread
# addresses); small constants cannot collide with them in practice, and
# each track only ever receives sequential spans from one call site, so
# per-tid nesting stays valid.
_TRACK_TID_BASE = 1


def _jsonable(v):
    """Span args must be JSON scalars — numpy scalars and exotic objects
    are coerced rather than poisoning the trace file at write time."""
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else str(v)
    try:
        f = float(v)  # numpy scalar
        return f if math.isfinite(f) else str(v)
    except (TypeError, ValueError):
        return str(v)


class SpanTracer:
    """Thread-safe span/counter recorder with a bounded event buffer and a
    flight-recorder ring. One instance per trainer; every subsystem
    (orchestrator, checkpoint manager, reward dispatch) records into it."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000,
                 ring_len: int = 256):
        self.enabled = bool(enabled)
        self.dropped = 0          # events past max_events (telemetry/spans_dropped)
        self._max_events = int(max_events)
        self._lock = make_lock("telemetry.tracer")
        self._events: list[dict] = []
        self._ring: collections.deque = collections.deque(maxlen=int(ring_len))
        self._counters: dict[str, float] = {}
        # per-thread stacks of IN-FLIGHT spans — the flight recorder's
        # "what was every thread doing at the moment of death" view
        self._open: dict[int, list[dict]] = {}
        self._thread_names: dict[int, str] = {}
        self._tracks: dict[str, int] = {}
        self._pid = os.getpid()
        self._t0_ns = time.perf_counter_ns()
        # wall-clock of the trace epoch, so blackbox/trace timestamps can be
        # correlated with metrics.jsonl rows (which carry time.time())
        self.epoch_unix = time.time()

    # ------------------------------------------------------------------ #
    # clock / track plumbing
    # ------------------------------------------------------------------ #

    def now_us(self) -> float:
        """µs since tracer construction (monotonic, cross-thread)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            t = threading.current_thread()
            self._thread_names.setdefault(t.ident, t.name)
            return t.ident
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = self._tracks[track] = _TRACK_TID_BASE + len(self._tracks)
        return tid

    def _record(self, ev: dict) -> None:
        # caller does NOT hold the lock
        with self._lock:
            self._ring.append(ev)
            if len(self._events) < self._max_events:
                self._events.append(ev)
            else:
                self.dropped += 1

    # ------------------------------------------------------------------ #
    # recording API
    # ------------------------------------------------------------------ #

    @contextlib.contextmanager
    def span(self, name: str, track: Optional[str] = None, **args):
        """Record `name` over the with-block on the calling thread's track
        (or the named logical `track`). Yields the mutable args dict so
        correlation ids learned mid-span (rollout_index after the fetch)
        can be attached before the span closes."""
        if not self.enabled:
            yield {}
            return
        args = {k: _jsonable(v) for k, v in args.items()}
        tid = self._tid(track)
        ident = threading.get_ident()
        t0 = self.now_us()
        open_rec = {"name": name, "ts": t0, "tid": tid, "args": args}
        with self._lock:
            self._open.setdefault(ident, []).append(open_rec)
        try:
            yield args
        finally:
            t1 = self.now_us()
            with self._lock:
                stack = self._open.get(ident)
                if stack and stack[-1] is open_rec:
                    stack.pop()
            self._record({
                "name": name, "ph": "X", "ts": t0, "dur": t1 - t0,
                "pid": self._pid, "tid": tid,
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    def add_complete(self, name: str, ts_us: float, dur_us: float,
                     track: Optional[str] = None, **args) -> None:
        """Record an already-measured span (explicit start/duration in this
        tracer's clock, see now_us()) — for windows whose end is observed on
        a different thread than their start (async rollout readiness) or
        whose body cannot be a with-block (the trainer's per-update span,
        which must survive `continue` on sentinel rollback)."""
        if not self.enabled:
            return
        self._record({
            "name": name, "ph": "X", "ts": float(ts_us),
            "dur": max(0.0, float(dur_us)), "pid": self._pid,
            "tid": self._tid(track),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def add_async(self, name: str, ts_us: float, dur_us: float, aid,
                  track: str = "async", **args) -> None:
        """Record an already-measured window as a Chrome ASYNC event pair
        (ph "b"/"e", keyed by `aid`): unlike complete "X" spans, async
        windows on one track may legitimately OVERLAP — e.g. serial /
        rollout_ahead generation readiness windows, where rollout k+1's
        dispatch precedes rollout k's device-ready. Perfetto draws each id
        on its own sub-row; the schema validator exempts async events from
        the per-track nesting check for the same reason."""
        if not self.enabled:
            return
        tid = self._tid(track)
        base = {
            "name": name, "cat": track, "id": str(aid), "pid": self._pid,
            "tid": tid,
            "args": {k: _jsonable(v) for k, v in args.items()},
        }
        self._record({**base, "ph": "b", "ts": float(ts_us)})
        self._record({**base, "ph": "e", "args": {},
                      "ts": float(ts_us) + max(0.0, float(dur_us))})

    def instant(self, name: str, track: Optional[str] = None, **args) -> None:
        """Zero-duration marker (sentinel trip, quarantine skip)."""
        if not self.enabled:
            return
        self._record({
            "name": name, "ph": "i", "ts": self.now_us(), "s": "t",
            "pid": self._pid, "tid": self._tid(track),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def counter(self, name: str, value) -> None:
        """Latest-value counter (queue depth, staleness): snapshotted into
        the blackbox and emitted as a Chrome "C" event so Perfetto draws
        the series under the tracks."""
        if not self.enabled:
            return
        v = _jsonable(value)
        v = v if isinstance(v, (int, float)) else 0.0
        with self._lock:
            self._counters[name] = float(v)
        self._record({
            "name": name, "ph": "C", "ts": self.now_us(),
            "pid": self._pid, "tid": self._tid("counters"),
            "args": {"value": float(v)},
        })

    # ------------------------------------------------------------------ #
    # sinks
    # ------------------------------------------------------------------ #

    def _metadata_events(self, thread_names: dict, tracks: dict) -> list[dict]:
        evs = [{
            "name": "process_name", "ph": "M", "ts": 0.0, "pid": self._pid,
            "tid": 0, "args": {"name": "nanorlhf_tpu_torch"},
        }]
        for tid, tname in sorted(thread_names.items()):
            evs.append({
                "name": "thread_name", "ph": "M", "ts": 0.0,
                "pid": self._pid, "tid": tid, "args": {"name": tname},
            })
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            evs.append({
                "name": "thread_name", "ph": "M", "ts": 0.0,
                "pid": self._pid, "tid": tid, "args": {"name": track},
            })
        return evs

    def trace_events(self) -> list[dict]:
        """Snapshot of metadata + recorded events (Chrome trace order-free).
        The name/track dicts are copied under the lock: the producer thread
        is typically still alive when the end-of-train write runs, and
        iterating a dict another thread is inserting into raises."""
        with self._lock:
            events = list(self._events)
            thread_names = dict(self._thread_names)
            tracks = dict(self._tracks)
        return self._metadata_events(thread_names, tracks) + events

    def write_trace(self, path: str) -> Optional[str]:
        """Write the Chrome trace-event file; returns the path (None when
        disabled). Safe to call repeatedly — each call rewrites the full
        buffered history, so a trace exists after every train() call, not
        only after close()."""
        if not self.enabled:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
            "otherData": {"trace_epoch_unix": self.epoch_unix,
                          "spans_dropped": self.dropped},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def snapshot_blackbox(self, step: int, reason: str,
                          extra: Optional[dict] = None) -> dict:
        """The flight-recorder payload: recent completed spans, per-thread
        in-flight spans, counter snapshots."""
        with self._lock:
            spans = list(self._ring)
            open_spans = [
                {**rec, "args": dict(rec["args"]),
                 "thread": self._thread_names.get(ident, str(ident))}
                for ident, stack in self._open.items() for rec in stack
            ]
            counters = dict(self._counters)
        return {
            "reason": reason,
            "step": int(step),
            "unix_time": time.time(),
            "trace_epoch_unix": self.epoch_unix,
            "now_us": self.now_us(),
            "counters": counters,
            "open_spans": open_spans,
            "spans": spans,
            "spans_dropped": self.dropped,
            "extra": extra or {},
        }

    def dump_blackbox(self, directory: str, step: int, reason: str,
                      extra: Optional[dict] = None) -> Optional[str]:
        """Write `blackbox_<step>.json` (flight-recorder dump) — called by
        the resilience layer on sentinel trip, producer failure, and
        SIGTERM preemption. None when disabled."""
        if not self.enabled:
            return None
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"blackbox_{int(step)}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot_blackbox(step, reason, extra), f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------- #
# Chrome trace-event schema validation (shared by tests + the CI smoke)
# ---------------------------------------------------------------------- #

_REQUIRED_KEYS = ("ph", "ts", "pid", "tid")


def _laminar_errors(intervals: list[tuple[float, float, str]]) -> list[str]:
    """Spans on one track must NEST (a laminar interval family): any two
    either disjoint or one inside the other. `intervals` = (ts, dur, name)."""
    errs = []
    eps = 1e-3  # µs: same-µs boundary ties are not violations
    stack: list[tuple[str, float]] = []  # (name, end)
    for ts, dur, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        end = ts + dur
        while stack and stack[-1][1] <= ts + eps:
            stack.pop()
        if stack and end > stack[-1][1] + eps:
            errs.append(
                f"span {name!r} [{ts:.1f}, {end:.1f}] partially overlaps "
                f"enclosing span {stack[-1][0]!r} (ends {stack[-1][1]:.1f})"
            )
        stack.append((name, end))
    return errs


def validate_trace_events(events) -> list[str]:
    """Return a list of schema violations (empty == valid): every event
    carries ph/ts/pid/tid, ts/dur are finite (no NaN durations), complete
    spans on one (pid, tid) track nest."""
    errors: list[str] = []
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    by_track: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED_KEYS if k not in ev]
        if missing:
            errors.append(f"event {i} ({ev.get('name')!r}): missing {missing}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or not math.isfinite(ts):
            errors.append(f"event {i} ({ev.get('name')!r}): bad ts {ts!r}")
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) \
                    or dur < 0:
                errors.append(
                    f"event {i} ({ev.get('name')!r}): bad dur {dur!r}"
                )
                continue
            by_track.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), str(ev.get("name")))
            )
    for (pid, tid), ivs in sorted(by_track.items()):
        for e in _laminar_errors(ivs):
            errors.append(f"track pid={pid} tid={tid}: {e}")
    return errors


def validate_trace_file(path: str) -> list[str]:
    """Validate a trace.json on disk (the tier-1 CI telemetry gate)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace {path}: {type(e).__name__}: {e}"]
    if not isinstance(payload, dict):
        return ["trace root is not an object"]
    return validate_trace_events(payload.get("traceEvents"))
