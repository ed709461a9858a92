"""Sample lineage ledger: end-to-end rollout provenance (docs/OBSERVABILITY.md §6).

The paper's two defining data-path tricks — sparse GRPO silently dropping
zero-advantage samples, and an index-keyed rollout seed — make *per-sample*
provenance the real debugging surface. Aggregates (health EWMAs, fleet
counters) tell you THAT samples vanished; this ledger tells you WHICH, WHERE
and WHY. It is the same shape RLAX (arxiv 2512.06392) ships as a first-class
"trajectory store" in its TPU RL stack.

One joinable event stream per rollout index, across every layer a sample
passes through:

    lease      prompt draw + dataset cursor: lease id, worker id (and
               `reassigned_from` when a revoked lease is re-granted — the
               two events for one index carry both worker ids), PRNG
               fold-in key path
    generation policy version, wall time, spec-decode per-row accepted
               tokens / draft acceptance, and the `segments` list
               ([{row, policy_version, tok_range}]) that in-flight
               mid-sequence weight swaps populate with one entry per
               policy-version span (docs/ORCHESTRATOR.md §in-flight swaps;
               `tools/inspect_run.py --segments` is the query side)
    queue      enqueue/dequeue monotonic times, staleness at consumption
    reward     per-sample score, retry attempt, grader wall time
    outcome    advantage, kept rows; excluded rows land as `drop` events
    drop       machine-readable `drop_reason` + affected sample count
               (sparse_zero_advantage, sentinel_quarantine,
               fleet_late_duplicate, stale_drop, keep_filter,
               is_truncated_weight, ...)

Every event carries the `rollout_index` / `step` / `policy_version`
correlation keys the tracer stamps on spans, so a ledger row joins against
trace.json and metrics.jsonl; `tools/inspect_run.py` is the query side.

Mechanics: thread-safe, append-only JSONL under `<dir>/lineage/`, size-
rotated (`ledger_00000.jsonl`, `ledger_00001.jsonl`, ...). Off by default
(`cfg.lineage`); when disabled every method is a cheap no-op, the same
contract as SpanTracer. `cfg.lineage_sample_rate` gates whole rollout
indices (deterministic hash, never individual events) so a sampled index
always has its complete lease→generation→queue→reward→outcome chain.
Drop-reason counters and the last-N sample ring are kept regardless of
sampling — they feed /statusz and the `lineage/*` metric rows. The event
index is monotonic and journaled in trainer_state.json ("lineage", beside
"health") so a resumed run appends, never restarts, the stream. jax-free.

The port's copy of `nanorlhf_tpu/telemetry/lineage.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import glob
import json
import os
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
import time
from collections import deque
from typing import Iterator, Optional

# Knuth multiplicative hash: cheap, deterministic, index-keyed — the same
# rollout index samples in or out on every worker and every resume
_HASH_MULT = 2654435761
_HASH_MOD = 1 << 32


def _jsonable(v):
    """Best-effort JSON coercion (the tracer's idiom): numpy / device
    scalars and arrays become plain Python; everything else falls back to
    str so a ledger write can never raise on an exotic payload."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", None) == 0:
        try:
            return _jsonable(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        try:
            return _jsonable(tolist())
        except Exception:
            pass
    return str(v)


class LineageLedger:
    """Append-only provenance ledger. Construct once per trainer; share the
    instance across the orchestrator/fleet/queue threads — every write takes
    the internal lock, and rotation happens under it."""

    def __init__(
        self,
        output_dir: str,
        enabled: bool = True,
        sample_rate: float = 1.0,
        max_bytes: int = 8 * 1024 * 1024,
        ring_len: int = 32,
        rows_hint: int = 1,
        key_path: Optional[str] = None,
    ):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.max_bytes = int(max_bytes)
        # batch rows per rollout index: the unit drop counters are kept in
        # when the dropping layer (queue, fleet dedup) can't see rows
        self.rows_hint = int(rows_hint)
        # human-readable PRNG derivation stamped on lease events, e.g.
        # "fold_in(fold_in(seed_key, 0x5E11), rollout_index)"
        self.key_path = key_path
        self._lock = make_lock("telemetry.lineage")
        self._fh = None
        self._seq = 0            # rotation file sequence
        self._event_index = 0    # monotonic across rotation AND resume
        self.dropped_writes = 0  # events lost to I/O errors (never raise)
        self.drop_counts: dict[str, int] = {}
        self._ring: deque = deque(maxlen=max(1, int(ring_len)))
        self.dir = os.path.join(output_dir, "lineage") if enabled else ""
        if not self.enabled:
            return
        os.makedirs(self.dir, exist_ok=True)
        # resume appends to the newest rotation file rather than clobbering
        existing = sorted(glob.glob(os.path.join(self.dir, "ledger_*.jsonl")))
        if existing:
            try:
                self._seq = int(os.path.basename(existing[-1])[7:-6])
            except ValueError:
                self._seq = len(existing)
        self._open()

    # ----------------------------------------------------------------- #
    # write path
    # ----------------------------------------------------------------- #

    def _path(self) -> str:
        return os.path.join(self.dir, f"ledger_{self._seq:05d}.jsonl")

    def _open(self):
        self._fh = open(self._path(), "a")

    def sampled(self, rollout_index: Optional[int]) -> bool:
        """Deterministic per-index sampling gate. Index-less events (and
        rate >= 1) always pass; a gated-out index is gated out at EVERY
        layer, so no partial chains."""
        if not self.enabled:
            return False
        if rollout_index is None or self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = (int(rollout_index) * _HASH_MULT) % _HASH_MOD
        return (h / _HASH_MOD) < self.sample_rate

    def event(self, etype: str, rollout_index: Optional[int] = None,
              **fields) -> int:
        """Append one event; returns its monotonic event index (-1 when
        disabled / sampled out / lost to an I/O error). Never raises."""
        if not self.sampled(rollout_index):
            return -1
        rec = {"type": etype, "time": time.time(),
               "t_mono": time.perf_counter()}
        if rollout_index is not None:
            rec["rollout_index"] = int(rollout_index)
        for k, v in fields.items():
            if v is not None:
                rec[k] = _jsonable(v)
        with self._lock:
            rec["i"] = self._event_index
            try:
                if self._fh.tell() > self.max_bytes:
                    self._fh.close()
                    self._seq += 1
                    self._open()
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
            except (OSError, ValueError):
                self.dropped_writes += 1
                return -1
            self._event_index += 1
            return rec["i"]

    # ----------------------------------------------------------------- #
    # typed emitters (thin sugar over event(); layers call these so the
    # schema lives in one file)
    # ----------------------------------------------------------------- #

    def lease(self, rollout_index: int, *, lease_id=None, worker_id=None,
              reassigned_from=None, cursor=None, length=None, **fields) -> int:
        return self.event(
            "lease", rollout_index, lease_id=lease_id, worker_id=worker_id,
            reassigned_from=reassigned_from, cursor=cursor, length=length,
            key_path=self.key_path, **fields,
        )

    def generation(self, rollout_index: int, *, policy_version=None,
                   worker_id=None, lease_id=None, gen_s=None, spec=None,
                   segments=None, **fields) -> int:
        # `segments` defaults to the single-policy whole-range entry; the
        # in-flight weight-swap path passes `segments_summary(payload)` —
        # one entry per {policy_version, tok_range} span per row
        if segments is None and policy_version is not None:
            segments = [{"policy_version": policy_version,
                         "tok_range": [0, None]}]
        return self.event(
            "generation", rollout_index, policy_version=policy_version,
            worker_id=worker_id, lease_id=lease_id, gen_s=gen_s, spec=spec,
            segments=segments, **fields,
        )

    def turn(self, rollout_index: int, *, step=None, row=None, turn=None,
             tool_wall_s=None, obs_range=None, obs_tokens=None, reward=None,
             tok_range=None, **fields) -> int:
        # one event per (episode row, turn) from the multi-turn env driver
        # (envs/rollout.py): `tok_range` is the turn's model-token span and
        # `obs_range` the observation span, both in response coordinates —
        # the same coordinate space as generation `segments`, so turn
        # events join generation events on rollout_index
        return self.event(
            "turn", rollout_index, step=step, row=row, turn=turn,
            tool_wall_s=tool_wall_s, obs_range=obs_range,
            obs_tokens=obs_tokens, reward=reward, tok_range=tok_range,
            **fields,
        )

    def queue(self, rollout_index: int, *, enqueue_t=None, dequeue_t=None,
              staleness=None, policy_version=None, **fields) -> int:
        return self.event(
            "queue", rollout_index, enqueue_t=enqueue_t, dequeue_t=dequeue_t,
            staleness=staleness, policy_version=policy_version, **fields,
        )

    def reward(self, rollout_index: int, *, step=None, scores=None,
               attempt=None, wall_s=None, **fields) -> int:
        return self.event(
            "reward", rollout_index, step=step, scores=scores,
            attempt=attempt, wall_s=wall_s, **fields,
        )

    def outcome(self, rollout_index: int, *, step=None, policy_version=None,
                kept=None, advantage=None, **fields) -> int:
        return self.event(
            "outcome", rollout_index, step=step,
            policy_version=policy_version, kept=kept, advantage=advantage,
            **fields,
        )

    def drop(self, rollout_index: Optional[int], reason: str, *,
             count: Optional[int] = None, step=None, row=None,
             **fields) -> int:
        """Attribute excluded samples. `count` defaults to 1 for row-level
        drops (pass `row`) and to `rows_hint` for whole-rollout drops —
        the histogram is denominated in SAMPLES either way. Counters are
        bumped even for sampled-out indices so /statusz and the
        `lineage/dropped_total{reason=...}` rows stay exact."""
        if not self.enabled:
            return -1
        if count is None:
            count = 1 if row is not None else self.rows_hint
        with self._lock:
            self.drop_counts[reason] = (
                self.drop_counts.get(reason, 0) + int(count)
            )
        return self.event(
            "drop", rollout_index, reason=reason, count=int(count),
            step=step, row=row, **fields,
        )

    def fault(self, *, point=None, worker=None, action=None, **fields) -> int:
        """One armed fault site firing (the chaos harness hooks
        FaultInjector.on_fire here): index-less, so the offline
        `inspect_run --chaos` timeline rebuilds from the ledger alone."""
        return self.event(
            "fault", None, point=point, worker=worker, action=action,
            **fields,
        )

    def chaos_run(self, *, seed=None, spec=None, spec_digest=None,
                  path=None, key_path=None, **fields) -> int:
        """Chaos soak header: the composed spec + its derivation, enough
        to replay the identical run (`nanorlhf_tpu/chaos/`)."""
        return self.event(
            "chaos_run", None, seed=seed, spec=spec,
            spec_digest=spec_digest, path=path, key_path=key_path, **fields,
        )

    def chaos_audit(self, *, name=None, ok=None, detail=None,
                    checked=None, **fields) -> int:
        """One run-invariant auditor's verdict (chaos/auditors.py)."""
        return self.event(
            "chaos_audit", None, name=name, ok=ok, detail=detail,
            checked=checked, **fields,
        )

    def note_sample(self, rollout_index: int, *, step=None, score=None,
                    response_chars=None, worker_id=None, kept=None):
        """Feed the last-N ring behind /statusz's `recent` list. Summaries
        only (score, size, provenance) — full text lives in the ledger's
        `sample` events, not in a scrape payload."""
        if not self.enabled:
            return
        with self._lock:
            self._ring.append({
                "rollout_index": int(rollout_index),
                "step": step, "score": _jsonable(score),
                "response_chars": response_chars, "worker_id": worker_id,
                "kept": kept,
            })

    # ----------------------------------------------------------------- #
    # read side: /statusz, /metrics, journal
    # ----------------------------------------------------------------- #

    def statusz(self) -> dict:
        """JSON-able snapshot for the exporter's /statusz `lineage`
        section: drop-reason counts since start + the last-N sample ring."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "events": self._event_index,
                "dropped_writes": self.dropped_writes,
                "drop_reasons": dict(self.drop_counts),
                "recent": list(self._ring),
            }

    def metric_rows(self) -> dict:
        """Labeled gauge rows for /metrics, keyed in the
        `name{label="v"}` form render_prometheus preserves — e.g.
        `lineage/dropped_total{reason="sparse_zero_advantage"}`."""
        if not self.enabled:
            return {}
        with self._lock:
            rows = {"lineage/events_total": float(self._event_index)}
            for reason, n in sorted(self.drop_counts.items()):
                rows[f'lineage/dropped_total{{reason="{reason}"}}'] = float(n)
            return rows

    def journal(self) -> dict:
        """Resume continuity state for trainer_state.json ("lineage",
        beside "health"): the restored ledger continues the monotonic
        event-index stream and the since-start drop counters."""
        with self._lock:
            return {
                "event_index": self._event_index,
                "seq": self._seq,
                "drop_counts": dict(self.drop_counts),
            }

    def restore(self, journal: dict):
        if not self.enabled or not journal:
            return
        with self._lock:
            self._event_index = max(
                self._event_index, int(journal.get("event_index", 0))
            )
            for k, v in (journal.get("drop_counts") or {}).items():
                self.drop_counts[k] = max(
                    self.drop_counts.get(k, 0), int(v)
                )

    def close(self):
        """Flush + close. Idempotent; event() after close counts into
        dropped_writes instead of raising."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
        self.enabled = False


def segments_summary(payload) -> Optional[list]:
    """Flatten a rollout payload's per-row `segments` lists (stamped by the
    in-flight weight-swap path, docs/ORCHESTRATOR.md §in-flight swaps) into
    the flat JSON list generation events carry:

        [{"row": r, "policy_version": v, "tok_range": [start, end]}, ...]

    `tok_range` is in response-token coordinates — the same space as `turn`
    events' tok_range, so swap boundaries and turn boundaries join directly.
    None when the payload carries no segments (swaps off, or a non-dict
    payload): `LineageLedger.generation` then falls back to the
    single-policy whole-range default."""
    segs = payload.get("segments") if isinstance(payload, dict) else None
    if not segs:
        return None
    out = []
    for row, row_segs in enumerate(segs):
        for s in row_segs or ():
            out.append({
                "row": row,
                "policy_version": _jsonable(s.get("policy_version")),
                "tok_range": _jsonable(s.get("tok_range")),
            })
    return out or None


def spec_summary(payload) -> Optional[dict]:
    """Pull the spec-decode stats dict out of a (device-ready) rollout
    payload into the JSON shape generation events carry — aggregate draft
    acceptance plus the per-row accepted-token counts. None when the
    payload has no spec stats (spec decode off, or a non-dict payload)."""
    st = payload.get("spec_stats") if isinstance(payload, dict) else None
    if not st:
        return None
    out = {
        k: _jsonable(st[k])
        for k in ("verify_steps", "drafted", "accepted", "emitted",
                  "accepted_rows")
        if k in st
    }
    drafted = out.get("drafted")
    if drafted:
        out["acceptance"] = round(out.get("accepted", 0) / drafted, 4)
    return out or None


# --------------------------------------------------------------------- #
# offline readers (tools/inspect_run.py + tests share these, so "parse
# the ledger" means the same thing in the CLI and in CI)
# --------------------------------------------------------------------- #


def read_ledger(run_dir: str) -> Iterator[dict]:
    """Yield every event from a run's rotated ledger files in write order.
    Accepts the run dir (containing `lineage/`) or the lineage dir itself;
    tolerates a truncated tail line (a crash mid-write)."""
    d = run_dir
    if os.path.isdir(os.path.join(run_dir, "lineage")):
        d = os.path.join(run_dir, "lineage")
    for path in sorted(glob.glob(os.path.join(d, "ledger_*.jsonl"))):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def drop_histogram(events) -> dict:
    """Fold `drop` events into {reason: sample_count} — the histogram
    /statusz serves live, reproduced from the ledger alone."""
    hist: dict[str, int] = {}
    for ev in events:
        if ev.get("type") == "drop":
            reason = ev.get("reason", "unknown")
            hist[reason] = hist.get(reason, 0) + int(ev.get("count", 1))
    return hist


def chains(events) -> dict:
    """Group events by rollout index: {index: {type: [events...]}} — the
    join inspect_run.py and the fleet acceptance test walk."""
    by_index: dict[int, dict] = {}
    for ev in events:
        idx = ev.get("rollout_index")
        if idx is None:
            continue
        by_index.setdefault(int(idx), {}).setdefault(
            ev["type"], []
        ).append(ev)
    return by_index
