"""Bounded-staleness rollout sample queue (host thread + deque; device
arrays inside payloads stay sharded — the queue never copies them).

Staleness model (docs/ORCHESTRATOR.md): the policy advances one VERSION per
optimizer update (`VersionedWeightStore.publish`); a sample generated from
version v consumed while the policy is at version V has staleness V − v.
With one publish per consumed sample (the dense trainer), gating the
producer so rollout i (relative to the queue's start index) waits until
`version >= i - max_staleness` bounds every consumed sample's staleness at
`max_staleness` — the PipelineRL/LlamaRL bounded-lag queue.

Overflow policy — production is gated IDENTICALLY in both modes (a sample
whose dispatch could already exceed the bound would only burn the data/PRNG
cursor and rollout compute on a result destined for the floor); they differ
in what happens to a queued sample that goes over-stale anyway, which under
the normal one-publish-per-consume cadence cannot happen and therefore
signals an abnormal cadence (the consumer published without consuming —
e.g. an external weight sync or multi-update schedule):
- "wait" (default): over-stale samples are still DELIVERED (recorded in the
  staleness histogram above the bound) — nothing is ever discarded, and the
  truncated-IS correction absorbs the extra staleness.
- "drop": `get()` DISCARDS over-stale samples and returns the next fresh
  one; `dropped` counts the discards.

jax-free on purpose: unit-testable with plain dict payloads.

(The port's copy of `nanorlhf_tpu/orchestrator/sample_queue.py`;
`tests/test_torch_orchestrator.py` holds it against the original.)
"""

from __future__ import annotations

import collections
import dataclasses
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_condition
import time
from typing import Any, Optional


class ProducerFailed(RuntimeError):
    """The producer thread died (its terminal exception is `__cause__`, when
    it reported one). A dedicated type so the trainer's watchdog can tell a
    supervisable producer death from an organic consumer-side error —
    subclassing RuntimeError keeps pre-watchdog callers working."""


@dataclasses.dataclass
class QueuedSample:
    index: int           # rollout index — the data/PRNG cursor position
    version: int         # policy version the sample was generated from
    payload: Any         # the rollout dict (sharded device arrays + host data)
    dispatch_time: float = 0.0
    ready_time: float = 0.0


class BoundedStalenessQueue:
    def __init__(self, max_staleness: int, policy: str = "wait",
                 start_index: int = 0, lineage=None, latency=None):
        if max_staleness < 0:
            raise ValueError(f"max_staleness={max_staleness} must be >= 0")
        if policy not in ("wait", "drop"):
            raise ValueError(f"staleness policy {policy!r}: wait | drop")
        self.max_staleness = max_staleness
        self.policy = policy
        # lineage ledger (telemetry/lineage.py): queue-transit events —
        # enqueue/dequeue monotonic times + staleness at consumption — and
        # stale-drop attribution. None/disabled = no-op.
        self._lineage = lineage
        # LatencyHub (telemetry/hist.py): per-sample queue-wait histogram,
        # recorded at dequeue. telemetry.hist ranks above
        # orchestrator.queue in LOCK_ORDER, so recording under _cond is
        # order-legal. None/disabled = no-op.
        self._latency = latency
        self.maxsize = max_staleness + 1
        self._base = start_index     # gate arithmetic is RELATIVE to this
        self._q: collections.deque[QueuedSample] = collections.deque()
        self._cond = make_condition("orchestrator.queue")
        self._version = 0            # latest published policy version
        self._error: Optional[BaseException] = None
        # ---- metrics (cumulative; resume seeds them from the journal) ----
        self.dropped = 0
        self.staleness_counts: dict[int, int] = {}
        # who-waits-on-whom diagnostics (cumulative seconds, perf_counter;
        # per-process — not journaled): consumer_wait_s = trainer starved
        # for samples (pipeline too shallow / generation too slow),
        # producer_gate_wait_s = producer blocked on the staleness gate or
        # queue capacity (training is the bottleneck — the healthy state).
        # Surfaced via orchestrator.stats() and the telemetry counters.
        self.consumer_wait_s = 0.0
        self.producer_gate_wait_s = 0.0

    # ---------------------------------------------------------------- #
    # producer side
    # ---------------------------------------------------------------- #

    def wait_to_produce(self, index: int, stop) -> bool:
        """Block until rollout `index` may be dispatched; False on stop.

        Gate (both policies): the staleness bound — the version must have
        reached `index - base - max_staleness` — plus queue capacity. With
        one publish per consume, a sample admitted here can never exceed
        the bound at consumption.
        """
        with self._cond:
            while not stop.is_set():
                gate_open = (
                    (index - self._base) - self._version <= self.max_staleness
                )
                if gate_open and len(self._q) < self.maxsize:
                    return True
                t0 = time.perf_counter()
                self._cond.wait(timeout=0.1)
                self.producer_gate_wait_s += time.perf_counter() - t0
            return False

    def may_produce(self, index: int) -> bool:
        """Non-blocking `wait_to_produce` gate check — the fleet coordinator
        holds its own lock while sizing leases and cannot block in here; it
        re-polls on its own wait cadence instead. Capacity is NOT checked:
        the coordinator's in-order reorder buffer means granted-but-unqueued
        indices already bound queue depth via this same staleness gate."""
        with self._cond:
            return (index - self._base) - self._version <= self.max_staleness

    def put(self, sample: QueuedSample) -> None:
        with self._cond:
            self._q.append(sample)
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Producer died: wake the consumer with the exception."""
        with self._cond:
            self._error = exc
            self._cond.notify_all()

    # ---------------------------------------------------------------- #
    # consumer side
    # ---------------------------------------------------------------- #

    def advance_version(self, version: int) -> None:
        """The trainer published a new policy version (one per update)."""
        with self._cond:
            self._version = version
            self._cond.notify_all()

    def credit_skip(self) -> None:
        """The consumer took a sample WITHOUT training on it (a sentinel-
        quarantined batch): shift the gate's base so the producer may run
        one more index ahead without a version publish — publishing instead
        would mislabel every queued sample one version staler than its
        weights really are (and the "drop" policy would evict them)."""
        with self._cond:
            self._base += 1
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> QueuedSample:
        """Next sample, oldest first; records its staleness in the
        histogram. Under "drop", over-stale samples are discarded here.

        Buffered samples are drained BEFORE a producer failure is raised:
        samples already in the deque are complete device-ready rollouts
        produced under the same version arithmetic the consumer is using —
        discarding them would make every watchdog restart regenerate up to
        max_staleness+1 rollouts that were never lost."""
        with self._cond:
            while True:
                if self._q:
                    s = self._q.popleft()
                    staleness = self._version - s.version
                    if (self.policy == "drop"
                            and staleness > self.max_staleness):
                        self.dropped += 1
                        if self._lineage is not None:
                            self._lineage.drop(
                                s.index, "stale_drop", staleness=staleness,
                                policy_version=s.version,
                            )
                        self._cond.notify_all()
                        continue
                    self.staleness_counts[staleness] = (
                        self.staleness_counts.get(staleness, 0) + 1
                    )
                    if (self._latency is not None and self._latency.enabled
                            and s.ready_time > 0.0):
                        # dequeue − device-ready, both on the producer's
                        # monotonic clock: the sample's true queue wait
                        # (unstamped samples — plain-dict unit-test
                        # payloads — carry ready_time 0.0 and are skipped)
                        self._latency.record(
                            "latency/queue_wait_s",
                            time.perf_counter() - s.ready_time,
                        )
                    if (self._lineage is not None
                            and self._lineage.enabled):
                        # dispatch/ready stamps share the producer's clock
                        # (perf_counter), so queue wait = dequeue_t -
                        # enqueue_t is NTP-step-safe; the wall-clock
                        # dequeue stamp survives as provenance only (the
                        # ledger's own record envelope carries it too)
                        self._lineage.queue(
                            s.index, enqueue_t=s.ready_time,
                            dequeue_t=time.perf_counter(),
                            staleness=staleness, policy_version=s.version,
                            # nanolint: allow[determinism.wall-clock] dequeue_wall is a provenance stamp, not a duration input
                            dequeue_wall=time.time(),
                        )
                    self._cond.notify_all()
                    return s
                if self._error is not None:  # buffer drained: surface it
                    raise ProducerFailed(
                        "rollout producer failed"
                    ) from self._error
                t0 = time.perf_counter()
                ok = self._cond.wait(timeout=timeout)
                self.consumer_wait_s += time.perf_counter() - t0
                if not ok:
                    raise TimeoutError(
                        f"no rollout sample after {timeout}s (producer "
                        "stalled?)"
                    )

    # ---------------------------------------------------------------- #
    # introspection / persistence
    # ---------------------------------------------------------------- #

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def journal(self) -> dict:
        """JSON-able queue state for the checkpoint's trainer_state: the
        pending (dispatched, unconsumed) indices plus cumulative counters.
        Pending samples are NOT persisted — on resume they are re-drawn
        from the consumed-rollout cursor (the index-keyed generation PRNG
        and deterministic loader reproduce their token streams)."""
        with self._cond:
            return {
                "pending": [s.index for s in self._q],
                "version": self._version,
                "dropped": self.dropped,
                "staleness_counts": {
                    str(k): v for k, v in self.staleness_counts.items()
                },
            }

    def restore_counters(self, journal: dict) -> None:
        """Seed the cumulative metric counters from a saved journal so
        dropped/staleness series stay continuous across resume. Version and
        pending entries are NOT restored — a fresh orchestrator restarts
        version-relative arithmetic at 0 and re-draws pending samples."""
        with self._cond:
            self.dropped = int(journal.get("dropped", 0))
            self.staleness_counts = {
                int(k): int(v)
                for k, v in journal.get("staleness_counts", {}).items()
            }
