"""Elastic rollout fleet: leased work, worker-level fault tolerance, live
reassignment (docs/FLEET.md).

Generalizes the single producer thread of `orchestrator.py` into N
independent, *preemptible* rollout workers — the trainer-pod + rollout-pod
shape of RLAX (arxiv 2512.06392) and LlamaRL (arxiv 2505.24034), where
losing a rollout worker under multi-tenant traffic is routine, not
exceptional. Three layers:

- **FleetCoordinator** — owns the prompt-index cursor and the determinism
  contract. It hands out *leases*: contiguous rollout-index ranges whose
  prompt batches are drawn from the data iterator AT GRANT TIME (under the
  coordinator lock, in strict index order) and cached on the lease. A
  revoked lease is reassigned to a healthy worker **with the same cached
  batches and the same index-keyed PRNG stream**, so a lost worker changes
  which silicon generates a sample but never what is generated (at
  staleness 0 the token stream is bit-identical, test-pinned; at
  staleness > 0 the re-dispatch may read fresher weights — the same resume
  semantics the single-producer restart has). Completed samples pass
  through an in-order reorder buffer before entering the bounded-staleness
  queue, so the consumer sees exactly the single-producer index order.

- **RolloutWorker** — an in-process thread (the whole machinery runs on the
  tier-1 CPU mesh) looping acquire-lease → heartbeat → fetch weights →
  dispatch → report. It talks to the world only through a small
  **FleetTransport** (`dispatch` / `heartbeat` / `fetch_weights`), the seam
  where a future multi-host backend (gRPC to a rollout pod, weights via
  device-to-device broadcast) plugs in without touching the coordinator.

- **FleetOrchestrator** — the consumer-facing shell with the SAME surface
  as `RolloutOrchestrator` (get / publish / stats / journal / close /
  consumed_without_update), so the trainer's watchdog, sentinel, and
  checkpoint machinery drive both interchangeably.

Fault tolerance (every mode deterministically reproducible via the
worker-scoped fault sites in resilience/faults.py):

- *crash* — a dead worker (in-band fatal report, or thread death noticed
  by the liveness check) has its lease revoked and reassigned; membership
  shrinks. `fleet/reassigned_leases` counts these.
- *hang / straggle* — lease deadlines derive from an EWMA of sample
  latency (`straggler_factor × ewma × lease_len`); an expired lease is
  revoked and re-dispatched speculatively (first completion per index
  wins; late duplicates are dropped, `fleet/duplicate_samples`).
- *partition / split-brain* — every lease carries a monotonically
  increasing **epoch** (fencing token, = the coordinator's lease
  sequence at grant). A completion whose epoch is lower than the highest
  epoch granted for that index is FENCED: the revoked holder — maybe a
  partitioned worker racing its replacement over a healed link — cannot
  commit, regardless of arrival order. Fenced completions count as
  `fleet/fenced_completions` (and duplicates) and emit the
  `fleet_late_duplicate` lineage drop with `{"fenced": true, "epoch"}`.
- *flaky* — consecutive in-band failures past `failure_budget` quarantine
  the worker with exponential backoff + jitter (resilience/retry.py — the
  jitter prevents N workers from stampeding the weight store in lockstep);
  a completed sample resets the streak.
- *elastic membership* — workers join/leave mid-run (`add_worker` /
  `remove_worker`); losing the LAST worker fails the queue with
  `FleetExhausted` (a ProducerFailed), which the trainer's existing
  watchdog answers with restart-with-backoff and, past budget, the
  synchronous degraded mode — never a deadlock.

The port's copy of `nanorlhf_tpu/orchestrator/fleet.py`
(`tests/test_torch_fleet.py` holds it against the original). The
coordinator is copied as is; what differs is where the JAX version waits
with `jax.block_until_ready`: each worker thread runs under a
`torch.cuda.Stream` of its own on the one card (`producer_stream`, when
the fleet is given a CUDA `device`), a transport waits on an event
recorded on that stream before a sample completes (`device_ready`), and
the consumer adopts each sample's CUDA tensors onto its own stream
(`adopt_payload`). There are no per-worker device groups on one card.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_condition
import time
from typing import Callable, Optional

from nanorlhf_tpu_torch.orchestrator.orchestrator import (
    adopt_payload,
    device_ready,
    producer_stream,
)
from nanorlhf_tpu_torch.orchestrator.sample_queue import (
    BoundedStalenessQueue,
    ProducerFailed,
    QueuedSample,
)
from nanorlhf_tpu_torch.orchestrator.weight_store import (
    VersionedWeightStore,
    make_swap_refresh,
)
from nanorlhf_tpu_torch.resilience.retry import backoff_delay
from nanorlhf_tpu_torch.telemetry.lineage import segments_summary, spec_summary


class FleetExhausted(ProducerFailed):
    """Every fleet worker is lost. A ProducerFailed subclass so the
    trainer's producer watchdog supervises fleet death exactly like a
    single-producer death: restart (a fresh fleet) with backoff, then the
    synchronous degraded mode."""


@dataclasses.dataclass
class FleetConfig:
    """Coordinator policy knobs (mirrored by RLConfig.fleet_*)."""

    lease_size: int = 1           # rollout indices per lease
    failure_budget: int = 2       # consecutive failures before quarantine
    quarantine_base: float = 0.5  # re-admission backoff: base · 2^k seconds
    quarantine_max: float = 30.0
    backoff_jitter: float = 0.25  # ±fraction spread (anti-stampede)
    straggler_factor: float = 4.0  # lease deadline = factor · ewma · length
    initial_deadline_s: float = 600.0  # pre-EWMA deadline (cold compile)
    worker_timeout_s: float = 600.0    # heartbeat staleness → lost (only
                                       # for transports without a liveness
                                       # probe; in-process uses the thread)
    ewma_alpha: float = 0.3
    poll_interval: float = 0.25   # acquire-wait / consumer-poll cadence
    seed: int = 0                 # quarantine-jitter PRNG


@dataclasses.dataclass
class Lease:
    """A contiguous rollout-index range granted to one worker, with the
    prompt batches drawn (in index order) at grant time. Reassignment hands
    the SAME batches to the next worker — the data cursor is never redrawn
    for a lease that already burned it."""

    lease_id: int
    worker_id: int
    start: int                 # first rollout index
    batches: list              # prompt batch per index (host arrays)
    issued_at: float           # coordinator clock
    deadline: float
    revoked: bool = False
    reassigned_from: Optional[int] = None  # worker that lost it (if any)
    epoch: int = 0             # fencing token (coordinator lease sequence
                               # at grant; higher = granted later)

    def __len__(self) -> int:
        return len(self.batches)


@dataclasses.dataclass
class _WorkerRecord:
    worker_id: int
    alive_fn: Optional[Callable[[], bool]] = None
    last_heartbeat: float = 0.0
    quarantined_until: float = 0.0
    consecutive_failures: int = 0
    quarantines: int = 0
    samples: int = 0
    ewma_s: float = 0.0
    lost: bool = False
    # drain-then-remove (elastic scale-in): a draining worker is still
    # alive and may finish its in-flight leases, but the grant path
    # skips it — no new work, then deregister once its leases complete
    draining: bool = False

    def alive(self, now: float, timeout: float) -> bool:
        if self.lost:
            return False
        if self.alive_fn is not None:
            return bool(self.alive_fn())
        return (now - self.last_heartbeat) < timeout


_COUNTERS = (
    "leases_granted", "reassigned_leases", "expired_leases",
    "speculative_dispatches", "worker_failures", "quarantines",
    "worker_joins", "worker_losses", "duplicate_samples",
    "fenced_completions",
)

# transport counters merged into stats() when a network transport has
# registered its provider (FleetRpcServer.transport_info); always present
# (0.0) so the fleet/rpc_* metric rows exist for every transport
_TRANSPORT_COUNTERS = (
    "rpc_retries", "rpc_reconnects", "rpc_rtt_ewma_s",
    "rpc_bytes_tx", "rpc_bytes_rx", "rpc_errors", "heartbeat_misses",
)


class FleetCoordinator:
    """Owns the prompt-index cursor, the lease table, worker membership /
    liveness, and the in-order reorder buffer feeding the bounded-staleness
    queue. jax-free: unit-testable with fake workers and plain payloads.

    Grant fairness: workers waiting in `acquire` form a FIFO; only the
    first ELIGIBLE (not lost, not quarantined) waiter is granted, then
    rejoins the tail. Round-robin grants make fleet behavior reproducible
    enough for the fault-matrix tests without a global scheduler.

    Lock order: the coordinator lock may be held while taking the queue's
    lock (`may_produce`, `put`, `fail`), never the reverse — the queue
    calls nothing back.
    """

    def __init__(
        self,
        queue: BoundedStalenessQueue,
        batch_fn: Optional[Callable[[], object]],
        start_index: int = 0,
        config: Optional[FleetConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        faults=None,
        tracer=None,
        meter=None,
        lineage=None,
    ):
        self.cfg = config or FleetConfig()
        self._queue = queue
        self._batch_fn = batch_fn
        self._clock = clock
        self._faults = faults
        self._tracer = tracer
        self._meter = meter  # OverlapMeter: retire a lost worker's track
        # telemetry.LineageLedger: lease-grant provenance (lease/worker ids,
        # reassigned_from on a re-grant) + late-duplicate drop attribution
        self._lineage = lineage
        self._cond = make_condition("fleet.coordinator")
        self._workers: dict[int, _WorkerRecord] = {}
        self._waiters: list[int] = []
        self._leases: dict[int, Lease] = {}
        self._reassign: collections.deque[Lease] = collections.deque()
        self._cursor = start_index     # next index to draw/grant
        self._next_emit = start_index  # next index to enter the queue
        self._ready: dict[int, QueuedSample] = {}
        self._done: set[int] = set()   # completed but not yet emitted
        self._lease_seq = 0
        # fencing: highest lease epoch granted per rollout index (pruned a
        # fixed window behind the emit cursor, so late-landing completions
        # of recently emitted indices still get fenced attribution)
        self._index_epoch: dict[int, int] = {}
        self._transport_name = "inprocess"
        self._transport_info: Optional[Callable[[], dict]] = None
        self._ewma_s = 0.0             # fleet-wide sample latency
        self._rng = random.Random(self.cfg.seed)
        self._closed = False
        self.exhausted = False
        self.last_error: Optional[BaseException] = None
        self.gate_wait_s = 0.0         # cumulative worker wait in acquire
        self.counters = {k: 0 for k in _COUNTERS}

    # ---------------------------------------------------------------- #
    # membership
    # ---------------------------------------------------------------- #

    def register_worker(self, worker_id: int,
                        alive_fn: Optional[Callable[[], bool]] = None):
        with self._cond:
            self._workers[worker_id] = _WorkerRecord(
                worker_id, alive_fn=alive_fn, last_heartbeat=self._clock()
            )
            self.counters["worker_joins"] += 1
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant("fleet.join", worker=worker_id)
            self._cond.notify_all()

    def deregister_worker(self, worker_id: int):
        """Graceful leave (elastic scale-down): revoke + reassign the
        worker's leases; not counted as a loss, but the exhaustion check
        still fires if this was the last member."""
        with self._cond:
            rec = self._workers.get(worker_id)
            if rec is None or rec.lost:
                return
            rec.lost = True
            self._revoke_worker_leases_locked(worker_id)
            if self._meter is not None:
                self._meter.retire_gen_track(worker_id)
            self._check_exhausted_locked()
            self._cond.notify_all()

    def drain_worker(self, worker_id: int) -> bool:
        """Stop granting this worker new leases; its in-flight leases keep
        running to completion (the first half of drain-then-remove —
        wait_drained + deregister_worker finish the job). Returns False
        for an unknown/lost worker."""
        with self._cond:
            rec = self._workers.get(worker_id)
            if rec is None or rec.lost:
                return False
            rec.draining = True
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant("fleet.drain", worker=worker_id)
            self._cond.notify_all()
            return True

    def wait_drained(self, worker_id: int, timeout: float = 30.0) -> bool:
        """Block until the worker holds no live lease (all completed or
        revoked) or `timeout` real seconds pass. `complete()` prunes done
        leases and notifies, so this wakes promptly."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while any(l.worker_id == worker_id and not l.revoked
                      for l in self._leases.values()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining,
                                            self.cfg.poll_interval))
                self._poll_locked()
            return True

    def live_worker_ids(self) -> list:
        """Ids of members that have not left/been lost (draining workers
        still count — they hold capacity until deregistered)."""
        with self._cond:
            return sorted(wid for wid, rec in self._workers.items()
                          if not rec.lost)

    def heartbeat(self, worker_id: int):
        with self._cond:
            rec = self._workers.get(worker_id)
            if rec is not None:
                rec.last_heartbeat = self._clock()

    def set_transport(self, name: str,
                      info_fn: Optional[Callable[[], dict]] = None):
        """Register the transport's identity + stats provider. `info_fn`
        (e.g. FleetRpcServer.transport_info) is called under the
        coordinator lock from stats()/snapshot(); it must only take the
        transport's own lock and never call back into the coordinator."""
        with self._cond:
            self._transport_name = name
            self._transport_info = info_fn

    @property
    def current_epoch(self) -> int:
        """Highest lease epoch granted so far (the fencing high-water
        mark a reconnecting worker learns in the hello handshake)."""
        with self._cond:
            return self._lease_seq

    def kick(self):
        """Wake acquire-waiters (a publish or skip-credit may have opened
        the staleness gate)."""
        with self._cond:
            self._cond.notify_all()

    # ---------------------------------------------------------------- #
    # lease lifecycle (worker side)
    # ---------------------------------------------------------------- #

    def acquire(self, worker_id: int, stop: threading.Event
                ) -> Optional[Lease]:
        """Block until this worker is granted a lease; None on stop/close/
        deregistration. Wait time accumulates into `gate_wait_s` — the
        fleet's analogue of the producer staleness-gate wait."""
        with self._cond:
            if worker_id not in self._waiters:
                self._waiters.append(worker_id)
            try:
                while not stop.is_set() and not self._closed:
                    self._poll_locked()
                    rec = self._workers.get(worker_id)
                    if rec is None or rec.lost:
                        return None
                    now = self._clock()
                    if (rec.quarantined_until <= now
                            and self._head_waiter_locked(now) == worker_id):
                        lease = self._next_work_locked(worker_id, now)
                        if lease is not None:
                            self._waiters.remove(worker_id)
                            self._cond.notify_all()
                            return lease
                    t0 = time.perf_counter()
                    self._cond.wait(timeout=self.cfg.poll_interval)
                    self.gate_wait_s += time.perf_counter() - t0
                return None
            finally:
                if worker_id in self._waiters and (
                        stop.is_set() or self._closed
                        or worker_id not in self._workers
                        or self._workers[worker_id].lost):
                    self._waiters.remove(worker_id)

    def acquire_nowait(self, worker_id: int
                       ) -> tuple[Optional[Lease], bool]:
        """One non-blocking grant attempt for a REMOTE worker (the RPC
        server answers `acquire` ops with this; the client polls). Returns
        (lease, stopped): lease is None when nothing is grantable right
        now, stopped=True tells the worker to exit its loop. FIFO fairness
        is preserved — a polling remote worker holds its waiter slot
        between attempts exactly like a blocked in-process one."""
        with self._cond:
            self._poll_locked()
            rec = self._workers.get(worker_id)
            if self._closed or rec is None or rec.lost:
                if worker_id in self._waiters:
                    self._waiters.remove(worker_id)
                return None, True
            if worker_id not in self._waiters:
                self._waiters.append(worker_id)
            now = self._clock()
            if (rec.quarantined_until <= now
                    and self._head_waiter_locked(now) == worker_id):
                lease = self._next_work_locked(worker_id, now)
                if lease is not None:
                    self._waiters.remove(worker_id)
                    self._cond.notify_all()
                    return lease, False
            # the remote worker sleeps its poll interval client-side; that
            # wait is this fleet's staleness-gate wait
            self.gate_wait_s += self.cfg.poll_interval
            return None, self._closed

    def _head_waiter_locked(self, now: float) -> Optional[int]:
        for wid in self._waiters:
            rec = self._workers.get(wid)
            if rec is None or rec.lost or rec.draining:
                continue
            if rec.quarantined_until > now:
                continue
            return wid
        return None

    def _next_work_locked(self, worker_id: int, now: float
                          ) -> Optional[Lease]:
        # 1) reassignment pool first (oldest revoked work carries the
        #    lowest indices — the consumer is blocked on exactly those)
        while self._reassign:
            old = self._reassign.popleft()
            offsets = [o for o in range(len(old))
                       if not self._index_done_locked(old.start + o)]
            if not offsets:
                continue  # fully completed by a speculative peer meanwhile
            lease = self._grant_locked(
                worker_id, old.start, old.batches, now,
                reassigned_from=old.worker_id,
            )
            self.counters["reassigned_leases"] += 1
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant(
                    "fleet.reassign", worker=worker_id,
                    from_worker=old.worker_id, start=old.start,
                    length=len(old),
                )
            return lease
        # 2) new indices from the cursor, as many as the staleness gate
        #    admits up to lease_size
        if self._batch_fn is None:
            return None
        n = 0
        while (n < self.cfg.lease_size
               and self._queue.may_produce(self._cursor + n)):
            n += 1
        if n == 0:
            return None
        try:
            if self._faults is not None:
                # generic producer fault site — BEFORE the data iterator is
                # touched, same contract as the single-producer loop
                self._faults.fire("rollout.produce")
            batches = [self._batch_fn() for _ in range(n)]
        except BaseException as e:
            # the data source (or an injected produce fault) failed: this is
            # a COORDINATOR death, not a worker death — surface it to the
            # consumer through the queue so the watchdog restarts the fleet
            self.last_error = e
            self._closed = True
            self._queue.fail(e)
            self._cond.notify_all()
            return None
        lease = self._grant_locked(worker_id, self._cursor, batches, now)
        self._cursor += n
        return lease

    def _grant_locked(self, worker_id: int, start: int, batches: list,
                      now: float, reassigned_from: Optional[int] = None
                      ) -> Lease:
        self._lease_seq += 1
        deadline = now + self._deadline_s(len(batches))
        lease = Lease(
            lease_id=self._lease_seq, worker_id=worker_id, start=start,
            batches=batches, issued_at=now, deadline=deadline,
            reassigned_from=reassigned_from, epoch=self._lease_seq,
        )
        self._leases[lease.lease_id] = lease
        self.counters["leases_granted"] += 1
        for o in range(len(batches)):
            # fencing high-water mark: a re-grant raises the bar, and any
            # completion still carrying the old epoch is rejected
            idx = start + o
            if lease.epoch > self._index_epoch.get(idx, 0):
                self._index_epoch[idx] = lease.epoch
        if self._lineage is not None and self._lineage.enabled:
            # one lease event per covered index: the chain for a rollout
            # index joins on rollout_index, and a reassigned lease's second
            # event carries BOTH worker ids (worker_id + reassigned_from)
            for o in range(len(batches)):
                self._lineage.lease(
                    start + o, lease_id=lease.lease_id, worker_id=worker_id,
                    reassigned_from=reassigned_from, cursor=start + o,
                    length=len(batches), transport=self._transport_name,
                    epoch=lease.epoch,
                )
        return lease

    def _deadline_s(self, length: int) -> float:
        if self._ewma_s <= 0.0:
            return self.cfg.initial_deadline_s
        return self.cfg.straggler_factor * self._ewma_s * max(1, length)

    # ---------------------------------------------------------------- #
    # completion / failure (worker side)
    # ---------------------------------------------------------------- #

    def _index_done_locked(self, index: int) -> bool:
        return index < self._next_emit or index in self._done

    def index_done(self, index: int) -> bool:
        with self._cond:
            return self._index_done_locked(index)

    def lease_revoked(self, lease: Lease) -> bool:
        with self._cond:
            return lease.revoked

    def lease_by_id(self, lease_id: int) -> Optional[Lease]:
        """The live lease with this id, or None if completed/revoked and
        pruned (the RPC server resolves completion/failure reports that
        arrive carrying only the id)."""
        with self._cond:
            return self._leases.get(lease_id)

    def lease_active(self, lease_id: int) -> bool:
        with self._cond:
            return lease_id in self._leases

    def complete(self, worker_id: int, lease: Lease, index: int,
                 sample: QueuedSample) -> bool:
        """Record a device-ready sample. A completion commits only when it
        is the first for its index AND carries the highest epoch granted
        for that index (the fencing token): a revoked holder — straggler
        or partitioned worker — cannot commit after its re-dispatch was
        granted, regardless of arrival order. Rejected completions return
        False; accepted samples enter the queue strictly in index order
        via the reorder buffer."""
        with self._cond:
            now = self._clock()
            rec = self._workers.get(worker_id)
            latency = max(0.0, sample.ready_time - sample.dispatch_time)
            if rec is not None:
                rec.last_heartbeat = now
                rec.samples += 1
                rec.consecutive_failures = 0
                rec.ewma_s = latency if rec.samples == 1 else (
                    self.cfg.ewma_alpha * latency
                    + (1 - self.cfg.ewma_alpha) * rec.ewma_s
                )
            self._ewma_s = latency if self._ewma_s <= 0.0 else (
                self.cfg.ewma_alpha * latency
                + (1 - self.cfg.ewma_alpha) * self._ewma_s
            )
            epoch = getattr(lease, "epoch", 0)
            granted = self._index_epoch.get(index)
            fenced = granted is not None and 0 < epoch < granted
            if fenced or self._index_done_locked(index):
                self.counters["duplicate_samples"] += 1
                if fenced:
                    self.counters["fenced_completions"] += 1
                if self._lineage is not None:
                    # a revoked/straggling holder's result losing to its
                    # replacement: the SAMPLES are not lost (the winner's
                    # are trained on) — the duplicate batch is what hits
                    # the floor. `fenced` marks epoch rejections (the
                    # partition case) vs plain arrival-order losses.
                    self._lineage.drop(
                        index, "fleet_late_duplicate", worker_id=worker_id,
                        lease_id=lease.lease_id, fenced=fenced, epoch=epoch,
                    )
                self._cond.notify_all()
                return False
            self._done.add(index)
            self._ready[index] = sample
            while self._next_emit in self._ready:
                self._queue.put(self._ready.pop(self._next_emit))
                self._done.discard(self._next_emit)
                # keep a trailing window of epochs so late completions of
                # just-emitted indices still get fenced attribution
                self._index_epoch.pop(self._next_emit - 1024, None)
                self._next_emit += 1
            # sweep EVERY fully-completed lease, not just the one this
            # completion belongs to: after a speculative re-dispatch the
            # same indices live on two leases, and the one whose worker
            # skipped all already-done offsets never calls complete() — a
            # survivor would later "expire" and charge a phantom failure
            # to the innocent replacement worker
            self._prune_done_leases_locked()
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.counter(
                    "orchestrator/queue_depth", self._queue.depth()
                )
            self._cond.notify_all()
            return True

    def worker_failed(self, worker_id: int, lease: Optional[Lease],
                      exc: BaseException, fatal: bool = False):
        """In-band failure report. Recoverable failures charge the
        consecutive-failure budget (quarantine past it); fatal ones remove
        the worker from membership. Either way the lease's incomplete
        indices go back to the reassignment pool."""
        with self._cond:
            self.last_error = exc
            self.counters["worker_failures"] += 1
            rec = self._workers.get(worker_id)
            if lease is not None:
                self._revoke_locked(lease)
            if rec is not None and not rec.lost:
                if fatal:
                    self._mark_lost_locked(rec)
                else:
                    self._charge_failure_locked(rec)
            self._check_exhausted_locked()
            self._cond.notify_all()

    def _charge_failure_locked(self, rec: _WorkerRecord):
        rec.consecutive_failures += 1
        if rec.consecutive_failures > self.cfg.failure_budget:
            rec.quarantines += 1
            rec.consecutive_failures = 0  # fresh budget after re-admission
            delay = backoff_delay(
                rec.quarantines - 1, self.cfg.quarantine_base,
                self.cfg.quarantine_max, jitter=self.cfg.backoff_jitter,
                rng=self._rng,
            )
            rec.quarantined_until = self._clock() + delay
            self.counters["quarantines"] += 1
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant(
                    "fleet.quarantine", worker=rec.worker_id,
                    backoff_s=round(delay, 3),
                )

    def _mark_lost_locked(self, rec: _WorkerRecord):
        rec.lost = True
        self.counters["worker_losses"] += 1
        self._revoke_worker_leases_locked(rec.worker_id)
        if self._meter is not None:
            self._meter.retire_gen_track(rec.worker_id)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant("fleet.lost", worker=rec.worker_id)

    def _revoke_worker_leases_locked(self, worker_id: int):
        for lease in [l for l in self._leases.values()
                      if l.worker_id == worker_id]:
            self._revoke_locked(lease)

    def _revoke_locked(self, lease: Lease):
        lease.revoked = True
        self._leases.pop(lease.lease_id, None)
        if any(not self._index_done_locked(lease.start + o)
               for o in range(len(lease))):
            self._reassign.append(lease)

    def _check_exhausted_locked(self):
        live = [r for r in self._workers.values() if not r.lost]
        if self._workers and not live and not self.exhausted:
            self.exhausted = True
            self._queue.fail(FleetExhausted(
                f"all {len(self._workers)} rollout workers lost"
            ))

    # ---------------------------------------------------------------- #
    # liveness / straggler sweep
    # ---------------------------------------------------------------- #

    def poll(self):
        with self._cond:
            self._poll_locked()

    def _prune_done_leases_locked(self):
        for lease in list(self._leases.values()):
            if all(self._index_done_locked(lease.start + o)
                   for o in range(len(lease))):
                self._leases.pop(lease.lease_id, None)

    def _poll_locked(self):
        now = self._clock()
        self._prune_done_leases_locked()
        for lease in list(self._leases.values()):
            if now <= lease.deadline:
                continue
            rec = self._workers.get(lease.worker_id)
            alive = rec is not None and rec.alive(
                now, self.cfg.worker_timeout_s
            )
            self.counters["expired_leases"] += 1
            if alive:
                # straggler (or hang): revoke + re-dispatch speculatively.
                # The original worker's in-flight result is still accepted
                # if it lands before the replacement's (dedupe in complete);
                # chronic expiry WITHOUT completions walks the worker into
                # quarantine — a completed sample resets the streak.
                self.counters["speculative_dispatches"] += 1
                self._revoke_locked(lease)
                if rec is not None:
                    self._charge_failure_locked(rec)
                if self._tracer is not None and self._tracer.enabled:
                    self._tracer.instant(
                        "fleet.lease_expired", worker=lease.worker_id,
                        start=lease.start, speculative=True,
                    )
            else:
                self._revoke_locked(lease)
                if rec is not None and not rec.lost:
                    self._mark_lost_locked(rec)
        self._check_exhausted_locked()

    # ---------------------------------------------------------------- #
    # consumer-side introspection / persistence
    # ---------------------------------------------------------------- #

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> dict:
        """Flat numeric snapshot for the `fleet/*` metric rows
        (docs/METRICS.md). Transport counters (rpc_retries, heartbeat
        misses, ...) are always present — zero under InProcessTransport,
        live values once a network transport registers its provider."""
        with self._cond:
            now = self._clock()
            live = [r for r in self._workers.values() if not r.lost]
            transport = {k: 0.0 for k in _TRANSPORT_COUNTERS}
            if self._transport_info is not None:
                info = self._transport_info()
                for k, v in (info.get("counters") or {}).items():
                    if k in transport:
                        transport[k] = float(v)
            return {
                "workers": float(len(live)),
                "workers_quarantined": float(sum(
                    1 for r in live if r.quarantined_until > now
                )),
                "leases_active": float(len(self._leases)),
                **{k: float(v) for k, v in self.counters.items()},
                **transport,
            }

    def snapshot(self) -> dict:
        """Structured membership + lease table for the status exporter's
        /statusz (telemetry/exporter.py) — the human-readable companion to
        the flat `stats()` gauges: who is in the fleet, who is quarantined
        or lost, and which leases are in flight against what deadline."""
        with self._cond:
            now = self._clock()
            per_worker: dict = {}
            if self._transport_info is not None:
                per_worker = self._transport_info().get("per_worker") or {}
            return {
                "transport": self._transport_name,
                "workers": [
                    {
                        "worker_id": r.worker_id,
                        "lost": r.lost,
                        "quarantined": r.quarantined_until > now,
                        "quarantined_for_s": max(
                            0.0, round(r.quarantined_until - now, 3)
                        ),
                        "consecutive_failures": r.consecutive_failures,
                        "quarantines": r.quarantines,
                        "samples": r.samples,
                        "ewma_s": round(r.ewma_s, 4),
                        "heartbeat_age_s": round(now - r.last_heartbeat, 3),
                        # per-worker transport state: connection phase, RTT,
                        # retries, last fencing epoch seen (rpc); in-process
                        # workers are trivially "connected"
                        "transport": per_worker.get(
                            r.worker_id, {"state": "connected"}
                        ),
                    }
                    for r in self._workers.values()
                ],
                "leases": [
                    {
                        "lease_id": l.lease_id,
                        "worker_id": l.worker_id,
                        "start": l.start,
                        "batches": len(l),
                        "age_s": round(now - l.issued_at, 3),
                        "deadline_in_s": round(l.deadline - now, 3),
                        "reassigned_from": l.reassigned_from,
                        "epoch": l.epoch,
                    }
                    for l in self._leases.values()
                ],
                "counters": dict(self.counters),
            }

    def journal(self) -> dict:
        """JSON-able coordinator state for trainer_state.json. Granted-but-
        unemitted indices are informational (resume re-draws them from the
        consumed-rollout cursor, exactly like the queue's pending list);
        the counters seed a rebuilt fleet so the fleet/* metric series
        stays continuous across restart/degrade/resume."""
        with self._cond:
            pending = sorted(
                set(range(self._next_emit, self._cursor)) - set(self._ready)
            )
            return {
                "cursor": self._cursor,
                "next_emit": self._next_emit,
                "pending": pending,
                "quarantined_workers": [
                    r.worker_id for r in self._workers.values()
                    if not r.lost and r.quarantined_until > self._clock()
                ],
                "counters": dict(self.counters),
            }

    def restore_counters(self, journal: dict):
        """Seed cumulative counters from a saved journal (fresh fleets —
        rebuilt after watchdog restart or checkpoint resume — must not zero
        the fleet/* series). Cursor/membership are NOT restored: a new
        fleet re-draws from the consumed-rollout cursor with fresh
        workers."""
        with self._cond:
            for k, v in (journal.get("counters") or {}).items():
                if k in self.counters:
                    self.counters[k] = int(v)


# --------------------------------------------------------------------- #
# transport seam + in-process worker
# --------------------------------------------------------------------- #


class FleetTransport:
    """What a rollout worker needs from the outside world. The in-process
    implementation below closes over host objects; a multi-host backend
    implements the same three calls over the network (dispatch on the
    remote pod's mesh, heartbeat/completions over RPC, weights via
    device-to-device broadcast from the store) without the coordinator or
    the worker loop changing."""

    def fetch_weights(self, worker_id: int, stop=None):
        """-> (version, param_tree) of the newest published policy."""
        raise NotImplementedError

    def poll_weights(self, worker_id: int, have_version: int, stop=None):
        """Non-blocking in-flight swap check (docs/ORCHESTRATOR.md
        §in-flight swaps): -> (version, tree|None), tree None when nothing
        newer than `have_version` is published. Unlike `fetch_weights`
        this NEVER waits and never fires the worker.fetch_weights fault —
        it runs inside the decode loop's host sync window, where a stall
        is generator idle time. Base implementation: swaps unsupported,
        always (have_version, None)."""
        return have_version, None

    def heartbeat(self, worker_id: int) -> None:
        raise NotImplementedError

    def dispatch(self, worker_id: int, index: int, queries, tree,
                 weight_refresh=None):
        """Run generation for rollout `index`; returns a DEVICE-READY
        payload (the transport owns the block_until_ready).
        `weight_refresh` (optional `() -> (version, tree|None)`) is the
        in-flight swap callback threaded down to the decode driver; the
        transport forwards it to the dispatch closure only when set, so
        4-arg dispatch_fn signatures keep working with swaps off."""
        raise NotImplementedError


class InProcessTransport(FleetTransport):
    """Thread-worker transport: direct calls into the trainer's dispatch
    closure and the shared weight store."""

    def __init__(self, store: VersionedWeightStore,
                 coordinator: FleetCoordinator,
                 dispatch_fn: Callable[[int, object, dict, int], dict],
                 faults=None, weight_timeout: Optional[float] = None):
        self._store = store
        self._coord = coordinator
        self._dispatch_fn = dispatch_fn
        self._faults = faults
        self._weight_timeout = weight_timeout

    def fetch_weights(self, worker_id: int, stop=None):
        if self._faults is not None:
            self._faults.fire("worker.fetch_weights", worker=worker_id)
        # wait_for_version: a worker that joins before publish-0 blocks here
        # instead of crash-looping latest()'s RuntimeError into quarantine
        return self._store.wait_for_version(
            0, timeout=self._weight_timeout, stop=stop
        )

    def poll_weights(self, worker_id: int, have_version: int, stop=None):
        # direct non-blocking store read; deliberately NOT the
        # worker.fetch_weights fault site (that models the per-lease
        # blocking fetch) — the in-flight path has its own swap.stale site
        # fired by make_swap_refresh at install time
        v = self._store.version
        if v < 0 or v <= have_version:
            return max(v, have_version), None
        return self._store.latest()

    def heartbeat(self, worker_id: int) -> None:
        self._coord.heartbeat(worker_id)

    def dispatch(self, worker_id: int, index: int, queries, tree,
                 weight_refresh=None):
        if weight_refresh is not None:
            payload = self._dispatch_fn(
                index, queries, tree, worker_id, weight_refresh
            )
        else:
            payload = self._dispatch_fn(index, queries, tree, worker_id)
        device_ready(payload)
        return payload


class RolloutWorker:
    """One in-process fleet worker thread."""

    def __init__(self, worker_id: int, coordinator: FleetCoordinator,
                 transport: FleetTransport, meter=None, faults=None,
                 tracer=None, lineage=None, latency=None,
                 inflight_swaps: bool = False, device=None):
        self.worker_id = worker_id
        # the card the worker generates on: its thread runs under a CUDA
        # stream of its own there (None: the caller's default)
        self._device = device
        self._coord = coordinator
        self._transport = transport
        self._meter = meter
        self._faults = faults
        self._tracer = tracer
        self._lineage = lineage
        # in-flight mid-sequence weight swaps (docs/ORCHESTRATOR.md
        # §in-flight swaps): each dispatch gets a refresh callback that
        # polls the transport for newer weights at the decode loop's host
        # sync points, seeded with the dispatch version so the first poll
        # is a no-op unless a publish landed after fetch_weights
        self._inflight_swaps = bool(inflight_swaps)
        # telemetry.LatencyHub: dispatch→device-ready per generation —
        # the fleet's generation-wall + TTFT-upper-bound sketches. All
        # workers share ONE hub: its histograms are mergeable, but
        # in-process threads can simply record centrally.
        self._latency = latency
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-worker-{worker_id}",
        )

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout=timeout)

    def alive(self) -> bool:
        # registered before start(): not-yet-started counts as alive
        return self._thread.ident is None or self._thread.is_alive()

    # ---------------------------------------------------------------- #

    def _run(self):
        lease: Optional[Lease] = None
        try:
            with producer_stream(self._device):
                while not self._stop.is_set():
                    lease = self._coord.acquire(self.worker_id, self._stop)
                    if lease is None:
                        return  # stopped / closed / deregistered / lost
                    self._run_lease(lease)
                    lease = None
        except BaseException as e:
            # worker.crash lands here: the thread dies like a preempted
            # host would, after one in-band report so the fault matrix is
            # deterministic (a silent thread death is ALSO handled — the
            # liveness probe marks the worker lost at the next poll)
            self._coord.worker_failed(self.worker_id, lease, e, fatal=True)

    def _run_lease(self, lease: Lease):
        from nanorlhf_tpu_torch.resilience.faults import InjectedFault

        for offset in range(len(lease)):
            index = lease.start + offset
            if self._stop.is_set() or self._coord.lease_revoked(lease):
                return
            if self._coord.index_done(index):
                continue  # a speculative peer already delivered this index
            self._transport.heartbeat(self.worker_id)
            try:
                if self._faults is not None:
                    self._faults.fire("worker.crash", worker=self.worker_id)
                    act = self._faults.fire(
                        "worker.hang", worker=self.worker_id
                    )
                    if act == "hang":
                        # stall holding the lease until its deadline revokes
                        # it (or shutdown) — the straggler/hang fault shape
                        while not (self._stop.is_set()
                                   or self._coord.lease_revoked(lease)):
                            time.sleep(0.01)
                        return
                    act = self._faults.fire(
                        "worker.slow", worker=self.worker_id
                    )
                    if act is not None and act.startswith("delay:"):
                        self._sleep_interruptible(
                            float(act.split(":", 1)[1]), lease
                        )
                version, tree = self._transport.fetch_weights(
                    self.worker_id, stop=self._stop
                )
                tr = self._tracer
                span = (
                    tr.span("rollout.generate", rollout_index=index,
                            policy_version=version, worker=self.worker_id,
                            lease=lease.lease_id)
                    if tr is not None and tr.enabled else _null_ctx()
                )
                # monotonic: [t0, t1] feeds the straggler-deadline latency
                # EWMA (via QueuedSample dispatch/ready stamps) and the
                # overlap meter — an NTP step across a wall-clock window
                # would corrupt both. Same clock as the consumer's busy
                # windows and the queue's transit stamps. (Cross-host
                # transports must measure latency on ONE host's clock —
                # these stamps are taken coordinator-side, so that holds.)
                refresh = None
                if self._inflight_swaps:
                    refresh = make_swap_refresh(
                        lambda have: self._transport.poll_weights(
                            self.worker_id, have, stop=self._stop
                        ),
                        have_version=version, faults=self._faults,
                        worker=self.worker_id,
                    )
                t0 = time.perf_counter()
                with span:
                    payload = self._transport.dispatch(
                        self.worker_id, index, lease.batches[offset], tree,
                        weight_refresh=refresh,
                    )
                t1 = time.perf_counter()
                if self._meter is not None:
                    self._meter.note_gen(t0, t1, track=self.worker_id)
                if self._latency is not None and self._latency.enabled:
                    # one pair per generation event: keeps the TTFT
                    # sketch's _count equal to the ledger's generation-
                    # event count (the monolithic sampler is one jit, so
                    # dispatch→ready is the TTFT upper bound here)
                    self._latency.record("latency/generation_s", t1 - t0)
                    self._latency.record("latency/ttft_s", t1 - t0)
                if self._lineage is not None and self._lineage.enabled:
                    self._lineage.generation(
                        index, policy_version=version,
                        worker_id=self.worker_id, lease_id=lease.lease_id,
                        gen_s=round(t1 - t0, 6), spec=spec_summary(payload),
                        segments=segments_summary(payload),
                        swap_wait_s=payload.get("swap_wait_s"),
                    )
                self._coord.complete(
                    self.worker_id, lease, index,
                    QueuedSample(index, version, payload, t0, t1),
                )
            except InjectedFault as e:
                if e.point == "worker.crash":
                    raise  # fatal: the outer handler reports + thread dies
                self._coord.worker_failed(self.worker_id, lease, e)
                return
            except Exception as e:
                # organic dispatch/weight failure: recoverable — charge the
                # quarantine budget, surrender the lease, take the next one
                self._coord.worker_failed(self.worker_id, lease, e)
                return

    def _sleep_interruptible(self, seconds: float, lease: Lease):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if self._stop.is_set():
                return
            time.sleep(min(0.01, max(0.0, deadline - time.monotonic())))


def _null_ctx():
    import contextlib

    return contextlib.nullcontext()


# --------------------------------------------------------------------- #
# consumer-facing shell (RolloutOrchestrator-compatible surface)
# --------------------------------------------------------------------- #


class FleetOrchestrator:
    """N-worker drop-in for RolloutOrchestrator.

    `dispatch_fn(index, queries, params_tree, worker_id) -> payload`
    async-dispatches generation (the transport blocks until device-ready);
    `batch_fn()` draws the next prompt batch — called ONLY by the
    coordinator, under its lock, in strict index order, so the data cursor
    semantics (and the checkpoint/resume journal) are exactly the
    single-producer ones. `initial_params` becomes weight version 0.

    `transport` selects the worker↔coordinator seam: "inprocess" (direct
    calls, the default) or "rpc" (loopback FleetRpcServer + one RpcClient
    per worker — the same wire path a cross-host deployment uses, so the
    fault matrix and bit-parity tests cover the network code on CPU CI).
    `rpc` (an orchestrator.rpc.RpcConfig) carries address/timeout/retry
    knobs; None = loopback on an ephemeral port.

    `device` (a CUDA device) gives every worker thread a stream of its own
    on that card.

    `inflight_swaps=True` hands every dispatch an in-flight weight-swap
    refresh callback (weight_store.make_swap_refresh over the transport's
    non-blocking `poll_weights`): the decode driver installs mid-rollout
    publishes at its host sync points and the payload/ledger carry
    per-segment {policy_version, tok_range} provenance
    (docs/ORCHESTRATOR.md §in-flight swaps). With no mid-rollout publish
    the callback returns (version, None) every poll and the token stream
    is bit-identical to swaps off — test-pinned over both transports.
    """

    def __init__(
        self,
        dispatch_fn: Callable[[int, object, dict, int], dict],
        batch_fn: Callable[[], object],
        initial_params: dict,
        n_workers: int = 2,
        start_index: int = 0,
        max_staleness: int = 1,
        policy: str = "wait",
        meter=None,
        restore: Optional[dict] = None,
        heartbeat: float = 30.0,
        faults=None,
        tracer=None,
        fleet: Optional[FleetConfig] = None,
        lineage=None,
        transport: str = "inprocess",
        rpc=None,
        latency=None,
        inflight_swaps: bool = False,
        device=None,
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers={n_workers} must be >= 1")
        from nanorlhf_tpu_torch.orchestrator.orchestrator import OverlapMeter

        self.store = VersionedWeightStore()
        self.store.publish(initial_params)  # version 0
        self.queue = BoundedStalenessQueue(
            max_staleness, policy, start_index=start_index, lineage=lineage,
            latency=latency,
        )
        self.meter = meter if meter is not None else OverlapMeter()
        self.max_staleness = max_staleness
        self._heartbeat = heartbeat
        self._faults = faults
        self._tracer = tracer
        self._lineage = lineage
        self._latency = latency
        self._inflight_swaps = bool(inflight_swaps)
        self._device = device
        self.coordinator = FleetCoordinator(
            queue=self.queue, batch_fn=batch_fn, start_index=start_index,
            config=fleet, faults=faults, tracer=tracer, meter=self.meter,
            lineage=lineage,
        )
        if restore:
            self.queue.restore_counters(restore)
            self.coordinator.restore_counters(restore.get("fleet", {}))
        if transport not in ("inprocess", "rpc"):
            raise ValueError(
                f"transport={transport!r}: 'inprocess' | 'rpc'"
            )
        self._dispatch_fn = dispatch_fn
        self._rpc_server = None
        self._rpc_clients: list = []
        self._rpc_cfg = None
        if transport == "rpc":
            from nanorlhf_tpu_torch.orchestrator import rpc as _rpc

            self._rpc_mod = _rpc
            self._rpc_cfg = rpc if rpc is not None else _rpc.RpcConfig(
                poll_interval=self.coordinator.cfg.poll_interval
            )
            # the server registers itself as the coordinator's transport
            # stats provider (set_transport) at construction
            self._rpc_server = _rpc.FleetRpcServer(
                self.coordinator, self.store, config=self._rpc_cfg,
                faults=faults,
            )
            self.transport = None  # per-worker RpcTransport instead
        else:
            self.transport = InProcessTransport(
                self.store, self.coordinator, dispatch_fn, faults=faults
            )
        self._poll = min(heartbeat, self.coordinator.cfg.poll_interval)
        self._workers: list[RolloutWorker] = []
        self._next_worker_id = 0
        # register the WHOLE initial cohort before starting any thread: a
        # first worker fast enough to acquire + crash before the second is
        # registered would otherwise trip the all-workers-lost exhaustion
        # check against a 1-member fleet
        initial = [self._make_worker() for _ in range(n_workers)]
        for w in initial:
            w.start()

    # ---------------------------------------------------------------- #
    # elastic membership
    # ---------------------------------------------------------------- #

    def _make_worker(self) -> RolloutWorker:
        wid = self._next_worker_id
        self._next_worker_id += 1
        if self._rpc_server is not None:
            # worker side of the wire: its own client connection, a proxy
            # with the coordinator surface, and the 3-call transport —
            # the worker loop itself is identical to the in-process one
            client = self._rpc_mod.RpcClient(
                self._rpc_server.address, wid, config=self._rpc_cfg,
                faults=self._faults, latency=self._latency,
            )
            self._rpc_clients.append(client)
            coord = self._rpc_mod.RemoteCoordinator(
                client, poll_interval=self._rpc_cfg.poll_interval
            )
            transport = self._rpc_mod.RpcTransport(
                client, self._dispatch_fn
            )
        else:
            coord, transport = self.coordinator, self.transport
        w = RolloutWorker(
            wid, coord, transport, meter=self.meter,
            faults=self._faults, tracer=self._tracer, lineage=self._lineage,
            latency=self._latency, inflight_swaps=self._inflight_swaps,
            device=self._device,
        )
        # register BEFORE start: the worker's first acquire must find its
        # membership record (alive() treats not-yet-started as alive)
        self.coordinator.register_worker(wid, alive_fn=w.alive)
        self._workers.append(w)
        return w

    def add_worker(self) -> int:
        """Join a worker mid-run; returns its worker id."""
        w = self._make_worker()
        w.start()
        return w.worker_id

    def remove_worker(self, worker_id: int, drain: bool = False,
                      drain_timeout_s: float = 30.0) -> bool:
        """Leave mid-run (elastic scale-down).

        `drain=True` (what autoscaler scale-in uses): stop granting the
        worker new leases, wait for its in-flight leases to complete,
        THEN deregister — nothing is stranded and nothing needs the
        lease-expiry reassignment sweep. Falls through to the abrupt
        path if the drain times out (the reassignment machinery then
        recovers whatever was left, same as a crash).

        `drain=False` (default, kept for fault tests): immediate
        deregister — in-flight leases are revoked and reassigned.

        Returns True when the worker left cleanly drained (vacuously
        True for the abrupt path)."""
        drained = True
        if drain:
            if self.coordinator.drain_worker(worker_id):
                drained = self.coordinator.wait_drained(
                    worker_id, timeout=drain_timeout_s)
        self.coordinator.deregister_worker(worker_id)
        for w in self._workers:
            if w.worker_id == worker_id:
                w.stop()
        return drained

    # ---------------------------------------------------------------- #
    # consumer API (RolloutOrchestrator-compatible)
    # ---------------------------------------------------------------- #

    @property
    def version(self) -> int:
        return self.store.version

    def get(self) -> QueuedSample:
        """Next sample in index order. Short poll slices keep the liveness/
        deadline sweep running while the consumer waits; like the single
        producer there is NO hard deadline on a healthy slow generation
        (cold-cache compiles run minutes) — only actual fleet death raises
        (FleetExhausted via the queue, or every thread gone)."""
        while True:
            try:
                sample = self.queue.get(timeout=self._poll)
                adopt_payload(sample.payload)
                return sample
            except TimeoutError:
                self.coordinator.poll()
                if (not self.coordinator.exhausted
                        and not any(w.alive() for w in self._workers)):
                    raise ProducerFailed(
                        "every fleet worker thread died without reporting "
                        "an error through the queue"
                    ) from self.coordinator.last_error

    def producer_alive(self) -> bool:
        return any(w.alive() for w in self._workers)

    def consumed_without_update(self) -> None:
        self.queue.credit_skip()
        self.coordinator.kick()

    def publish(self, tree: dict) -> int:
        v = self.store.publish(tree)
        self.queue.advance_version(v)
        self.coordinator.kick()  # the staleness gate may have opened
        return v

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue.depth(),
            "dropped": self.queue.dropped,
            "staleness_counts": dict(self.queue.staleness_counts),
            "consumer_wait_s": self.queue.consumer_wait_s,
            # fleet workers wait in coordinator.acquire, not the queue gate
            "producer_gate_wait_s": self.coordinator.gate_wait_s,
        }

    def fleet_stats(self) -> dict:
        """fleet/* metric rows (docs/METRICS.md)."""
        return self.coordinator.stats()

    def status_snapshot(self) -> dict:
        """/statusz seam (telemetry/exporter.py): queue counters + the
        fleet membership/lease table, JSON-able and safe from any thread."""
        return {
            "queue": {**self.stats(), "version": self.version},
            "fleet": self.coordinator.snapshot(),
        }

    def journal(self) -> dict:
        return {**self.queue.journal(), "fleet": self.coordinator.journal()}

    def close(self, join_timeout: float = 30.0) -> None:
        for w in self._workers:
            w.stop()
        self.coordinator.close()
        deadline = time.monotonic() + join_timeout
        for w in self._workers:
            w.join(timeout=max(0.1, deadline - time.monotonic()))
        for c in self._rpc_clients:
            c.close()
        if self._rpc_server is not None:
            self._rpc_server.close()
