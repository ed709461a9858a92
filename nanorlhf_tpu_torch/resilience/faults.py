"""Deterministic fault injection for the resilience stack.

Every failure mode the supervision machinery handles (producer crash, NaN
step, checkpoint-write failure, preemption) must be reproducible in a unit
test — "it recovered once in prod" is not a test. The registry arms named
injection points with deterministic schedules; the hosting code calls
`injector.fire(point)` at the point and the schedule decides whether this
call fails.

Injection points (wired in trainer/checkpoint/orchestrator dispatch):

    ckpt.save        inside CheckpointManager.save's write attempt
    ckpt.restore     inside CheckpointManager.restore's read attempt
    rollout.produce  top of the orchestrator producer's dispatch closure
                     (before the data iterator is touched, so a restart
                     redraws from an unburned cursor)
    reward.exec      inside the trainer's reward-dispatch attempt
    update.step      after the jitted update's host stats land — `action=nan`
                     poisons the observed loss/grad-norm instead of raising,
                     exercising the sentinel exactly like a real NaN step

Worker-scoped points (wired in the rollout fleet's worker loop,
orchestrator/fleet.py — each selectable by worker id via `worker=I`):

    worker.crash         worker thread dies (fatal — the lease is revoked
                         and reassigned; heartbeat/membership notice it)
    worker.hang          worker stalls holding its lease until the lease
                         deadline revokes it (default action "hang")
    worker.slow          worker sleeps `delay` seconds before dispatching —
                         the straggler/speculative-re-dispatch path
                         (default action "delay")
    worker.fetch_weights worker's weight-store fetch raises (recoverable —
                         counts toward the consecutive-failure quarantine)

Network-layer points (wired inside the RpcTransport framing,
orchestrator/rpc.py — fired once per frame send on BOTH directions: the
client's request path and the server's response path, so either direction
is coverable deterministically with a `worker=I` selector):

    net.drop       the frame is not sent and the connection is closed
                   (packet loss → reset; the caller's retry/backoff path)
    net.delay      sleep `delay` seconds before the frame goes out
                   (latency spike; default action "delay")
    net.partition  the worker's link goes dead for `delay` seconds — every
                   call fails fast until it heals (lease expiry + fencing
                   path; client-side state, default action "partition")
    net.duplicate  the frame is sent twice (at-least-once delivery; the
                   receiver's seq/offset dedup must absorb it)
    net.tear       the frame is truncated mid-payload and the connection
                   closed — the receiver detects it by length+checksum
                   (recoverable, counts against the failure budget)

Environment tool points (wired around the env.step tool dispatch in
envs/rollout.py — `worker=I` selects the episode index):

    env.hang       the tool call stalls `delay` seconds before running
                   (default action "delay") — the stalled row's pages are
                   already released, so this drives the
                   release-while-stalled / re-admit path
    env.crash      the tool call raises (default "raise") — the driver
                   absorbs it into an error-text observation; the episode
                   continues, never a dead rollout

Serving-path points (wired in serving/gateway.py's streaming response
loop and loadgen/driver.py's in-process client):

    gw.disconnect  the client vanishes mid-stream (default action "drop") —
                   the gateway/driver must cancel the request so its KV
                   pages are released and in-flight counters decremented

Storage-integrity points (wired in trainer/checkpoint.py):

    ckpt.corrupt   the checkpoint selected for restore reads back
                   corrupt/torn (default action "tear") — restore falls
                   back to the newest EARLIER intact checkpoint instead of
                   failing the run, counting `resilience/ckpt_fallbacks`

In-flight weight-swap point (wired in orchestrator/weight_store.py's
make_swap_refresh, the poll callback the decode driver calls at its host
sync points — `worker=I` selects the polling worker):

    swap.stale     the swap install stalls `delay` seconds before the
                   fresh tree is handed over (default action "delay") —
                   long enough, the next publish lands during the stall
                   and the tree being installed is already superseded; the
                   NEXT sync point's poll installs the newer one, so the
                   versions recorded in the segment ledger stay strictly
                   increasing

Spec grammar (config `fault_spec` or env `NANORLHF_FAULT`; entries separated
by ";" or whitespace):

    point:key=val[,key=val...]

    at=N       fire on the N-th call to this point (1-based; fires once)
    every=K    fire on every K-th call
    prob=P     fire each call with probability P under a seeded PRNG
    seed=S     PRNG seed for prob (default 0 — always deterministic)
    count=C    cap total fires (default: 1 for `at`, unbounded otherwise)
    action=A   "raise" (default) raises InjectedFault; "nan" returns "nan"
               from fire() for the caller to poison its observed value;
               "hang"/"delay" return themselves for the fleet worker loop
               to stall on; "drop"/"partition"/"duplicate"/"tear" return
               themselves for the RPC framing to act on (worker.* and
               net.* points default to the matching action);
               "delay"/"partition" return with their duration attached
               ("delay:<s>" / "partition:<s>")
    worker=I   only fire for calls tagged with this worker id
               (`fire(point, worker=I)`); the call counter then counts
               THAT worker's calls — `at=1,worker=0` is worker 0's first
               dispatch, deterministic even though fleet workers race.
               Without `worker=`, calls from all workers share one counter
               in arrival order (nondeterministic across threads — fine
               for `every=1`, not for `at=N` assertions).
    delay=S    seconds for actions "delay" and "partition" (default 1.0)

Examples:

    NANORLHF_FAULT="ckpt.save:at=1"                 first save write fails once
    NANORLHF_FAULT="rollout.produce:every=1"        every produce attempt dies
    NANORLHF_FAULT="update.step:at=2,action=nan"    2nd update observes NaN
    NANORLHF_FAULT="worker.crash:at=1,worker=0"     worker 0 dies on 1st lease
    NANORLHF_FAULT="worker.slow:every=2,worker=1,delay=0.5"

The port's copy of `nanorlhf_tpu/resilience/faults.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import dataclasses
import os
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
from typing import Callable, Optional

import numpy as np

ENV_VAR = "NANORLHF_FAULT"

INJECTION_POINTS = frozenset({
    "ckpt.save",
    "ckpt.restore",
    "rollout.produce",
    "reward.exec",
    "update.step",
    # worker-scoped fleet sites (orchestrator/fleet.py worker loop)
    "worker.crash",
    "worker.hang",
    "worker.slow",
    "worker.fetch_weights",
    # network-layer sites (orchestrator/rpc.py framing)
    "net.drop",
    "net.delay",
    "net.partition",
    "net.duplicate",
    "net.tear",
    # environment tool sites (envs/rollout.py tool dispatch): env.hang
    # stalls the tool call (default action=delay — drives the
    # page-release-while-stalled path), env.crash raises inside it (the
    # driver absorbs it as an error-text observation)
    "env.hang",
    "env.crash",
    # serving-path site (serving/gateway.py response loop + loadgen/driver.py
    # in-process client): the client vanishes mid-stream
    "gw.disconnect",
    # storage-integrity site (trainer/checkpoint.py): the restored
    # checkpoint reads back corrupt/torn
    "ckpt.corrupt",
    # in-flight weight-swap site (orchestrator/weight_store.py
    # make_swap_refresh): the mid-rollout install stalls past the next
    # publish — the stalled tree lands already superseded and the next
    # sync point installs the newer one (ledger versions stay strictly
    # increasing)
    "swap.stale",
})

ACTIONS = ("raise", "nan", "hang", "delay",
           "drop", "partition", "duplicate", "tear")

# a bare `worker.hang:at=1` should hang, not raise — the point name IS the
# intended behavior; an explicit action= still overrides
_DEFAULT_ACTIONS = {
    "worker.hang": "hang",
    "worker.slow": "delay",
    "net.drop": "drop",
    "net.delay": "delay",
    "net.partition": "partition",
    "net.duplicate": "duplicate",
    "net.tear": "tear",
    "env.hang": "delay",
    "gw.disconnect": "drop",
    "ckpt.corrupt": "tear",
    "swap.stale": "delay",
}


class InjectedFault(RuntimeError):
    """Raised by an armed injection point. Carries the point name so
    supervision code (and test assertions) can tell injected failures from
    organic ones."""

    def __init__(self, point: str, detail: str = ""):
        self.point = point
        super().__init__(f"injected fault at {point!r}" + (f" ({detail})" if detail else ""))


@dataclasses.dataclass
class FaultSchedule:
    point: str
    at: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    seed: int = 0
    count: Optional[int] = None   # max fires; None = unbounded
    action: Optional[str] = None  # None -> point default ("raise" mostly)
    worker: Optional[int] = None  # only match calls tagged with this worker
    delay: float = 1.0            # seconds, action="delay"
    # runtime state
    calls: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; known: "
                f"{sorted(INJECTION_POINTS)}"
            )
        if self.action is None:
            self.action = _DEFAULT_ACTIONS.get(self.point, "raise")
        if self.action not in ACTIONS:
            raise ValueError(f"action={self.action!r}: {' | '.join(ACTIONS)}")
        if sum(x is not None for x in (self.at, self.every, self.prob)) != 1:
            raise ValueError(
                f"{self.point}: exactly one of at=/every=/prob= required"
            )
        if self.count is None and self.at is not None:
            self.count = 1  # "fire at step N" means once
        self._rng = np.random.default_rng(self.seed)

    def should_fire(self) -> bool:
        """Advance this schedule's call counter; True if this call fails."""
        self.calls += 1
        if self.count is not None and self.fires >= self.count:
            return False
        if self.at is not None:
            hit = self.calls == self.at
        elif self.every is not None:
            hit = self.calls % self.every == 0
        else:
            hit = bool(self._rng.random() < self.prob)
        if hit:
            self.fires += 1
        return hit


def parse_fault_spec(spec: str) -> list[FaultSchedule]:
    schedules = []
    for entry in spec.replace(";", " ").split():
        if ":" not in entry:
            raise ValueError(f"fault entry {entry!r}: expected point:key=val,...")
        point, _, kvs = entry.partition(":")
        kwargs: dict = {}
        for kv in kvs.split(","):
            if "=" not in kv:
                raise ValueError(f"fault entry {entry!r}: bad clause {kv!r}")
            k, _, v = kv.partition("=")
            if k in ("at", "every", "seed", "count", "worker"):
                kwargs[k] = int(v)
            elif k in ("prob", "delay"):
                kwargs[k] = float(v)
            elif k == "action":
                kwargs[k] = v
            else:
                raise ValueError(f"fault entry {entry!r}: unknown key {k!r}")
        schedules.append(FaultSchedule(point=point, **kwargs))
    return schedules


class FaultInjector:
    """Thread-safe registry of armed fault schedules.

    `fire(point, worker=...)` advances every schedule armed on `point`
    (schedules carrying a `worker` selector only when the tag matches);
    when one triggers with action "raise" it raises InjectedFault, with
    action "nan" it returns "nan" for the caller to poison its observation,
    with "hang" it returns "hang", and with "delay" it returns
    "delay:<seconds>" for the fleet worker loop to stall on. Returns None
    when nothing fires — the disarmed fast path is one dict lookup, so
    production code leaves the calls in unconditionally.

    `on_fire(point, worker, outcome)` — when set — observes every fire
    (outcome is the action string, or "raise" for raising fires) AFTER the
    registry lock is released, so the hook may take other declared locks
    (the chaos harness journals fires into the lineage ledger here)."""

    def __init__(self, schedules: Optional[list[FaultSchedule]] = None):
        self._lock = make_lock("resilience.faults")
        self._by_point: dict[str, list[FaultSchedule]] = {}
        self.on_fire: Optional[Callable[[str, Optional[int], str], None]] = None
        for s in schedules or []:
            self._by_point.setdefault(s.point, []).append(s)

    @classmethod
    def from_spec(cls, spec: Optional[str] = None) -> "FaultInjector":
        """Build from an explicit spec string, falling back to the
        NANORLHF_FAULT env var; empty/None spec arms nothing."""
        spec = spec if spec is not None else os.environ.get(ENV_VAR)
        return cls(parse_fault_spec(spec) if spec else None)

    @property
    def armed(self) -> bool:
        return bool(self._by_point)

    def fire(self, point: str, worker: Optional[int] = None) -> Optional[str]:
        schedules = self._by_point.get(point)
        if not schedules:
            return None
        fired: Optional[tuple[str, str]] = None  # (outcome tag, detail)
        with self._lock:
            for s in schedules:
                if s.worker is not None and s.worker != worker:
                    continue  # call not tagged for this schedule's worker
                if s.should_fire():
                    if s.action == "raise":
                        detail = f"call {s.calls}" + (
                            f" worker {worker}" if worker is not None else ""
                        )
                        fired = ("raise", detail)
                    elif s.action in ("delay", "partition"):
                        # these carry their duration parameter through
                        fired = (f"{s.action}:{s.delay}", "")
                    else:
                        fired = (s.action, "")
                    break
        if fired is None:
            return None
        outcome, detail = fired
        hook = self.on_fire
        if hook is not None:
            try:
                hook(point, worker, outcome)
            except Exception:
                pass  # observation must never change fault semantics
        if outcome == "raise":
            raise InjectedFault(point, detail=detail)
        return outcome

    def stats(self) -> dict:
        """{point: {"calls": n, "fires": m}} — test/debug introspection."""
        with self._lock:
            out: dict = {}
            for point, schedules in self._by_point.items():
                out[point] = {
                    "calls": sum(s.calls for s in schedules),
                    "fires": sum(s.fires for s in schedules),
                }
            return out
