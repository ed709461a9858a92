"""Declared lock partial order + runtime lock-order sanitizer.

Five threaded subsystems (fleet coordinator, rpc server/client, sample
queue, health monitor, exporter/metrics) share locks whose nesting was
previously a set of per-module docstring conventions ("the coordinator
lock may be held while taking the queue's lock, never the reverse").
This module makes the convention executable in both directions:

- ``LOCK_ORDER`` is the single declared partial order, as a tuple of
  lock names in ascending rank. A thread may acquire a lock only if its
  rank is strictly greater than every lock it already holds. The static
  analyzer (`nanorlhf_tpu.analysis.lockgraph`) checks every extracted
  acquisition edge against this same table; the two views cannot drift
  because they read the same tuple.

- ``make_lock`` / ``make_rlock`` / ``make_condition`` are drop-in
  factories for ``threading.Lock/RLock/Condition``. With
  ``NANORLHF_LOCK_CHECK=1`` in the environment they return instrumented
  ``OrderedLock`` wrappers that maintain a thread-local stack of held
  locks and raise ``LockOrderViolation`` on any out-of-order
  acquisition; otherwise they return the plain ``threading`` primitive
  with zero overhead.

Lock names not in ``LOCK_ORDER`` are a hard error at construction time
(when checking is enabled) and a `lockorder.undeclared` finding
statically — new locks must be ranked before they ship.

The port's copy of `nanorlhf_tpu/analysis/lockorder.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import os
import threading

# Ascending rank: a thread holding a lock may only acquire locks that
# appear LATER in this tuple. Derived from the audited acquisition
# edges (see docs/STATIC_ANALYSIS.md §lock-order for the edge list):
#   fleet.coordinator -> {orchestrator.queue, rpc.server,
#                         orchestrator.meter, telemetry.{lineage,tracer},
#                         resilience.faults}
#   orchestrator.queue -> telemetry.lineage
#   rpc.client -> resilience.faults
#   {orchestrator.queue, rpc.client, telemetry.health} -> telemetry.hist
#     (queue-wait / RPC-RTT recording under the holder's lock; SLO rule
#      evaluation reads hub quantiles under the health monitor's lock)
#   serving.engine -> telemetry.hist
#     (the shed check reads hub TTFT quantiles under the engine's
#      condition; serving.radix is ranked just below serving.engine so
#      an admission that ever plans under the condition stays ascending)
#   loadgen.autoscaler -> {fleet.coordinator, telemetry.{lineage,tracer}}
#     (evaluate() actuates add/remove_worker and records the decision
#      while holding the controller lock — ranked above everything)
#   loadgen.driver ranks above serving.engine/telemetry.{hist,lineage}
#     for the same reason, though the driver only guards bookkeeping
LOCK_ORDER: tuple[str, ...] = (
    "loadgen.autoscaler",     # Autoscaler._lock            (loadgen/autoscaler.py)
    "loadgen.driver",         # TrafficDriver._lock         (loadgen/driver.py)
    "fleet.coordinator",      # FleetCoordinator._cond      (fleet.py)
    "orchestrator.queue",     # BoundedStalenessQueue._cond (sample_queue.py)
    "orchestrator.weights",   # VersionedWeightStore._cond  (weight_store.py)
    "rpc.server",             # FleetRpcServer._lock        (rpc.py)
    "rpc.client",             # RpcClient._lock             (rpc.py)
    "serving.engine",         # ServingEngine._cond         (serving/engine.py)
    "serving.radix",          # RadixCache._lock            (serving/radix.py)
    "trainer.metrics",        # MetricsLogger._lock         (metrics.py)
    "telemetry.health",       # HealthMonitor._lock         (health.py)
    "telemetry.hist",         # LatencyHub._lock            (hist.py)
    "telemetry.tracer",       # SpanTracer._lock            (tracer.py)
    "telemetry.lineage",      # LineageLedger._lock         (lineage.py)
    "orchestrator.meter",     # OverlapMeter._lock          (orchestrator.py)
    "telemetry.mfu.counter",  # RecompileCounter._lock      (mfu.py)
    "telemetry.mfu.registry", # _COUNTER_LOCK               (mfu.py)
    "rewards.executor",       # PooledPythonExecutor._lock  (python_executor.py)
    "resilience.faults",      # FaultInjector._lock         (faults.py)
)

_RANK: dict[str, int] = {name: i for i, name in enumerate(LOCK_ORDER)}


def lock_rank(name: str) -> int:
    """Rank of a declared lock name; raises KeyError for undeclared names."""
    return _RANK[name]


class LockOrderViolation(RuntimeError):
    """A thread acquired a lock out of the declared LOCK_ORDER."""


class _HeldStack(threading.local):
    def __init__(self):
        self.stack: list[tuple[str, int]] = []  # (name, rank), outermost first


_held = _HeldStack()


def held_locks() -> list[str]:
    """Names of OrderedLocks held by the calling thread, outermost first."""
    return [name for name, _ in _held.stack]


class OrderedLock:
    """A Lock/RLock wrapper that asserts the declared acquisition order.

    Works as the underlying lock of a ``threading.Condition``: it
    implements ``acquire``/``release``/``_is_owned``/``locked`` and
    context-manager protocol. Reentrant acquires (RLock mode) skip the
    order check and the held-stack push — only the first acquisition of
    a lock establishes ordering constraints.
    """

    def __init__(self, name: str, *, reentrant: bool = False):
        if name not in _RANK:
            raise LockOrderViolation(
                f"lock name {name!r} is not declared in LOCK_ORDER; "
                f"rank every lock before shipping it "
                f"(see docs/STATIC_ANALYSIS.md)"
            )
        self.name = name
        self.rank = _RANK[name]
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: int | None = None
        self._count = 0

    def _check(self) -> None:
        if _held.stack:
            top_name, top_rank = _held.stack[-1]
            if top_rank >= self.rank:
                chain = " -> ".join(held_locks() + [self.name])
                raise LockOrderViolation(
                    f"lock order violation: acquiring {self.name!r} "
                    f"(rank {self.rank}) while holding {top_name!r} "
                    f"(rank {top_rank}); held chain: {chain}. Declared "
                    f"order requires strictly ascending ranks — see "
                    f"LOCK_ORDER in nanorlhf_tpu/analysis/lockorder.py"
                )

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._inner.acquire()
            self._count += 1
            return True
        self._check()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._count = 1
            _held.stack.append((self.name, self.rank))
        return got

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            raise RuntimeError(f"release of {self.name!r} by non-owner thread")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            # Pop our entry; locks are normally released LIFO but tolerate
            # out-of-order release (it is legal for plain Locks).
            for i in range(len(_held.stack) - 1, -1, -1):
                if _held.stack[i][0] == self.name:
                    del _held.stack[i]
                    break
        self._inner.release()

    # Condition() integration -------------------------------------------
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r} rank={self.rank}>"


def _enabled() -> bool:
    return os.environ.get("NANORLHF_LOCK_CHECK", "") not in ("", "0")


def make_lock(name: str):
    """A named mutex: plain ``threading.Lock`` unless NANORLHF_LOCK_CHECK=1."""
    if _enabled():
        return OrderedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A named reentrant mutex, order-checked on first acquisition only."""
    if _enabled():
        return OrderedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str):
    """A named ``threading.Condition`` whose underlying lock is ordered."""
    if _enabled():
        return threading.Condition(OrderedLock(name))
    return threading.Condition()
