"""Version-tagged policy weight store for async rollouts — the port's copy
of `nanorlhf_tpu/orchestrator/weight_store.py` (`tests/test_torch_orchestrator.py`
and `tests/test_torch_inflight_swaps.py` hold it against the original).

The synchronous trainer hands the live `self.params` tree to generation.
With a producer thread generating WHILE the consumer updates, that tree is
a moving target: the port's optimizer steps the trainable leaves IN PLACE
(`trainer/optim.py`, `p.copy_(...)`), so a generation reading the live
tree mid-update would sample from half-stepped weights.

The store decouples the two: the trainer PUBLISHES an immutable snapshot
after every optimizer update (`RLTrainer._policy_snapshot` clones every
trainable leaf on the trainer's stream and records an event after the
clones; frozen base weights are never written and stay aliased), and
rollout workers PULL the latest published version without ever blocking
the train step; a reader's stream waits on the snapshot's event before it
reads (`orchestrator.reader_wait`). Versions are monotonically increasing,
starting at 0 for the tree published at construction/creation — all
staleness arithmetic (`sample_queue`, metrics) is relative to these
version tags.

The store itself is plain host-side bookkeeping: it never touches a
tensor.
"""

from __future__ import annotations

import threading
import time

from nanorlhf_tpu_torch.analysis.lockorder import make_condition
from typing import Any, Callable, Optional


def store_poll(store: "VersionedWeightStore") -> Callable:
    """Non-blocking `poll(have) -> (version, tree|None)` reading `store`
    directly — the serial/in-process side of `make_swap_refresh`. Never
    waits: an unpublished store (version < 0) reports `(have, None)`."""
    def poll(have: int):
        v = store.version
        if v < 0 or v <= have:
            return max(v, have), None
        return store.latest()
    return poll


def make_swap_refresh(poll: Callable, *, have_version: Optional[int] = None,
                      faults=None, worker: Optional[int] = None) -> Callable:
    """Build the in-flight weight-swap callback (docs/ORCHESTRATOR.md
    §in-flight swaps) handed down to the decode drivers.

    `poll(have) -> (version, tree|None)` is the transport-specific
    non-blocking check (`store_poll` for direct store readers, the fleet
    transports' `poll_weights` otherwise — the RPC client's version cache
    makes an unchanged-policy poll one tiny have_version round trip).

    The returned `refresh() -> (version, tree|None)` is what the queued
    scheduler / env episode driver calls at each host sync point: `tree`
    is None when the held version is still the newest (install nothing),
    otherwise the fresh param tree to install before the next decode
    chunk. `have_version=None` (the serial path, where the dispatch
    closure does not know which version it was handed) makes the FIRST
    call return the store's latest outright — the caller installs it
    pre-loop without counting a swap.

    When a newer tree is about to be handed over, the `swap.stale` fault
    site fires (docs/RESILIENCE.md): the default `delay` action sleeps
    first and installs anyway — deliberately landing a version that may
    already be superseded; the next sync point then installs the newer
    one, so the ledger's per-segment versions stay strictly increasing.
    """
    state = {"v": have_version}

    def refresh():
        have = state["v"]
        version, tree = poll(-1 if have is None else have)
        if tree is None or (have is not None and version <= have):
            return (version if have is None else max(version, have)), None
        if faults is not None:
            act = faults.fire("swap.stale", worker=worker)
            if act and str(act).startswith("delay:"):
                time.sleep(float(str(act).split(":", 1)[1]))
        state["v"] = version
        return version, tree

    return refresh


class VersionedWeightStore:
    """Thread-safe {version -> param tree} holder keeping only the latest.

    `publish(tree)` tags `tree` with the next version and makes it the one
    `latest()` returns; the previous snapshot is dropped (rollout dispatch
    always wants the freshest policy — a sample's version tag, not the
    store, remembers which weights generated it).
    """

    def __init__(self):
        self._cond = make_condition("orchestrator.weights")
        self._version = -1
        self._tree: Any = None

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    def publish(self, tree: Any) -> int:
        """Store `tree` as the new latest snapshot; returns its version."""
        with self._cond:
            self._version += 1
            self._tree = tree
            self._cond.notify_all()
            return self._version

    def latest(self) -> tuple[int, Any]:
        """(version, tree) of the newest published snapshot."""
        with self._cond:
            if self._version < 0:
                raise RuntimeError("no weights published yet")
            return self._version, self._tree

    def wait_for_version(self, min_version: int = 0,
                         timeout: Optional[float] = None,
                         stop: Optional[threading.Event] = None,
                         ) -> tuple[int, Any]:
        """Block until a version >= `min_version` is published, then return
        `latest()`. A rollout worker that joins the fleet BEFORE the trainer
        publishes snapshot 0 (multi-host workers boot concurrently with the
        trainer; in-process ones can race a slow `_policy_snapshot` copy)
        must wait here instead of crash-looping `latest()`'s RuntimeError
        through its consecutive-failure budget into quarantine.

        `stop` (optional Event) aborts the wait with a TimeoutError when
        set — a worker being shut down must not ride out a long timeout.
        Raises TimeoutError after `timeout` seconds (None = wait forever).
        """
        deadline = (
            None if timeout is None else threading.TIMEOUT_MAX
            if timeout < 0 else timeout
        )
        with self._cond:
            waited = 0.0
            while self._version < min_version:
                if stop is not None and stop.is_set():
                    raise TimeoutError(
                        f"stopped while waiting for weight version "
                        f">= {min_version}"
                    )
                # slice the wait so `stop` is polled even with timeout=None
                slice_s = 0.1 if deadline is None \
                    else min(0.1, max(0.0, deadline - waited))
                self._cond.wait(timeout=slice_s)
                waited += slice_s
                if deadline is not None and waited >= deadline \
                        and self._version < min_version:
                    raise TimeoutError(
                        f"no weight version >= {min_version} published "
                        f"after {timeout}s (latest: {self._version})"
                    )
            return self._version, self._tree
