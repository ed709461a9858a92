"""Fork hygiene of the test processes that run the port's tests beside the
JAX package's.

The JAX `RLTrainer` and the port's install a `PreemptionGuard` (the port's
is a copy of JAX's, with the same class name): a Python-level SIGTERM
handler that only sets a flag (the trainer's grace window). Tests that
build a trainer without closing it leave that handler installed for the
rest of the worker process. A child forked afterwards (the JAX package's
fork pools and graders) inherits it, so `Pool.terminate()` /
`Process.terminate()` no longer stop the child and the parent's `join()`
waits for ever — a hang of the whole pytest run, at random, depending
on which tests an xdist worker ran before which.

Every test module is imported by every worker at collection, so this
module registers, at import, a fork hook that gives a forked child the
default SIGTERM action back when the handler it inherited is a
`PreemptionGuard`'s (and only then). The guard stays installed in the
process that created it; only children forked from it lose it, and a
child that installs its own handler after the fork is unaffected."""

import multiprocessing
import os
import signal
import time


def _drop_inherited_preemption_guard() -> None:
    handler = signal.getsignal(signal.SIGTERM)
    if type(getattr(handler, "__self__", None)).__name__ == "PreemptionGuard":
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


os.register_at_fork(after_in_child=_drop_inherited_preemption_guard)


def _block_forever(started):
    started.set()
    while True:
        time.sleep(1.0)


def _child_terminates_under(guard_cls) -> None:
    """With a live guard in this process, a forked child stops on
    terminate() (without the hook its join would never return), while the
    guard keeps swallowing SIGTERM here."""
    guard = guard_cls()
    try:
        assert guard.installed
        ctx = multiprocessing.get_context("fork")
        started = ctx.Event()
        child = ctx.Process(target=_block_forever, args=(started,))
        child.start()
        # terminate a running child, as a pool does: a SIGTERM that lands
        # between the fork and the hook meets the inherited handler
        assert started.wait(timeout=20)
        child.terminate()
        child.join(timeout=20)
        alive = child.is_alive()
        if alive:
            child.kill()
            child.join(timeout=20)
        assert not alive and child.exitcode == -signal.SIGTERM
        os.kill(os.getpid(), signal.SIGTERM)  # still only a flag here
        deadline = time.monotonic() + 5
        while not guard.triggered and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.triggered
    finally:
        guard.uninstall()


def test_forked_child_of_a_guarded_process_still_terminates():
    """Under the JAX trainer's guard."""
    from nanorlhf_tpu.resilience.preemption import PreemptionGuard

    _child_terminates_under(PreemptionGuard)


def test_forked_child_of_a_port_guarded_process_still_terminates():
    """Under the port's guard, which every port trainer installs by default
    (`graceful_preemption`)."""
    from nanorlhf_tpu_torch.resilience.preemption import PreemptionGuard

    _child_terminates_under(PreemptionGuard)
