"""Graceful SIGTERM/preemption handling.

TPU pods get preempted with a SIGTERM and a grace window. The default
Python behavior (immediate KeyboardInterrupt-style death) abandons the
in-flight async checkpoint write — a corrupt directory the next resume has
to clamp away — and loses every update since the last `save_steps`
boundary. The guard converts SIGTERM into a flag the training loop polls
at update boundaries: the trainer flushes the in-flight async save, writes
an emergency checkpoint at the current step, and raises `Preempted` so
launchers unwind through their normal `finally: trainer.close()` path.

Signal handlers can only be installed from the main thread; elsewhere the
guard degrades to a manual `trigger()`-only object (tests use this too).
While installed the guard does NOT chain to the previous handler — a
harness-installed handler that exits would defeat the grace window; the
previous handler is restored on `uninstall()`, so stacking guards
(multiple trainers in one process) stays well-behaved.

The port's copy of `nanorlhf_tpu/resilience/preemption.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import signal
import threading


class Preempted(RuntimeError):
    """Raised by the training loop after the emergency checkpoint commits."""


class PreemptionGuard:
    def __init__(self, signum: int = signal.SIGTERM, install: bool = True):
        self.signum = signum
        self._event = threading.Event()
        self._prev = None
        self._installed = False
        if install:
            try:
                self._prev = signal.signal(signum, self._on_signal)
                self._installed = True
            except ValueError:  # not the main thread: manual trigger only
                pass

    def _on_signal(self, signum, frame):
        # flag only — deliberately NOT chaining to the previous handler
        # while the guard is installed: the whole point of the grace window
        # is that nothing exits before the emergency checkpoint commits
        # (harness-installed SIGTERM handlers typically sys.exit). The
        # previous handler comes back on uninstall().
        self._event.set()

    @property
    def installed(self) -> bool:
        return self._installed

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Manual preemption signal (tests; cooperative shutdown)."""
        self._event.set()

    def clear(self) -> None:
        self._event.clear()

    def uninstall(self) -> None:
        if self._installed:
            try:
                if signal.getsignal(self.signum) == self._on_signal:
                    signal.signal(self.signum, self._prev or signal.SIG_DFL)
            except ValueError:
                pass
            self._installed = False


def null_guard() -> PreemptionGuard:
    """A fresh never-installed guard for `graceful_preemption=False` paths —
    callers poll `.triggered` unconditionally. Fresh per call: a shared
    instance would let one trainer's manual trigger() poison every later
    trainer in the process with a spurious Preempted."""
    return PreemptionGuard(install=False)
