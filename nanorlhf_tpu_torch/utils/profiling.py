"""Tracing / profiling utilities — the port of `nanorlhf_tpu/utils/
profiling.py` on `torch.profiler`.

- `PhaseTimer`: per-phase wall-clock split (rollout / reward / logprob /
  update), on `time.perf_counter()`. The caller synchronizes the device at
  the end of a phase (the timer does not), or queued kernels shift time
  into the next phase. With a telemetry.SpanTracer attached, every phase
  is also recorded as a trace span on the calling thread's track.
- `trace_profile`: a `torch.profiler` session (CPU activities, and CUDA
  ones when a card is present) that writes a Chrome trace file on exit;
  the session is closed on exception too, so a failed step does not leave
  the process's profiler running.
- `ProfileWindow`: the config-driven window — the trainer polls it each
  update, and it wraps `trace_profile` around exactly the configured
  updates (`profile_at_step` / `profile_num_steps`) or around a window
  requested on a live run by touching a trigger file.

A profiler that cannot start raises; nothing falls back to an untraced
window.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class PhaseTimer:
    """Accumulates monotonic wall-clock per named phase; one line per update."""

    def __init__(self, tracer=None, span_prefix: str = "trainer."):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        # never reset: the whole run's phase split
        self.cumulative: dict[str, float] = {}
        # optional telemetry.SpanTracer: phases double as trace spans
        self.tracer = tracer
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def phase(self, name: str):
        """Callers synchronize the device inside the block (a host read of
        the phase's outputs, or `torch.cuda.synchronize`) or queued work
        shifts time into the next phase."""
        span = (
            self.tracer.span(self.span_prefix + name)
            if self.tracer is not None and self.tracer.enabled
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        try:
            with span:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.cumulative[name] = self.cumulative.get(name, 0.0) + dt

    def summary(self, reset: bool = True) -> dict:
        out = {f"time/{k}_s": v for k, v in self.totals.items()}
        if reset:
            self.totals, self.counts = {}, {}
        return out


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace_profile(log_dir: str, enabled: bool = True,
                  filename: str = "trace.json"):
    """torch.profiler scope: `with trace_profile('/tmp/prof'): step()`
    writes `<log_dir>/<filename>` (Chrome trace-event JSON) when the block
    ends, also when it raises. Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, filename))


class ProfileWindow:
    """Windowed torch.profiler tracing around exactly N configured updates.

    `poll(step)` is called at the TOP of each update with the 1-based step
    about to run: the window opens when `step == at_step` (or when the
    trigger file appears — `touch <output_dir>/PROFILE` on a live run) and
    closes after `num_steps` updates, writing
    `<log_dir>/trace_steps_<first>-<last>.json`. `stop()` is idempotent and
    is reached from the trainer's close() path, so an exception inside a
    profiled step still closes the session. `paths` lists the traces
    written."""

    def __init__(self, log_dir: str, at_step: Optional[int] = None,
                 num_steps: int = 1, trigger_file: Optional[str] = None):
        self.log_dir = log_dir
        self.at_step = at_step
        self.num_steps = max(1, int(num_steps))
        self.trigger_file = trigger_file
        self.windows = 0          # completed windows
        self.paths: list[str] = []
        self._cm = None
        self._start_step: Optional[int] = None
        self._stop_at: Optional[int] = None
        self._armed = at_step is not None

    @property
    def active(self) -> bool:
        return self._cm is not None

    def _trigger_requested(self) -> bool:
        if not self.trigger_file or not os.path.exists(self.trigger_file):
            return False
        try:
            os.remove(self.trigger_file)  # consume the request
        except OSError:
            pass
        return True

    def poll(self, step: int) -> None:
        """Advance the window state machine for the update about to run."""
        if self.active and step >= self._stop_at:
            self.stop()
        if self.active:
            return
        start = self._armed and self.at_step is not None and step >= self.at_step
        if start:
            self._armed = False  # one config-driven window per run
        if start or self._trigger_requested():
            self._start(step)

    def _start(self, step: int) -> None:
        self._start_step = step
        self._stop_at = step + self.num_steps
        name = f"trace_steps_{step}-{self._stop_at - 1}.json"
        self._cm = trace_profile(self.log_dir, filename=name)
        self._cm.__enter__()
        self.paths.append(os.path.join(self.log_dir, name))
        print(f"[profile] torch.profiler window open: steps {step}.."
              f"{self._stop_at - 1} -> {self.paths[-1]}")

    def stop(self) -> None:
        """Close an open window and write its trace (idempotent; called from
        poll, the end of train(), and trainer.close())."""
        if self._cm is None:
            return
        cm, self._cm = self._cm, None
        self._stop_at = None
        try:
            cm.__exit__(None, None, None)
        finally:
            self.windows += 1
