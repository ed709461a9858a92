"""Metrics with the reference's `_old`/`_new` naming — the port of
`nanorlhf_tpu/trainer/metrics.py`'s `MetricsLogger`.

`_old` = measured on the rollout (pre-update) policy, `_new` = measured
during the update pass. Each row is one JSON line in
`<output_dir>/metrics.jsonl` (`report_to="jsonl"`; "tensorboard" writes
the jsonl and TensorBoard event files under `<output_dir>/tb` through
`torch.utils.tensorboard.SummaryWriter`; "none" writes nothing), stamped
with the step, the episode, the wall time (`time`, provenance) and a
monotonic clock (`t_mono`, for durations); `log_event` rows carry no
episode. A short sample table prints to the console. `latest()` is read
by the status exporter's HTTP threads, so the latest row is published
under a lock.

Where JAX's logger falls back to jsonl alone when TensorBoard cannot be
loaded, the port's raises an ImportError that names the missing package.
"""

from __future__ import annotations

import atexit
import json
import os
import time

from nanorlhf_tpu_torch.analysis.lockorder import make_lock


def staleness_histogram_metrics(counts: dict, prefix: str = "orchestrator") -> dict:
    """The orchestrator's sample-staleness histogram as scalar rows
    (`orchestrator/staleness_hist_K` = cumulative samples consumed at
    staleness K), JAX's `staleness_histogram_metrics`."""
    return {
        f"{prefix}/staleness_hist_{int(k)}": float(v)
        for k, v in sorted(counts.items(), key=lambda kv: int(kv[0]))
    }


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "jsonl"):
        if report_to not in ("jsonl", "tensorboard", "none"):
            raise NotImplementedError(
                f"report_to={report_to!r}: the port writes 'jsonl', "
                "'tensorboard' or 'none'")
        self.output_dir = output_dir
        self.report_to = report_to
        self._fh = None
        self._tb = None
        self._lock = make_lock("trainer.metrics")
        self._latest: dict = {}
        if report_to == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "report_to='tensorboard' needs the 'tensorboard' package "
                    f"({e})") from e
            self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        if report_to in ("jsonl", "tensorboard"):
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if self._fh is not None or self._tb is not None:
            # an exit that bypasses close() must not lose the buffered tail
            atexit.register(self.close)

    def _emit(self, prefix: str, x: int, extra: dict, metrics: dict):
        record = {"step": x, **extra, "time": time.time(),
                  "t_mono": time.perf_counter()}
        record.update({k: float(v) for k, v in metrics.items()})
        print(f"[{prefix} {x}] " + " ".join(
            f"{k}={record[k]:.4g}" for k in sorted(metrics)[:8]), flush=True)
        with self._lock:
            self._latest = record
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), x)

    def log(self, step: int, episode: int, metrics: dict):
        self._emit("step", step, {"episode": episode}, metrics)

    def log_event(self, index: int, metrics: dict):
        """An out-of-band row (a sparse-filter skip): stamped with the
        caller's index and the clocks but no `episode` — a training-step
        row is one that carries `episode`, and consecutive skips at a frozen
        global step need distinct indices."""
        self._emit("event", index, {}, metrics)

    def latest(self) -> dict:
        """A copy of the latest row ({} before the first), safe to call
        from another thread."""
        with self._lock:
            return dict(self._latest)

    def log_samples(self, step: int, queries: list[str], responses: list[str],
                    scores, limit: int = 5):
        print(f"--- samples @ step {step} ---")
        for q, r, s in list(zip(queries, responses, scores))[:limit]:
            q1 = q.replace("\n", " ")[:80]
            r1 = r.replace("\n", " ")[:120]
            print(f"  score={float(s):+.3f} | {q1!r} -> {r1!r}")

    def close(self):
        """Flush and close the sinks (idempotent)."""
        atexit.unregister(self.close)
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
