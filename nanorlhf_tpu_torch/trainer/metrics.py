"""Metrics with the reference's `_old`/`_new` naming — the port of
`nanorlhf_tpu/trainer/metrics.py`'s `MetricsLogger`.

`_old` = measured on the rollout (pre-update) policy, `_new` = measured
during the update pass. Each row is one JSON line in
`<output_dir>/metrics.jsonl` (`report_to="jsonl"`; "none" writes nothing),
stamped with the step, the episode, the wall time (`time`, provenance) and
a monotonic clock (`t_mono`, for durations); `log_event` rows carry no
episode. A short sample table prints
to the console.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "jsonl"):
        if report_to not in ("jsonl", "none"):
            raise NotImplementedError(
                f"report_to={report_to!r}: the port writes 'jsonl' or 'none'")
        self.output_dir = output_dir
        self._fh = None
        self._latest: dict = {}
        if report_to == "jsonl":
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def _emit(self, prefix: str, x: int, extra: dict, metrics: dict):
        record = {"step": x, **extra, "time": time.time(),
                  "t_mono": time.perf_counter()}
        record.update({k: float(v) for k, v in metrics.items()})
        print(f"[{prefix} {x}] " + " ".join(
            f"{k}={record[k]:.4g}" for k in sorted(metrics)[:8]), flush=True)
        self._latest = record
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log(self, step: int, episode: int, metrics: dict):
        self._emit("step", step, {"episode": episode}, metrics)

    def log_event(self, index: int, metrics: dict):
        """An out-of-band row (a sparse-filter skip): stamped with the
        caller's index and the clocks but no `episode` — a training-step
        row is one that carries `episode`, and consecutive skips at a frozen
        global step need distinct indices."""
        self._emit("event", index, {}, metrics)

    def latest(self) -> dict:
        return dict(self._latest)

    def log_samples(self, step: int, queries: list[str], responses: list[str],
                    scores, limit: int = 5):
        print(f"--- samples @ step {step} ---")
        for q, r, s in list(zip(queries, responses, scores))[:limit]:
            q1 = q.replace("\n", " ")[:80]
            r1 = r.replace("\n", " ")[:120]
            print(f"  score={float(s):+.3f} | {q1!r} -> {r1!r}")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
