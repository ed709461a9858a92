"""SLO-driven autoscaling control loop (docs/TRAFFIC.md §4).

Closes the health plane's open loop: its SLO rules
(`slo_ttft_p95`, `slo_queue_wait_p99`) produce verdicts that until now
terminated in a blackbox dump. The Autoscaler reads those verdicts plus
the engine's live queue depth each `evaluate()` tick and actuates the
fleet's elastic hooks (`FleetOrchestrator.add_worker` /
`remove_worker(..., drain=True)`), under the same hysteresis discipline
health.py applies to level transitions:

- scale UP only after `breach_evals` CONSECUTIVE breached ticks (a
  single bursty tick is not a capacity problem);
- scale DOWN only after `recovery_evals` consecutive healthy ticks
  (mirror of health.py's `recovery_rows` step-down damping — recovery
  must be *sustained* before capacity is taken away);
- a shared `cooldown_s` after ANY action, so the controller observes the
  effect of its last decision before making another (workers take time
  to warm up; removing the wait is how flapping happens);
- hard `min_workers`/`max_workers` bounds, and scale-in picks the
  NEWEST worker (highest id — worker ids are monotonic) and drains it,
  so the longest-warmed workers survive and no in-flight lease is
  stranded.

The controller is deliberately clock-injectable (`clock=`) and does not
own a thread: callers decide the tick cadence (a loop, a test with a
fake clock, the e2e harness). Every decision — including deliberate
holds — is visible: actions become `autoscale` lineage events and trace
instants; holds due to cooldown are counted.

Lock order: `loadgen.autoscaler` is rank 0 in LOCK_ORDER — below
`fleet.coordinator` and `telemetry.lineage` — so actuating the fleet and
recording lineage while holding the controller lock is legal. The lock
exists because `evaluate()` may be called from a driver thread while a
test inspects counters.

(The port's copy of `nanorlhf_tpu/loadgen/autoscaler.py`;
`tests/test_torch_fleet.py` holds it against the original and drives it
against the port's fleet.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from nanorlhf_tpu_torch.analysis.lockorder import make_lock

# health.py's levels, re-declared as an ordering (OK < WARN < CRIT) so
# this module stays importable without the health plane
_LEVEL_RANK = {"ok": 0, "warn": 1, "crit": 2}

# the SLO rules an autoscaler watches by default (health.py SLO_RULES)
DEFAULT_SLO_RULES = ("slo_ttft_p95", "slo_queue_wait_p99")


def slo_level_from_monitor(monitor, rules=DEFAULT_SLO_RULES) -> str:
    """Worst level among `rules` in a HealthMonitor snapshot — the glue
    between health.py's verdict surface and the controller's input."""
    levels = monitor.snapshot().get("rules", {})
    worst = "ok"
    for name in rules:
        lvl = levels.get(name, "ok")
        if _LEVEL_RANK.get(lvl, 0) > _LEVEL_RANK[worst]:
            worst = lvl
    return worst


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_workers: int = 1
    max_workers: int = 4
    # consecutive breached evaluate() ticks before scaling up
    breach_evals: int = 2
    # consecutive healthy ticks before scaling down (health.py
    # recovery_rows idiom: sustained recovery, not one good sample)
    recovery_evals: int = 8
    # seconds after any action during which both directions hold
    cooldown_s: float = 5.0
    # SLO level that counts as a breach ("warn" scales earlier)
    breach_level: str = "crit"
    # queue depth that counts as a breach even while SLOs still read OK
    # (leading indicator — the queue fills before p95 TTFT degrades);
    # None disables the depth trigger
    queue_high: Optional[int] = None

    def validate(self) -> None:
        if not (1 <= self.min_workers <= self.max_workers):
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")
        if self.breach_evals < 1 or self.recovery_evals < 1:
            raise ValueError("breach_evals and recovery_evals must be >= 1")
        if self.breach_level not in _LEVEL_RANK:
            raise ValueError(f"unknown breach_level {self.breach_level!r}")


class Autoscaler:
    """Hysteresis controller from SLO verdicts to fleet size.

    Pure actuator wiring: `add_worker()` returns a worker id,
    `remove_worker(worker_id)` drains and removes (the caller binds
    `drain=True` — see FleetOrchestrator.remove_worker), `worker_ids()`
    returns the live ids, `slo_level()` returns "ok"/"warn"/"crit", and
    optional `queue_depth()` returns the engine's pending count.
    """

    def __init__(self, *, add_worker: Callable[[], int],
                 remove_worker: Callable[[int], object],
                 worker_ids: Callable[[], list],
                 slo_level: Callable[[], str],
                 queue_depth: Optional[Callable[[], int]] = None,
                 config: Optional[AutoscalerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 lineage=None, tracer=None):
        self.cfg = config or AutoscalerConfig()
        self.cfg.validate()
        self._add_worker = add_worker
        self._remove_worker = remove_worker
        self._worker_ids = worker_ids
        self._slo_level = slo_level
        self._queue_depth = queue_depth
        self._clock = clock
        self._lineage = lineage
        self._tracer = tracer
        self._lock = make_lock("loadgen.autoscaler")
        self._breach_streak = 0
        self._ok_streak = 0
        self._last_action_t: Optional[float] = None
        self._evals = 0
        self._counters = {"scale_ups": 0, "scale_downs": 0,
                          "holds_cooldown": 0}

    # ------------------------------------------------------------- #
    # control step
    # ------------------------------------------------------------- #

    def evaluate(self) -> str:
        """One control tick. Returns the decision:
        "scale_up" | "scale_down" | "hold" | "hold_cooldown"."""
        with self._lock:
            self._evals += 1
            step = self._evals
            level = self._slo_level()
            depth = self._queue_depth() if self._queue_depth else None
            breach = (_LEVEL_RANK.get(level, 0)
                      >= _LEVEL_RANK[self.cfg.breach_level])
            if (not breach and self.cfg.queue_high is not None
                    and depth is not None
                    and depth >= self.cfg.queue_high):
                breach = True
            if breach:
                self._breach_streak += 1
                self._ok_streak = 0
            else:
                self._ok_streak += 1
                self._breach_streak = 0

            ids = sorted(self._worker_ids())
            n = len(ids)
            now = self._clock()
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < self.cfg.cooldown_s)

            action = "hold"
            worker_id = None
            if breach and self._breach_streak >= self.cfg.breach_evals:
                if n < self.cfg.max_workers:
                    if cooling:
                        action = "hold_cooldown"
                        self._counters["holds_cooldown"] += 1
                    else:
                        action = "scale_up"
            elif (not breach and self._ok_streak >= self.cfg.recovery_evals
                    and n > self.cfg.min_workers):
                if cooling:
                    action = "hold_cooldown"
                    self._counters["holds_cooldown"] += 1
                else:
                    action = "scale_down"
                    # newest worker drains out: ids are monotonic, so the
                    # longest-warmed workers keep serving
                    worker_id = ids[-1]

            if action == "scale_up":
                worker_id = self._add_worker()
                self._counters["scale_ups"] += 1
                self._breach_streak = 0
                self._last_action_t = now
            elif action == "scale_down":
                self._remove_worker(worker_id)
                self._counters["scale_downs"] += 1
                self._ok_streak = 0
                self._last_action_t = now

            if action in ("scale_up", "scale_down"):
                n_after = len(self._worker_ids())
                if self._lineage is not None and self._lineage.enabled:
                    self._lineage.event(
                        "autoscale", action=action, worker_id=worker_id,
                        workers_before=n, workers_after=n_after,
                        level=level, queue_depth=depth, eval=step)
                if self._tracer is not None and self._tracer.enabled:
                    self._tracer.instant(
                        f"autoscale.{action}", worker_id=worker_id,
                        workers=n_after, level=level)
            return action

    # ------------------------------------------------------------- #
    # observability
    # ------------------------------------------------------------- #

    def metrics(self) -> dict:
        with self._lock:
            return {
                "loadgen/scale_ups": self._counters["scale_ups"],
                "loadgen/scale_downs": self._counters["scale_downs"],
                "loadgen/holds_cooldown": self._counters["holds_cooldown"],
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "evals": self._evals,
                "breach_streak": self._breach_streak,
                "ok_streak": self._ok_streak,
                "workers": sorted(self._worker_ids()),
                "counters": dict(self._counters),
                "config": dataclasses.asdict(self.cfg),
            }
