"""Producer watchdog policy: restart budget, exponential backoff, and the
degrade-to-synchronous decision.

The mechanism (tearing down / rebuilding the orchestrator, resetting the
data iterator to the consumed cursor) lives in the trainer — it owns the
iterator and the weight snapshots. This module owns the POLICY so it is
unit-testable without a trainer: given a sequence of producer failures,
when do we restart, how long do we back off, and when do we stop trying
and fall back to synchronous rollouts (staleness 0) instead of killing
the run.

Budget semantics: `restart_budget` bounds CONSECUTIVE failed recoveries —
a successful sample consumption resets the streak (a producer that dies
once a day should not exhaust a long run's budget), while a producer that
dies every time it is restarted exhausts the budget quickly and triggers
degradation. `restarts_total` counts every restart for the
`resilience/producer_restarts` metric series.

The port's copy of `nanorlhf_tpu/resilience/watchdog.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import dataclasses
import random

from nanorlhf_tpu_torch.resilience.retry import backoff_delay


@dataclasses.dataclass
class WatchdogConfig:
    restart_budget: int = 2       # consecutive restarts before degrading
    backoff_base: float = 0.5     # seconds; doubles per consecutive failure
    backoff_max: float = 30.0
    # ±fraction spread on each restart delay (resilience/retry.backoff_delay):
    # several supervised producers/fleets restarted off the same failure
    # would otherwise retry against the weight store in lockstep. 0 keeps
    # the schedule exact (policy unit tests pin the 2× doubling).
    backoff_jitter: float = 0.0
    degrade_to_sync: bool = True  # past budget: sync fallback vs re-raise
    # (the producer liveness poll interval lives on the orchestrator —
    # RLConfig.producer_heartbeat — not here: the watchdog only decides
    # what to do once a death has already been detected)


class ProducerWatchdog:
    """Decision state machine for producer-thread supervision."""

    RESTART = "restart"
    DEGRADE = "degrade"
    RAISE = "raise"

    def __init__(self, config: WatchdogConfig | None = None,
                 seed: int = 0):
        self.cfg = config or WatchdogConfig()
        self._rng = random.Random(seed)  # deterministic jitter draws
        self.consecutive_failures = 0
        self.restarts_total = 0
        self.degraded = False

    def on_failure(self) -> tuple[str, float]:
        """The producer died (or heartbeat-silenced past its liveness
        check). Returns (decision, backoff_seconds)."""
        self.consecutive_failures += 1
        if self.consecutive_failures > self.cfg.restart_budget:
            if self.cfg.degrade_to_sync:
                self.degraded = True
                return self.DEGRADE, 0.0
            return self.RAISE, 0.0
        self.restarts_total += 1
        return self.RESTART, backoff_delay(
            self.consecutive_failures - 1,
            self.cfg.backoff_base, self.cfg.backoff_max,
            jitter=self.cfg.backoff_jitter, rng=self._rng,
        )

    def on_success(self) -> None:
        """A sample was consumed: the pipeline is healthy again."""
        self.consecutive_failures = 0

    # ------------------------------------------------------------------ #
    # checkpoint journal (recovery behavior itself resumes)
    # ------------------------------------------------------------------ #

    def journal(self) -> dict:
        return {
            "restarts_total": self.restarts_total,
            "degraded": self.degraded,
        }

    def restore(self, journal: dict) -> None:
        self.restarts_total = int(journal.get("restarts_total", 0))
        self.degraded = bool(journal.get("degraded", False))
