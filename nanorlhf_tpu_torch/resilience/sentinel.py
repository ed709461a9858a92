"""Training sentinel: per-step finite checks + EWMA loss-spike detection,
with a bounded rollback budget and a quarantine set for offending batches.

The sentinel only OBSERVES host-side scalars the trainer already computes
(mean policy loss, global grad norm) — a no-fault run with the sentinel
enabled is numerically identical to one without it; the guard costs one
float comparison per update. On a trip the trainer restores the last
committed checkpoint (the PR-1 queue journal + index-keyed PRNG make the
replayed data/token streams bit-identical), quarantines the offending
rollout index so the replay skips it instead of re-deriving the same NaN,
and charges the bounded rollback budget.

Sentinel state is journaled into every checkpoint (`trainer_state.json`
under "resilience") so recovery behavior itself resumes: a run restored on
a fresh host remembers its rollback spend and quarantined batches.

The port's copy of `nanorlhf_tpu/resilience/sentinel.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


class SentinelBudgetExceeded(RuntimeError):
    """The run tripped more times than `rollback_budget` allows — repeated
    divergence is a config/data problem rollback cannot fix."""


@dataclasses.dataclass
class SentinelConfig:
    enabled: bool = True
    # EWMA spike detector: trip when (loss − ewma) / √var > spike_zscore,
    # after `warmup_steps` observations have seeded the statistics. The
    # default is deliberately loose — RL losses are noisy and a false trip
    # costs a rollback.
    spike_zscore: float = 6.0
    ewma_alpha: float = 0.1
    warmup_steps: int = 20
    # variance floor, as a fraction of |ewma|: early in a run the EWMA
    # variance badly underestimates the true spread (it has only folded a
    # few deviations), so a raw z-test trips on ordinary noise around a
    # near-constant loss. The floor demands a spike ALSO clear
    # zscore · var_floor_frac · |ewma| — a relative-magnitude gate.
    var_floor_frac: float = 0.05
    rollback_budget: int = 2


class TrainingSentinel:
    """`observe(loss, grad_norm)` → None | "nonfinite" | "spike"."""

    def __init__(self, config: Optional[SentinelConfig] = None):
        self.cfg = config or SentinelConfig()
        self.steps = 0          # healthy observations folded into the EWMA
        self.ewma = 0.0
        self.var = 0.0
        self.rollbacks = 0
        self.quarantined: set[int] = set()  # rollout indices to skip on replay
        self.trips: list[dict] = []

    # ------------------------------------------------------------------ #
    # observation
    # ------------------------------------------------------------------ #

    def observe(self, loss: float, grad_norm: Optional[float] = None) -> Optional[str]:
        """Check one update's host-side stats. Tripped observations are NOT
        folded into the EWMA (a spike must not normalize itself)."""
        if not self.cfg.enabled:
            return None
        loss = float(loss)
        if not math.isfinite(loss) or (
            grad_norm is not None and not math.isfinite(float(grad_norm))
        ):
            return "nonfinite"
        if self.steps >= self.cfg.warmup_steps and self.var > 0.0:
            floor = (self.cfg.var_floor_frac * abs(self.ewma)) ** 2
            z = (loss - self.ewma) / math.sqrt(max(self.var, floor))
            if z > self.cfg.spike_zscore:
                return "spike"
        a = self.cfg.ewma_alpha
        if self.steps == 0:
            self.ewma = loss
        else:
            delta = loss - self.ewma
            self.ewma += a * delta
            # West's EWMA variance: decays old spread, folds in new deviation
            self.var = (1.0 - a) * (self.var + a * delta * delta)
        self.steps += 1
        return None

    # ------------------------------------------------------------------ #
    # rollback accounting
    # ------------------------------------------------------------------ #

    def note_rollback(self, step: int, rollout_index: int, verdict: str) -> None:
        """Charge one rollback and quarantine the offending rollout index.
        Raises SentinelBudgetExceeded when the budget is spent."""
        self.rollbacks += 1
        self.quarantined.add(int(rollout_index))
        self.trips.append(
            {"step": int(step), "rollout_index": int(rollout_index),
             "verdict": verdict}
        )
        if self.rollbacks > self.cfg.rollback_budget:
            raise SentinelBudgetExceeded(
                f"sentinel tripped {self.rollbacks} times "
                f"(budget {self.cfg.rollback_budget}); last verdict "
                f"{verdict!r} at step {step}"
            )

    # ------------------------------------------------------------------ #
    # checkpoint journal
    # ------------------------------------------------------------------ #

    def journal(self) -> dict:
        return {
            "steps": self.steps,
            "ewma": self.ewma,
            "var": self.var,
            "rollbacks": self.rollbacks,
            "quarantined": sorted(self.quarantined),
            "trips": list(self.trips),
        }

    def restore(self, journal: dict) -> None:
        self.steps = int(journal.get("steps", 0))
        self.ewma = float(journal.get("ewma", 0.0))
        self.var = float(journal.get("var", 0.0))
        self.restore_accounting(journal)

    def restore_accounting(self, journal: dict) -> None:
        """Restore only the rollback-accounting half (budget spend,
        quarantine set, trip log), leaving the EWMA statistics alone. The
        trainer's rollback path uses this: the statistical state must
        REWIND with the restored checkpoint (the replayed steps get folded
        into checkpoint-era statistics exactly once — re-applying the
        pre-trip EWMA would double-count every replayed loss and decay the
        variance toward a spurious second trip), while the accounting must
        SURVIVE the restore (the checkpoint predates the trip)."""
        self.rollbacks = int(journal.get("rollbacks", 0))
        self.quarantined = {int(i) for i in journal.get("quarantined", [])}
        self.trips = list(journal.get("trips", []))
