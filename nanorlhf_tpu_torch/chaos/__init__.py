"""Chaos soak harness — the port of `nanorlhf_tpu/chaos`.

Composes multi-site fault schedules from the wired injection-point
registry under the splitmix64 lineage-PRNG discipline (composer.py),
drives an end-to-end run under them (runner.py: the loadgen → engine
serving soak on the port's `ServingEngine`; the trainer soak needs the
rollout fleet, which is not ported, and raises), audits the run's global
invariants from the lineage ledger + component snapshots (auditors.py),
and — on any auditor failure — delta-debugs the spec down to a minimal
failing clause set with a one-line repro command (shrink.py).
`python -m nanorlhf_tpu_torch.chaos` is the CLI entry point.
"""

from nanorlhf_tpu_torch.chaos.auditors import (  # noqa: F401
    AUDITORS, INVARIANTS, AuditResult, run_audits,
)
from nanorlhf_tpu_torch.chaos.composer import (  # noqa: F401
    KEY_PATH, SERVING_SITES, TRAINER_SITES, ChaosPlan, compose,
    plan_digest, uncovered_sites,
)
from nanorlhf_tpu_torch.chaos.runner import (  # noqa: F401
    SOAKS, SoakReport, soak_serving, soak_trainer,
)
from nanorlhf_tpu_torch.chaos.shrink import repro_command, shrink  # noqa: F401
