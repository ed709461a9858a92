"""Resilience layer (the port of `nanorlhf_tpu/resilience/`): fault
injection, the producer watchdog, the training sentinel with checkpoint
rollback, graceful preemption, process reaping and retry with backoff —
copies of the JAX modules, exporting the same names."""

from nanorlhf_tpu_torch.resilience.faults import (
    ENV_VAR,
    INJECTION_POINTS,
    FaultInjector,
    FaultSchedule,
    InjectedFault,
    parse_fault_spec,
)
from nanorlhf_tpu_torch.resilience.preemption import Preempted, PreemptionGuard, null_guard
from nanorlhf_tpu_torch.resilience.procs import reap_process
from nanorlhf_tpu_torch.resilience.retry import backoff_delay, retry_with_backoff
from nanorlhf_tpu_torch.resilience.sentinel import (
    SentinelBudgetExceeded,
    SentinelConfig,
    TrainingSentinel,
)
from nanorlhf_tpu_torch.resilience.watchdog import ProducerWatchdog, WatchdogConfig

__all__ = [
    "ENV_VAR",
    "INJECTION_POINTS",
    "FaultInjector",
    "FaultSchedule",
    "InjectedFault",
    "Preempted",
    "PreemptionGuard",
    "ProducerWatchdog",
    "SentinelBudgetExceeded",
    "SentinelConfig",
    "TrainingSentinel",
    "WatchdogConfig",
    "backoff_delay",
    "null_guard",
    "parse_fault_spec",
    "reap_process",
    "retry_with_backoff",
]
