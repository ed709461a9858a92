"""Traffic harness — the port of `nanorlhf_tpu/loadgen/` (jax-free in both):
deterministic open-loop load generation and goodput sweeps.

- workload.py   — replayable WorkloadSpec → request sequence (zero
                  wall-clock; seed + spec replays bit-identically)
- driver.py     — open-loop multi-threaded driver (in-process ServingEngine
                  or HTTP gateway target); records client TTFT + outcomes
- autoscaler.py — hysteresis controller: SLO verdicts → add/remove_worker
                  of the rollout fleet (`orchestrator/fleet.py`)
- report.py     — offered-load sweep → goodput/shed/TTFT curve
"""

from nanorlhf_tpu_torch.loadgen.workload import (  # noqa: F401
    GenRequest, WorkloadSpec, requests_digest, sample_requests, spec_digest,
)
from nanorlhf_tpu_torch.loadgen.driver import (  # noqa: F401
    RequestRecord, TrafficDriver, TrafficSummary,
)
from nanorlhf_tpu_torch.loadgen.autoscaler import (  # noqa: F401
    Autoscaler, AutoscalerConfig, slo_level_from_monitor,
)
from nanorlhf_tpu_torch.loadgen.report import (  # noqa: F401
    SweepPoint, format_table, points_as_detail, run_sweep,
)
