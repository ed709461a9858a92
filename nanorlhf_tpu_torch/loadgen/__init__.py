"""Traffic harness — the port of `nanorlhf_tpu/loadgen/` (jax-free in both):
deterministic open-loop load generation and goodput sweeps.

- workload.py   — replayable WorkloadSpec → request sequence (zero
                  wall-clock; seed + spec replays bit-identically)
- driver.py     — open-loop multi-threaded driver (in-process ServingEngine
                  or HTTP gateway target); records client TTFT + outcomes
- report.py     — offered-load sweep → goodput/shed/TTFT curve

JAX's `autoscaler.py` actuates the rollout fleet, which the port does not
have yet; it comes with the fleet.
"""

from nanorlhf_tpu_torch.loadgen.workload import (  # noqa: F401
    GenRequest, WorkloadSpec, requests_digest, sample_requests, spec_digest,
)
from nanorlhf_tpu_torch.loadgen.driver import (  # noqa: F401
    RequestRecord, TrafficDriver, TrafficSummary,
)
from nanorlhf_tpu_torch.loadgen.report import (  # noqa: F401
    SweepPoint, format_table, points_as_detail, run_sweep,
)
