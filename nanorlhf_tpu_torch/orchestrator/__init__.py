"""Async rollout orchestration — the port of `nanorlhf_tpu/orchestrator/`:
version-tagged weights, bounded-staleness sample queue, producer-thread
rollout pipeline, the N-worker elastic rollout fleet and its RPC
transport, with the same exports as JAX's package."""

from nanorlhf_tpu_torch.orchestrator.weight_store import VersionedWeightStore
from nanorlhf_tpu_torch.orchestrator.sample_queue import (
    BoundedStalenessQueue,
    ProducerFailed,
    QueuedSample,
)
from nanorlhf_tpu_torch.orchestrator.orchestrator import (
    OverlapMeter,
    RolloutOrchestrator,
    note_ready_async,
)
from nanorlhf_tpu_torch.orchestrator.fleet import (
    FleetConfig,
    FleetCoordinator,
    FleetExhausted,
    FleetOrchestrator,
    FleetTransport,
    InProcessTransport,
    Lease,
    RolloutWorker,
)
from nanorlhf_tpu_torch.orchestrator.rpc import (
    FleetRpcServer,
    RemoteCoordinator,
    RpcClient,
    RpcConfig,
    RpcTransport,
    TransportError,
)

__all__ = [
    "BoundedStalenessQueue",
    "FleetConfig",
    "FleetCoordinator",
    "FleetExhausted",
    "FleetOrchestrator",
    "FleetRpcServer",
    "FleetTransport",
    "InProcessTransport",
    "Lease",
    "OverlapMeter",
    "ProducerFailed",
    "QueuedSample",
    "RemoteCoordinator",
    "RolloutOrchestrator",
    "RolloutWorker",
    "RpcClient",
    "RpcConfig",
    "RpcTransport",
    "TransportError",
    "VersionedWeightStore",
    "note_ready_async",
]
