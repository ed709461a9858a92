"""Sequence parallelism over torch.distributed — the port of
`nanorlhf_tpu/parallel/` at `MeshConfig(data=1, fsdp=1, tensor=1, sp=N)`.
JAX's data/fsdp/tensor names (`param_sharding_rules`, `shard_params`,
`batch_sharding`, `sp_fsdp_forward_logits`) wait for A14b."""

from nanorlhf_tpu_torch.parallel.distributed import (
    broadcast_host_value,
    initialize_multihost,
    spawn,
)
from nanorlhf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from nanorlhf_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_flash
from nanorlhf_tpu_torch.parallel.sp import (
    sp_forward_logits,
    sp_score_logprobs,
    sp_score_values,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "ring_attention",
    "ring_attention_flash",
    "sp_forward_logits",
    "sp_score_logprobs",
    "sp_score_values",
    "initialize_multihost",
    "broadcast_host_value",
    "spawn",
]
