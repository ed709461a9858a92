"""The mesh over torch.distributed — the port of `nanorlhf_tpu/parallel/`
at `MeshConfig(data, fsdp, 1, sp)`: the batch over (data, fsdp), params
sharded over fsdp, the sequence over the sp ring. The tensor axis waits
for A14c."""

from nanorlhf_tpu_torch.parallel.distributed import (
    broadcast_host_value,
    initialize_multihost,
    spawn,
)
from nanorlhf_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    shard_params,
)
from nanorlhf_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_flash
from nanorlhf_tpu_torch.parallel.sp import (
    sp_forward_logits,
    sp_fsdp_forward_logits,
    sp_score_logprobs,
    sp_score_values,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "param_sharding_rules",
    "shard_params",
    "batch_sharding",
    "ring_attention",
    "ring_attention_flash",
    "sp_forward_logits",
    "sp_fsdp_forward_logits",
    "sp_score_logprobs",
    "sp_score_values",
    "initialize_multihost",
    "broadcast_host_value",
    "spawn",
]
