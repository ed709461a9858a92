"""The mesh as process groups — the port of `nanorlhf_tpu/parallel/mesh.py`
for its sequence-parallel axis.

JAX's `Mesh` has four axes (data, fsdp, tensor, sp) over the devices of
one program. Here each rank is a process (`torchrun --nproc-per-node N`,
or `parallel.distributed.spawn`), and `make_mesh` resolves `MeshConfig`
over the world of the default process group. This slice carries the sp
axis at `MeshConfig(data=1, fsdp=1, tensor=1, sp=N)`: the sp group is the
whole world, params and batch are replicated over it, and the sequence dim
of the scoring and update passes shards over it (`parallel/sp.py`). The
data, fsdp and tensor axes (JAX's `param_sharding_rules`, `shard_params`,
`batch_sharding`) wait for A14b: `make_mesh` raises NotImplementedError
naming it.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from nanorlhf_tpu_torch.parallel.distributed import Transport, world_size
from nanorlhf_tpu_torch.trainer.config import MeshConfig

A14B = ("A14b (the data, fsdp and tensor axes, disaggregated rollout devices and "
        "multi-host on torch.distributed)")


@dataclasses.dataclass
class Mesh:
    """A resolved mesh: the sp axis's size, this process's rank on it and
    the sp group's transport (None when sp == 1). The other axes are 1
    until A14b adds them."""
    sp: int = 1
    rank: int = 0
    transport: Transport | None = None


def make_mesh(config: MeshConfig | None = None) -> Mesh:
    """Resolve `config` over the default group's world (1 without one).
    ValueError: a mesh that does not cover the world, or JAX's `sp > 1 with
    tensor > 1`; NotImplementedError: a data, fsdp or tensor axis > 1."""
    config = config or MeshConfig()
    world = world_size()
    try:
        d, f, t, s = config.resolve(world)
    except ValueError as e:
        raise ValueError(
            f"{e}: the mesh's axes multiply to the torch.distributed world "
            f"({world} rank{'s' if world > 1 else ''}); launch sp = N with "
            "`torchrun --nproc-per-node N` or `parallel.distributed.spawn`") from e
    if s > 1 and t > 1:
        raise ValueError("sp > 1 with tensor > 1 is not supported")
    if d > 1 or f > 1 or t > 1:
        raise NotImplementedError(
            f"mesh data={d} fsdp={f} tensor={t}: only the sp axis is ported to "
            f"nanorlhf_tpu_torch; the others wait for {A14B}")
    if s == 1:
        return Mesh()
    group = dist.group.WORLD
    return Mesh(sp=s, rank=dist.get_rank(group),
                transport=Transport(group, dist.get_backend(group)))


__all__ = ["A14B", "Mesh", "MeshConfig", "make_mesh"]
