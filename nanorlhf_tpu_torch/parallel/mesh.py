"""The mesh as process groups — the port of `nanorlhf_tpu/parallel/mesh.py`
(`make_mesh`, `param_sharding_rules`, `shard_params`, `batch_sharding`).

JAX's `Mesh` has four axes (data, fsdp, tensor, sp) over the devices of
one program. Here each rank is a process (`torchrun --nproc-per-node N`,
or `parallel.distributed.spawn`), and `make_mesh` resolves `MeshConfig`
over the world of the default process group. A rank's coordinates follow
JAX's `reshape(d, f, t, s)` of the device list:
rank = ((i_d·f + i_f)·t + i_t)·s + i_s, so the data axis is the slowest
(torchrun numbers ranks host-major, which keeps `dcn_data`'s slices
whole) and sp the fastest.

Every axis line of size > 1 is a process group with its own `Transport`
(data, fsdp, sp), and so is the joint (data, fsdp) batch line; every rank
creates every group, in one order, because `dist.new_group` is a
collective over the world.

  * data  — the batch splits over (data, fsdp) jointly: rank block
            i_d·f + i_f of the rows (`batch_sharding`);
  * fsdp  — params and AdamW moments are sharded at rest along the axis
            the rules mark (`shard_params`) and gathered one layer at a
            time in the forward (`parallel/fsdp.py`);
  * sp    — the sequence dim of the scoring and update passes shards over
            the ring (`parallel/sp.py`); params and batch are replicated
            over it;
  * tensor— waits for A14c: `make_mesh` raises NotImplementedError.

The sharding rules are JAX's table, copied (this module imports no JAX),
written over JAX's layout; the port stores kernels `[L, out, in]`,
`lm_head` `[V, D]`, LoRA `a` `[L, r, in]` and `b` `[L, out, r]` — JAX's
with the last two axes swapped (`bridge.py`) — so `port_spec` swaps the
last two entries of those leaves' specs: JAX's `P(None, "fsdp", "tensor")`
on `q_proj.kernel` puts fsdp on the port's LAST axis.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from nanorlhf_tpu_torch.parallel.distributed import Transport, world_size
from nanorlhf_tpu_torch.trainer.config import MeshConfig

A14C = ("A14c (the tensor axis, disaggregated rollout devices, multi-host and "
        "NCCL across cards on torch.distributed)")


@dataclasses.dataclass
class Mesh:
    """A resolved mesh: the four axis sizes, this process's global rank and
    coordinates, and a transport per axis line of size > 1 (`transport` is
    the sp ring's, `batch_transport` the joint (data, fsdp) line's)."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sp: int = 1
    rank: int = 0
    coords: tuple = (0, 0, 0, 0)
    transport: Transport | None = None
    data_transport: Transport | None = None
    fsdp_transport: Transport | None = None
    batch_transport: Transport | None = None

    @property
    def sp_rank(self) -> int:
        return self.coords[3]

    @property
    def fsdp_rank(self) -> int:
        return self.coords[1]

    @property
    def batch(self) -> int:
        """The batch ranks: data × fsdp."""
        return self.data * self.fsdp

    @property
    def batch_rank(self) -> int:
        """This rank's block of every batch: i_d·f + i_f."""
        return self.coords[0] * self.fsdp + self.coords[1]

    @property
    def writer(self) -> bool:
        """Rank 0 writes metrics, checkpoints and the host planes."""
        return self.rank == 0


def coords_of(rank: int, shape: tuple) -> tuple:
    """(i_d, i_f, i_t, i_s) of `rank` in the row-major (d, f, t, s) grid."""
    out = []
    for size in reversed(shape):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def axis_lines(shape: tuple, axes: tuple) -> list[list[int]]:
    """The groups of ranks that differ only along `axes` (indices into
    (d, f, t, s)), each in rank order, the groups in order of their first
    rank: one line per setting of the other axes."""
    lines: dict = {}
    for r in range(math.prod(shape)):
        c = coords_of(r, shape)
        key = tuple(x for i, x in enumerate(c) if i not in axes)
        lines.setdefault(key, []).append(r)
    return [lines[k] for k in sorted(lines, key=lambda k: lines[k][0])]


def make_mesh(config: MeshConfig | None = None) -> Mesh:
    """Resolve `config` over the default group's world (1 without one).
    ValueError: a mesh that does not cover the world, or JAX's `sp > 1 with
    tensor > 1`; NotImplementedError: a tensor axis > 1 (A14c)."""
    config = config or MeshConfig()
    world = world_size()
    try:
        d, f, t, s = config.resolve(world)
    except ValueError as e:
        raise ValueError(
            f"{e}: the mesh's axes multiply to the torch.distributed world "
            f"({world} rank{'s' if world > 1 else ''}); launch N ranks with "
            "`torchrun --nproc-per-node N` or `parallel.distributed.spawn`") from e
    if s > 1 and t > 1:
        raise ValueError("sp > 1 with tensor > 1 is not supported")
    if t > 1:
        raise NotImplementedError(
            f"mesh tensor={t}: the tensor axis is not ported to nanorlhf_tpu_torch; "
            f"it waits for {A14C}")
    shape = (d, f, t, s)
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    mesh = Mesh(data=d, fsdp=f, tensor=t, sp=s, rank=rank, coords=coords_of(rank, shape))
    backend = dist.get_backend()
    # every rank creates every group, in this order; the batch line is the
    # data or the fsdp line when the other axis is 1
    for name, axes, size in (("data_transport", (0,), d), ("fsdp_transport", (1,), f),
                             ("transport", (3,), s),
                             ("batch_transport", (0, 1), d * f if d > 1 and f > 1 else 1)):
        if size == 1:
            continue
        mine = None
        for line in axis_lines(shape, axes):
            group = dist.new_group(line) if len(line) < world else dist.group.WORLD
            if rank in line:
                mine = group
        setattr(mesh, name, Transport(mine, backend))
    if mesh.batch_transport is None:
        mesh.batch_transport = mesh.data_transport or mesh.fsdp_transport
    return mesh


# ---------------------------------------------------------------------------
# Sharding rules for the stacked Qwen2 tree (+ optional LoRA subtree), in
# JAX's layout: a spec is a tuple of axis names or None per dim
# ---------------------------------------------------------------------------

_RULES = {
    ("embed_tokens",): ("tensor", "fsdp"),
    ("norm",): (None,),
    ("lm_head",): ("fsdp", "tensor"),
    # attention: out-features sharded by tensor, in-features by fsdp
    ("layers", "q_proj", "kernel"): (None, "fsdp", "tensor"),
    ("layers", "k_proj", "kernel"): (None, "fsdp", "tensor"),
    ("layers", "v_proj", "kernel"): (None, "fsdp", "tensor"),
    ("layers", "q_proj", "bias"): (None, "tensor"),
    ("layers", "k_proj", "bias"): (None, "tensor"),
    ("layers", "v_proj", "bias"): (None, "tensor"),
    ("layers", "o_proj", "kernel"): (None, "tensor", "fsdp"),
    # mlp: intermediate dim by tensor
    ("layers", "gate_proj", "kernel"): (None, "fsdp", "tensor"),
    ("layers", "up_proj", "kernel"): (None, "fsdp", "tensor"),
    ("layers", "down_proj", "kernel"): (None, "tensor", "fsdp"),
    ("layers", "input_layernorm"): (None, None),
    ("layers", "post_attention_layernorm"): (None, None),
    # LoRA: A shards like the input dim, B like the output dim
    ("a",): (None, "fsdp", None),
    ("b",): (None, None, "tensor"),
}

_RULES_BY_LEN = sorted(_RULES.items(), key=lambda kv: -len(kv[0]))

# leaves whose last two axes swap between JAX's layout and the port's
_TRANSPOSED = ("kernel", "kernel_q", "lm_head", "a", "b")


def _spec_for_path(path: tuple) -> tuple:
    """JAX's spec (in JAX's layout) for a leaf path."""
    # int8 rollout kernels (core/quant.py): kernel_q shards exactly like the
    # kernel it replaces; its per-output-channel scale [L, 1, out] keeps the
    # kernel's out-axis sharding with the contracted axis unsharded
    if path and path[-1] == "kernel_q":
        path = path[:-1] + ("kernel",)
    elif path and path[-1] == "kernel_scale":
        kspec = _spec_for_path(path[:-1] + ("kernel",))
        return tuple(list(kspec)[:-2] + [None, list(kspec)[-1]]) \
            if len(kspec) >= 2 else kspec
    for suffix, spec in _RULES_BY_LEN:
        if path[-len(suffix):] == suffix:
            return spec
    return ()  # replicate anything unmatched


def _strip(path: tuple) -> tuple:
    # a leading "lora" namespace reuses the layer rules
    return path[1:] if path and path[0] == "lora" else path


def _map(tree: dict, fn, prefix: tuple = ()) -> dict:
    return {k: _map(v, fn, prefix + (k,)) if isinstance(v, dict) else fn(prefix + (k,), v)
            for k, v in tree.items()}


def param_sharding_rules(params: dict) -> dict:
    """JAX's spec tree for `params` (tuples in JAX's layout; LoRA subtrees
    too): `nanorlhf_tpu.parallel.mesh.param_sharding_rules` spec for spec."""
    return _map(params, lambda path, leaf: _spec_for_path(_strip(path)))


def port_spec(path: tuple, ndim: int) -> tuple:
    """The spec of the port's leaf at `path` with `ndim` dims: JAX's,
    padded to `ndim`, with the last two entries swapped for the leaves the
    bridge transposes."""
    spec = list(_spec_for_path(_strip(path)))
    spec += [None] * (ndim - len(spec))
    if path[-1] in _TRANSPOSED and ndim >= 2:
        spec[-1], spec[-2] = spec[-2], spec[-1]
    return tuple(spec)


def fsdp_dim(path: tuple, ndim: int) -> int | None:
    """The dim of the port's leaf at `path` that the fsdp axis shards
    (None: replicated over fsdp). Tensor entries replicate while tensor
    is 1."""
    spec = port_spec(path, ndim)
    return spec.index("fsdp") if "fsdp" in spec else None


def shard_leaf(t: torch.Tensor, path: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of a full leaf along its fsdp dim."""
    dim = fsdp_dim(path, t.dim()) if mesh.fsdp > 1 else None
    if dim is None:
        return t
    if t.shape[dim] % mesh.fsdp:
        raise ValueError(
            f"leaf {'/'.join(path)} {tuple(t.shape)}: dim {dim} ({t.shape[dim]}) is "
            f"not divisible by fsdp={mesh.fsdp}")
    n = t.shape[dim] // mesh.fsdp
    return t.narrow(dim, mesh.fsdp_rank * n, n).clone()


def shard_params(params: dict, mesh: Mesh, memo: dict | None = None) -> dict:
    """`params` with each fsdp-marked leaf cut to this rank's contiguous
    slice (a fresh tensor; the full one is released with the tree). `memo`
    ({id(full leaf): shard}) keeps leaves that two trees share shared —
    the ref's frozen base with the policy's. ValueError naming the leaf
    when its fsdp dim does not divide."""
    memo = {} if memo is None else memo

    def leaf(path, t):
        if id(t) not in memo:
            memo[id(t)] = (t, shard_leaf(t, path, mesh))
        return memo[id(t)][1]

    return _map(params, leaf)


def batch_sharding(mesh: Mesh | None, rows: int) -> slice:
    """This rank's contiguous block of `rows`: block i_d·f + i_f of d·f
    (JAX shards the batch dim over (data, fsdp)); the whole range without
    batch ranks. ValueError when `rows` does not split."""
    n = 1 if mesh is None else mesh.batch
    if n == 1:
        return slice(0, rows)
    if rows % n:
        raise ValueError(f"{rows} rows do not split over data x fsdp = {n} batch ranks")
    k = rows // n
    return slice(mesh.batch_rank * k, (mesh.batch_rank + 1) * k)


def own_rows(mesh: Mesh | None, local: torch.Tensor) -> torch.Tensor:
    """The global rows [n·k, ...] on every batch rank from each rank's
    block [k, ...]: this rank's block keeps its autograd graph, the others
    are values. A loss of the result is the same number on every rank and
    each rank's backward carries only its own rows' part, so the gradients
    summed over the batch ranks are those of ONE loss over the global rows
    (the same trick as `parallel.sp`'s sequence shards)."""
    if mesh is None or mesh.batch == 1:
        return local
    parts = mesh.batch_transport.all_gather(local)
    parts[mesh.batch_rank] = local
    return torch.cat(parts, dim=0)


def ring(mesh: Mesh | None) -> bool:
    """The sequence-parallel ring is on."""
    return mesh is not None and mesh.sp > 1


def fsdp_axis(mesh: Mesh | None) -> str | None:
    """"fsdp" when the params are sharded over an fsdp group, else None."""
    return "fsdp" if mesh is not None and mesh.fsdp > 1 else None


__all__ = ["A14C", "Mesh", "MeshConfig", "batch_sharding", "fsdp_axis", "fsdp_dim",
           "make_mesh", "own_rows", "param_sharding_rules",
           "port_spec", "ring", "shard_params"]
