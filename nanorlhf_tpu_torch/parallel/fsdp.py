"""The fsdp axis's execution model — the port of the ZeRO-3 forward that
JAX's `_sp_fsdp_forward_local` describes (`nanorlhf_tpu/parallel/sp.py:
143-194`), and what GSPMD does for the dense passes of a trainer whose
params `shard_params` placed over an fsdp axis.

Params and AdamW moments stay sharded at rest (`parallel.mesh.
shard_params`). A forward reads a VIEW of the tree (`forward_view`): the
embedding gathered up front (the lookup needs it whole; tied models reuse
it as the head), the untied head and the score head beside it, and each
layer's leaves and its LoRA leaves gathered one layer at a time through
`core.model._run_layers`'s `layer_transform` hook. Under remat the gather
sits inside the checkpointed layer, so the backward's recompute gathers
the layer again, as JAX's scan does.

`gather_shard` is the gather: its forward is the tiled all-gather over
the fsdp group, its backward the reduce-scatter (the all-gather's
transpose), so the gradient of a sharded leaf comes out sharded like the
leaf and already summed over the fsdp group's rows. What remains of the
gradient sum is `reduce_grads`: sharded leaves over the data group,
replicated leaves (norms, biases, the score head) over the whole (data,
fsdp) batch line, and every leaf over the sp ring.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.parallel.mesh import fsdp_dim, port_spec


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, transport):
        ctx.dim, ctx.transport = dim, transport
        return transport.all_gather_dim(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.transport.reduce_scatter_sum(grad, ctx.dim)
        return g.to(grad.dtype), None, None


def gather_shard(shard: torch.Tensor, dim: int, transport) -> torch.Tensor:
    """The whole leaf from each fsdp rank's contiguous slice along `dim`
    (differentiable: the backward reduce-scatters the gradient, in f32)."""
    return _GatherShard.apply(shard, dim, transport)


def _on(mesh) -> bool:
    return mesh is not None and mesh.fsdp > 1


def _gather_tree(tree: dict | None, prefix: tuple, mesh, lead: int = 0):
    """Each leaf of `tree` (paths under `prefix`) gathered along its fsdp
    dim; `lead` dims of the stacked layout were consumed (a layer slice)."""
    if tree is None:
        return None
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out[k] = _gather_tree(v, path, mesh, lead)
            continue
        dim = fsdp_dim(path, v.dim() + lead)
        out[k] = v if dim is None else gather_shard(v, dim - lead, mesh.fsdp_transport)
    return out


def forward_view(params: dict, mesh):
    """(view, layer_transform) of a sharded tree for one forward: the
    top-level leaves gathered (differentiable), `layers` and `lora` left
    sharded and gathered per layer by the returned hook. Without fsdp:
    `(params, None)`."""
    if not _on(mesh):
        return params, None
    view = dict(params)
    for k in ("embed_tokens", "lm_head", "norm", "score"):
        if k in params:
            view[k] = _gather_tree({k: params[k]}, (), mesh)[k]

    def layer_transform(layer, lora_layer):
        # a layer slice of the stacked [L, ...] leaves: one lead dim consumed
        return (_gather_tree(layer, ("layers",), mesh, lead=1),
                _gather_tree(lora_layer, ("lora", "layers"), mesh, lead=1))

    return view, layer_transform


@torch.no_grad()
def full_tree(tree: dict, mesh, prefix: tuple = ()) -> dict:
    """Every leaf of a sharded tree (params, an AdamW moment tree, the
    rollout view) gathered whole, detached (the checkpoint's and the
    rollout's copy); `prefix` is the tree's path in the policy."""
    if not _on(mesh):
        return tree
    return _gather_tree(tree, prefix, mesh)


@torch.no_grad()
def shard_of(full: torch.Tensor, path: tuple, mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf read from a checkpoint."""
    dim = fsdp_dim(path, full.dim()) if _on(mesh) else None
    if dim is None:
        return full
    n = full.shape[dim] // mesh.fsdp
    return full.narrow(dim, mesh.fsdp_rank * n, n)


def _sharded(path: tuple, t: torch.Tensor, mesh) -> bool:
    return _on(mesh) and fsdp_dim(path, t.dim()) is not None


def reduce_grads(mesh, paths: list, grads: list, over_sp: bool = True) -> None:
    """Finish the gradient sum of one loss whose rows the batch ranks split
    (in place, f32): fsdp-sharded leaves were reduce-scattered inside
    `gather_shard` and are all-reduced over the data group; the others over
    the (data, fsdp) batch line; all of them over the sp ring (unless
    `over_sp` is False: a loss whose sequence the ring did not split)."""
    if mesh is None:
        return
    sharded = [g for p, g in zip(paths, grads) if _sharded(p, g, mesh)]
    whole = [g for p, g in zip(paths, grads) if not _sharded(p, g, mesh)]
    if mesh.data > 1:
        mesh.data_transport.all_reduce_sum_(sharded)
    if mesh.batch > 1:
        mesh.batch_transport.all_reduce_sum_(whole)
    if over_sp and mesh.sp > 1:
        mesh.transport.all_reduce_sum_(grads)


def group_norms(groups: dict, mesh=None) -> dict:
    """{group: sqrt(Σ ‖g‖²)} of each group's UNSHARDED gradients
    (optax.global_norm per group) from {group: {path: leaf}}, in f32: the
    squares of fsdp-sharded leaves are summed over the fsdp group in one
    all-reduce for every group, a replicated leaf counts once."""
    keys = list(groups)
    dev = next(iter(groups[keys[0]].values())).device
    whole = torch.zeros(len(keys), device=dev)
    sharded = torch.zeros(len(keys), device=dev)
    for i, k in enumerate(keys):
        for p, g in groups[k].items():
            (sharded if _sharded(p, g, mesh) else whole)[i] += g.float().pow(2).sum()
    if _on(mesh):
        mesh.fsdp_transport.all_reduce_sum_([sharded])
    norms = torch.sqrt(whole + sharded)
    return {k: norms[i] for i, k in enumerate(keys)}


def rule_share(tree: dict, fsdp: int, prefix: tuple = ()) -> float:
    """The fraction of a whole tree's elements one rank holds at rest
    under `fsdp`, from the leaf shapes and `param_sharding_rules`."""
    held = total = 0
    stack = [(prefix, tree)]
    while stack:
        pre, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, dict):
                stack.append((pre + (k,), v))
                continue
            n = v.numel()
            total += n
            held += n // fsdp if "fsdp" in port_spec(pre + (k,), v.dim()) else n
    return held / max(total, 1)
