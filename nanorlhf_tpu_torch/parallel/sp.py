"""Sequence-parallel forward, scoring and value passes — the port of
`nanorlhf_tpu/parallel/sp.py` (`sp_forward_logits`, `sp_score_logprobs`,
`sp_score_values`) over the ranks of the sp group.

Rank r of N holds the sequence shard [r·T/N, (r+1)·T/N) of every row: the
embedding, RMSNorm, RoPE (at the GLOBAL positions of the left-pad cumsum,
computed on the replicated global ids), the projections and the MLP are
position-local; attention runs around the ring (`ring_attention.py`). The
attention choice is JAX's `_ring_attn_fn`: the flash ring where the
kernels route (`core.model.use_kernel`), the einsum ring otherwise.

The per-shard logits [B, T/N, V] are reduced to per-token scalars (the
logprob of the next token, the entropy) before anything global is
assembled, so the global [B, T, V] block never exists: sequence
parallelism is this path's logits-memory lever, and K10 is not on it, as
in JAX. Labels cross shard edges: the last position of shard r predicts
the first token of shard r + 1, taken from the replicated global ids.

The global [B, T] result is gathered on every rank with the rank's OWN
shard still carrying its autograd graph and the other shards as values
(detached). A loss computed from it on every rank is the same number
everywhere, and each rank's backward carries only its own shard's part
(plus, through the ring's dK/dV hops, the parts its keys and values fed
other ranks' queries): summing the gradients over the group gives the
gradient of ONE loss. An autograd-aware gather would count it N times.

With `fsdp_axis="fsdp"` (and `sp_fsdp_forward_logits`) the params are
sharded over the mesh's fsdp group at rest and each forward reads
`parallel.fsdp.forward_view`: the embedding and heads gathered up front,
each layer gathered as it runs (JAX's `_sp_fsdp_forward_local`), the
gradients reduce-scattered back onto the shards.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.core.model import (
    _hidden_from_inputs,
    _logits,
    padding_inputs,
    rms_norm,
    use_kernel,
)
from nanorlhf_tpu_torch.ops.masking import (
    entropy_from_logits,
    guard_temperature,
    logprobs_from_logits,
)
from nanorlhf_tpu_torch.parallel.fsdp import forward_view
from nanorlhf_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_flash


def _ring_attn_fn(key_valid, transport, attn_impl: str):
    """The ring for this rank's shard (JAX's `_ring_attn_fn`): the flash
    ring where `attn_impl` routes to the kernels, the einsum ring
    otherwise. Scoring and update callers pass the same `attn_impl`, so
    their exp(new − old) ratios carry no kernel-mismatch offset."""
    def attn(q, k, v):
        ring = ring_attention_flash if use_kernel(attn_impl, q) else ring_attention
        return ring(q, k, v, key_valid, transport, causal=True)
    return attn


def _shard(mesh, width: int) -> slice:
    n = mesh.sp
    if width % n:
        raise ValueError(f"sequence width {width} not divisible by sp={n}; pick "
                         "prompt/response widths as multiples of sp")
    t = width // n
    return slice(mesh.sp_rank * t, (mesh.sp_rank + 1) * t)


def _view(params, mesh, fsdp_axis):
    """(tree, layer_transform) the forward reads: the fsdp view when
    `fsdp_axis` names the mesh's fsdp axis, else the tree as it is."""
    if fsdp_axis is None:
        return params, None
    if fsdp_axis != "fsdp":
        raise ValueError(f"fsdp_axis={fsdp_axis!r}: the port's mesh names it 'fsdp'")
    return forward_view(params, mesh)


def _sp_hidden_local(params, config, input_ids, attention_mask, position_ids, mesh,
                     lora_scale, remat, attn_impl, layer_transform=None):
    """This rank's shard through the shared forward recipe, attention
    routed around the ring: final hidden states [B, T/N, D] (not normed)."""
    sl = _shard(mesh, input_ids.shape[1])
    key_valid = attention_mask[:, sl].bool()
    return _hidden_from_inputs(
        params, config, input_ids[:, sl], key_valid, position_ids[:, sl], lora_scale,
        remat, attn_fn=_ring_attn_fn(key_valid, mesh.transport,
                                     attn_impl or config.attention_impl),
        layer_transform=layer_transform)


def _gather_own(mesh, local: torch.Tensor) -> torch.Tensor:
    """The global [B, T, ...] tensor on every rank from each rank's shard
    along dim 1: this rank's shard keeps its graph, the others are values
    (module docstring)."""
    parts = mesh.transport.all_gather(local)
    parts[mesh.sp_rank] = local
    return torch.cat(parts, dim=1)


def sp_forward_logits(params, config, input_ids, attention_mask, position_ids, mesh,
                      lora_scale: float = 1.0, remat: bool = False,
                      attn_impl: str | None = None,
                      fsdp_axis: str | None = None) -> torch.Tensor:
    """Full-model forward with the sequence dim sharded over the sp group:
    global [B, T] ids, mask and positions in (T divisible by N), THIS
    rank's logits shard [B, T/N, V] out (JAX returns the global array
    sharded over T; here each rank holds its shard). `fsdp_axis`: the
    params are sharded over the mesh's fsdp group (`_view`)."""
    params, hook = _view(params, mesh, fsdp_axis)
    x = _sp_hidden_local(params, config, input_ids, attention_mask, position_ids, mesh,
                         lora_scale, remat, attn_impl, hook)
    return _logits(config, params, x)


def sp_fsdp_forward_logits(params, config, input_ids, attention_mask, position_ids,
                           mesh, lora_scale: float = 1.0, remat: bool = False,
                           attn_impl: str | None = None) -> torch.Tensor:
    """`sp_forward_logits` with fsdp-sharded params (JAX's
    `sp_fsdp_forward_logits`): sharded at rest, the embedding gathered up
    front, each layer gathered one at a time, the head last; resident
    params per rank ≈ params / fsdp + one whole layer + the embedding
    (and an untied head)."""
    return sp_forward_logits(params, config, input_ids, attention_mask, position_ids,
                             mesh, lora_scale, remat, attn_impl, fsdp_axis="fsdp")


def sp_score_logprobs(params, config, query_responses, pad_token_id: int,
                      temperature: float, mesh, lora_scale: float = 1.0,
                      remat: bool = False, with_entropy: bool = False,
                      entropy_from_position: int = 0, attn_impl: str | None = None,
                      fsdp_axis: str | None = None, entropy_rows: bool = False):
    """Per-position next-token logprobs [B, T] f32 under sequence
    parallelism: entry t holds log p(token_{t+1} | tokens_{<=t}), the final
    position 0. Callers slice [:, ctx-1:T-1] for the response logprobs, as
    on one device. `with_entropy` also returns the mean entropy of the
    temperature-scaled logits over global positions [entropy_from_position,
    T-1) (callers pass context_length - 1, the dense path's scope), summed
    per shard and reduced over the group. The result is the same on every
    rank; only this rank's shard carries its graph (module docstring).
    `entropy_rows`: the entropy is each row's mean [B] instead (their mean
    is the scalar). `fsdp_axis`: the params are sharded over the fsdp group
    (`_view`)."""
    input_ids, attention_mask, position_ids = padding_inputs(query_responses, pad_token_id)
    T = query_responses.shape[1]
    sl = _shard(mesh, T)
    logits = sp_forward_logits(params, config, input_ids, attention_mask, position_ids,
                               mesh, lora_scale, remat, attn_impl, fsdp_axis)
    # the label of local position t is the global id at t + 1 (the last
    # shard's last label wraps around; that position is set to 0 below)
    labels = torch.roll(query_responses, -1, dims=1)[:, sl]
    lp = logprobs_from_logits(logits, labels, temperature)
    entropy = None
    if with_entropy:
        gpos = torch.arange(sl.start, sl.stop, device=logits.device)
        in_span = ((gpos >= entropy_from_position) & (gpos < T - 1)).float()
        with torch.no_grad():
            ent = entropy_from_logits(logits.float() / guard_temperature(temperature))
            sums = torch.cat([(ent * in_span).sum(1),
                              in_span.sum().reshape(1)]).float()
            mesh.transport.all_reduce_sum_([sums])
        per_row = sums[:-1] / torch.clamp_min(sums[-1], 1.0)
        entropy = per_row if entropy_rows else per_row.mean()
    lp = _gather_own(mesh, lp)
    lp = torch.cat([lp[:, :-1], torch.zeros_like(lp[:, -1:])], dim=1)
    return (lp, entropy) if with_entropy else lp


def sp_score_values(params, config, query_responses, pad_token_id: int, mesh,
                    lora_scale: float = 1.0, remat: bool = False,
                    attn_impl: str | None = None,
                    fsdp_axis: str | None = None) -> torch.Tensor:
    """Per-position value/RM scores [B, T, num_labels] f32 under sequence
    parallelism (`core.model.score_forward` at ring scale: the final-normed
    hidden states of each shard times the score head, in f32; nothing
    crosses shard edges after the ring). Same on every rank; only this
    rank's shard carries its graph."""
    input_ids, attention_mask, position_ids = padding_inputs(query_responses, pad_token_id)
    params, hook = _view(params, mesh, fsdp_axis)
    x = _sp_hidden_local(params, config, input_ids, attention_mask, position_ids, mesh,
                         lora_scale, remat, attn_impl, hook)
    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    return _gather_own(mesh, x.float() @ params["score"].float())
