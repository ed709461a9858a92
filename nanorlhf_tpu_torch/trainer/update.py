"""One optimizer step of the update — the port of the trainer's
`_make_update_fn` (`nanorlhf_tpu/trainer/trainer.py:1275-1500`): the
microbatch loss and the gradient-accumulated minibatch step, as plain
functions over the trainer's tensors.

- `microbatch_loss`: the policy's response logprobs (with per-layer remat
  when `gradient_checkpointing`) → `INVALID_LOGPROB` at
  pads → the algorithm's loss: GRPO `grpo_loss`; RLOO the sequence-level
  PPO-clip on `advantages_seq`; RAFT `sft_loss`; REINFORCE and ReMax the
  token-level PPO-clip; PPO the token-level PPO-clip + `vf_coef` · the
  clipped value loss of the value tree's `score_forward` (with remat).
  The logprobs come from the fused hidden→logprob op (`fused_logprob`,
  the default) or, on the naive branch, from the full [rows, T, V] logits
  (`padded_forward_logits`, then `logprobs_from_logits`). The entropy stat
  is the detached, unmasked mean of the per-token entropy: the fused op's,
  or `chunked_entropy` of the naive branch's logits.
- `update_minibatch`: microbatch g is the strided row set {g, G+g, …} (the
  JAX `reshape(-1, grad_accum)`); gradients of every group's trainable
  leaves accumulate in f32, are divided by `grad_accum`, and each group's
  AdamW steps its leaves in place. Stats are means over the microbatches,
  plus the pre-clip `grad_norm` over both groups' gradients.

A multi-turn environment's `loss_mask` (False on observation tokens) joins
the pad mask upstream of every algorithm's loss, as in JAX; the key is
there only in multi-turn runs. The truncated-IS correction of the async
orchestrator rides the same way (JAX trainer.py:1284-1290): the minibatch
carries `behavior_logprobs` (the sampler-captured logprobs of the policy
that sampled the tokens) in every minibatch of a run whose trainer uses IS
and in none otherwise, and `segment_ages` under in-flight weight swaps;
the PPO-style losses re-weight by them at `offpolicy_is_truncation` (RAFT's
SFT loss has no ratio to correct).

Sequence parallelism (`mesh` with sp > 1, JAX's `_sp_on` branch): the
policy's logprobs and entropy (and PPO's values) come from the ring
(`parallel.sp`), the same on every rank with only the rank's own shard
carrying its graph, so each rank's backward holds its part of ONE loss;
after the microbatches the accumulated gradients are summed over the sp
group, then AdamW steps on every rank alike.

Batch ranks (`mesh` with data × fsdp > 1): every rank holds the global
minibatch; each forwards its own block of each microbatch's rows
(`batch_sharding`) and gathers the others' per-token logprobs (PPO: values)
as values (`parallel.mesh.own_rows`), so the loss is the GLOBAL masked
mean — the same number on every rank — and each rank's backward carries
its own rows' part of it. An average of per-rank means would weight the
ranks' tokens unequally whenever their valid-token counts differ. The
gradient sum is then `parallel.fsdp.reduce_grads` (fsdp-sharded leaves
were reduce-scattered inside the forward's gathers), the norm and the clip
are the unsharded tree's (`parallel.fsdp.group_norms`, computed once per
step for the stat and every group's clip), and each rank's AdamW steps its
own shards.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.algos.losses import (
    grpo_loss,
    ppo_clip_loss_sequence,
    ppo_clip_loss_token,
    sft_loss,
    value_loss_clipped,
)
from nanorlhf_tpu_torch.core.model import padded_forward_logits, score_forward
from nanorlhf_tpu_torch.ops.fused_logprob import chunked_entropy
from nanorlhf_tpu_torch.ops.masking import INVALID_LOGPROB, logprobs_from_logits
from nanorlhf_tpu_torch.parallel.fsdp import forward_view, group_norms, reduce_grads
from nanorlhf_tpu_torch.parallel.mesh import (
    batch_sharding,
    fsdp_axis,
    own_rows,
    ring,
)
from nanorlhf_tpu_torch.parallel.sp import sp_score_logprobs, sp_score_values
from nanorlhf_tpu_torch.trainer.config import AlgoName
from nanorlhf_tpu_torch.trainer.optim import MultiAdamW, flatten, unflatten
from nanorlhf_tpu_torch.trainer.scoring import fused_response_logprobs

# minibatch keys the update reads (each algorithm a subset); anything else
# is an unported path
_KEYS = {"query_responses", "responses", "logprobs", "ref_logprobs",
         "advantages", "advantages_seq", "returns", "values",
         "padding_mask", "padding_mask_p1", "loss_mask",
         "behavior_logprobs", "segment_ages"}


def check_update_supported(cfg, minibatch: dict) -> None:
    extra = sorted(set(minibatch) - _KEYS)
    if extra:
        raise NotImplementedError(
            f"not ported to nanorlhf_tpu_torch yet: minibatch keys {extra}")


def microbatch_loss(policy: dict, mcfg, cfg, mb: dict, context_length: int,
                    pad_id: int, lora_scale: float, remat: bool,
                    value: dict | None = None, value_lora_scale: float = 1.0,
                    mesh=None):
    """(loss, aux) of one microbatch; aux holds the detached stats of the
    algorithm's loss and `entropy`. `value` is PPO's value tree; `mesh`:
    sp > 1 routes the forwards around the ring, batch ranks forward their
    block of the rows and the loss is the global one (module docstring)."""
    rows = batch_sharding(mesh, mb["responses"].shape[0])
    qr, responses = mb["query_responses"][rows], mb["responses"][rows]
    if ring(mesh):
        lp, ent_tok = sp_score_logprobs(
            policy, mcfg, qr, pad_id, cfg.temperature, mesh,
            lora_scale=lora_scale, remat=remat, with_entropy=True,
            entropy_from_position=context_length - 1, fsdp_axis=fsdp_axis(mesh),
            entropy_rows=True)
        new_logprobs = lp[:, context_length - 1:-1]
    elif cfg.fused_logprob:
        new_logprobs, ent_tok = fused_response_logprobs(
            policy, mcfg, qr, responses, pad_id, context_length, cfg,
            lora_scale=lora_scale, with_entropy=True, remat=remat, mesh=mesh)
    else:
        view, hook = forward_view(policy, mesh)
        logits = padded_forward_logits(
            view, mcfg, qr, pad_id, lora_scale=lora_scale,
            response_context_length=context_length, remat=remat, layer_transform=hook)
        ent_tok = chunked_entropy(logits, cfg.temperature, chunk=cfg.fused_logprob_chunk)
        new_logprobs = logprobs_from_logits(logits, responses, cfg.temperature)
    # the entropy stat over the rows of JAX's bucket: `menu_rows` when the
    # sparse trainer padded a bucket past its rows menu for the batch ranks
    # (those masked rows are not JAX's); every row otherwise
    ent_rows = own_rows(mesh, ent_tok.detach().reshape(ent_tok.shape[0], -1).mean(1))
    entropy = ent_rows[:int(mb.get("menu_rows", ent_rows.shape[0]))].mean()
    new_logprobs = own_rows(mesh, new_logprobs)
    new_logprobs = torch.where(mb["padding_mask"],
                               torch.full_like(new_logprobs, INVALID_LOGPROB),
                               new_logprobs)
    mask = ~mb["padding_mask"]
    if "loss_mask" in mb:
        mask = mask & mb["loss_mask"]
    # the stale behavior policy's logprobs (truncated IS) and the tokens'
    # policy ages (in-flight swaps): absent keys keep the synchronous loss
    is_kw = dict(behavior_logprobs=mb.get("behavior_logprobs"),
                 is_truncation=cfg.offpolicy_is_truncation,
                 segment_ages=mb.get("segment_ages"))
    algo = cfg.algo
    if algo == AlgoName.GRPO:
        loss, aux = grpo_loss(new_logprobs, mb["logprobs"], mb["ref_logprobs"],
                              mb["advantages"], mask, cfg.cliprange, cfg.kl_coef,
                              **is_kw)
    elif algo == AlgoName.RLOO:
        loss, aux = ppo_clip_loss_sequence(new_logprobs, mb["logprobs"],
                                           mb["advantages_seq"], mask, cfg.cliprange,
                                           **is_kw)
    elif algo == AlgoName.RAFT:
        loss, aux = sft_loss(new_logprobs, mask)
    else:  # PPO, REINFORCE, ReMax: token-level PPO-clip
        loss, aux = ppo_clip_loss_token(new_logprobs, mb["logprobs"],
                                        mb["advantages"], mask, cfg.cliprange,
                                        **is_kw)
    if algo == AlgoName.PPO:
        if ring(mesh):
            vpred = sp_score_values(value, mcfg, qr, pad_id, mesh,
                                    lora_scale=value_lora_scale, remat=remat,
                                    fsdp_axis=fsdp_axis(mesh))
        else:
            view, hook = forward_view(value, mesh)
            vpred = score_forward(view, mcfg, qr, pad_id, lora_scale=value_lora_scale,
                                  remat=remat, layer_transform=hook)
        vpred = own_rows(mesh, vpred[:, context_length - 1:-1, 0])
        pm1 = mb["padding_mask_p1"]
        vpred = torch.where(pm1, torch.zeros_like(vpred), vpred)
        vf_loss, vf_aux = value_loss_clipped(vpred, mb["values"], mb["returns"],
                                             ~pm1, cfg.cliprange_value)
        loss = loss + cfg.vf_coef * vf_loss
        aux.update(vf_aux)
    aux["entropy"] = entropy
    return loss, aux


def update_minibatch(policy: dict, trainable: dict, optimizer: MultiAdamW,
                     opt_state: dict, minibatch: dict, mcfg, cfg,
                     context_length: int, pad_id: int, lora_scale: float,
                     value: dict | None = None, value_lora_scale: float = 1.0,
                     mesh=None):
    """One optimizer step over `gradient_accumulation_steps` microbatches.
    `trainable` holds the trainable leaves by group, `{"policy": ...}` and
    for PPO `"value"` (the same tensors as in `policy` / `value`, with
    requires_grad); they are updated in place. Returns (opt_state, stats)
    with python-float stats. `mesh`: the microbatch forwards go around the
    sp ring and/or split their rows over the batch ranks, and the
    accumulated gradients are summed over the mesh (`reduce_grads`) before
    the step; the norm is the unsharded tree's (and so is the clip of an
    optimizer built over the mesh, `build_optimizer(cfg, mesh)`)."""
    check_update_supported(cfg, minibatch)
    grad_accum = cfg.gradient_accumulation_steps
    rows = minibatch["responses"].shape[0]
    if rows % grad_accum:
        raise ValueError(f"minibatch of {rows} rows does not split into "
                         f"{grad_accum} microbatches")
    leaves = flatten(trainable)
    paths, tensors = list(leaves), list(leaves.values())
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
    auxes = []
    for g in range(grad_accum):
        mb = {k: v[g::grad_accum] for k, v in minibatch.items()}
        loss, aux = microbatch_loss(policy, mcfg, cfg, mb, context_length,
                                    pad_id, lora_scale,
                                    remat=cfg.gradient_checkpointing,
                                    value=value, value_lora_scale=value_lora_scale,
                                    mesh=mesh)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        for a, gr in zip(acc, grads):
            if gr is not None:
                a.add_(gr)
        auxes.append(aux)
    reduce_grads(mesh, paths, acc)
    grads = unflatten({p: a.div_(grad_accum) for p, a in zip(paths, acc)})
    norms = group_norms({k: flatten(v) for k, v in grads.items()}, mesh)
    grad_norm = torch.sqrt(sum(n.square() for n in norms.values()))
    opt_state = optimizer.step(trainable, grads, opt_state, norms=norms)
    stats = {k: float(torch.stack([a[k].float() for a in auxes]).mean())
             for k in auxes[0]}
    stats["grad_norm"] = float(grad_norm)
    return opt_state, stats
