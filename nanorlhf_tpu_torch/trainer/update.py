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
there only in multi-turn runs.

Not ported (raise): sequence parallelism, behavior logprobs and
in-flight-swap segment ages.
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
from nanorlhf_tpu_torch.trainer.config import AlgoName
from nanorlhf_tpu_torch.trainer.optim import MultiAdamW, flatten, global_norm, unflatten
from nanorlhf_tpu_torch.trainer.scoring import fused_response_logprobs

# minibatch keys the update reads (each algorithm a subset); anything else
# is an unported path
_KEYS = {"query_responses", "responses", "logprobs", "ref_logprobs",
         "advantages", "advantages_seq", "returns", "values",
         "padding_mask", "padding_mask_p1", "loss_mask"}


def check_update_supported(cfg, minibatch: dict) -> None:
    unported = {
        "sequence parallelism (mesh.sp > 1)": cfg.mesh.sp > 1,
    }
    extra = sorted(set(minibatch) - _KEYS)
    if extra:
        unported[f"minibatch keys {extra} (behavior logprobs, segment ages)"] = True
    on = [what for what, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"not ported to nanorlhf_tpu_torch yet: {', '.join(on)}")


def microbatch_loss(policy: dict, mcfg, cfg, mb: dict, context_length: int,
                    pad_id: int, lora_scale: float, remat: bool,
                    value: dict | None = None, value_lora_scale: float = 1.0):
    """(loss, aux) of one microbatch; aux holds the detached stats of the
    algorithm's loss and `entropy`. `value` is PPO's value tree."""
    if cfg.fused_logprob:
        new_logprobs, ent_tok = fused_response_logprobs(
            policy, mcfg, mb["query_responses"], mb["responses"], pad_id,
            context_length, cfg, lora_scale=lora_scale, with_entropy=True,
            remat=remat)
    else:
        logits = padded_forward_logits(
            policy, mcfg, mb["query_responses"], pad_id, lora_scale=lora_scale,
            response_context_length=context_length, remat=remat)
        ent_tok = chunked_entropy(logits, cfg.temperature, chunk=cfg.fused_logprob_chunk)
        new_logprobs = logprobs_from_logits(logits, mb["responses"], cfg.temperature)
    entropy = ent_tok.mean().detach()
    new_logprobs = torch.where(mb["padding_mask"],
                               torch.full_like(new_logprobs, INVALID_LOGPROB),
                               new_logprobs)
    mask = ~mb["padding_mask"]
    if "loss_mask" in mb:
        mask = mask & mb["loss_mask"]
    algo = cfg.algo
    if algo == AlgoName.GRPO:
        loss, aux = grpo_loss(new_logprobs, mb["logprobs"], mb["ref_logprobs"],
                              mb["advantages"], mask, cfg.cliprange, cfg.kl_coef)
    elif algo == AlgoName.RLOO:
        loss, aux = ppo_clip_loss_sequence(new_logprobs, mb["logprobs"],
                                           mb["advantages_seq"], mask, cfg.cliprange)
    elif algo == AlgoName.RAFT:
        loss, aux = sft_loss(new_logprobs, mask)
    else:  # PPO, REINFORCE, ReMax: token-level PPO-clip
        loss, aux = ppo_clip_loss_token(new_logprobs, mb["logprobs"],
                                        mb["advantages"], mask, cfg.cliprange)
    if algo == AlgoName.PPO:
        vpred = score_forward(value, mcfg, mb["query_responses"], pad_id,
                              lora_scale=value_lora_scale,
                              remat=remat)[:, context_length - 1:-1, 0]
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
                     value: dict | None = None, value_lora_scale: float = 1.0):
    """One optimizer step over `gradient_accumulation_steps` microbatches.
    `trainable` holds the trainable leaves by group, `{"policy": ...}` and
    for PPO `"value"` (the same tensors as in `policy` / `value`, with
    requires_grad); they are updated in place. Returns (opt_state, stats)
    with python-float stats."""
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
                                    value=value, value_lora_scale=value_lora_scale)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        for a, gr in zip(acc, grads):
            if gr is not None:
                a.add_(gr)
        auxes.append(aux)
    grads = unflatten({p: a.div_(grad_accum) for p, a in zip(paths, acc)})
    grad_norm = global_norm(flatten(grads).values())
    opt_state = optimizer.step(trainable, grads, opt_state)
    stats = {k: float(torch.stack([a[k].float() for a in auxes]).mean())
             for k in auxes[0]}
    stats["grad_norm"] = float(grad_norm)
    return opt_state, stats
