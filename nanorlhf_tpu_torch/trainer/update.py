"""One optimizer step of the GRPO update — the port of the trainer's
`_make_update_fn` (`nanorlhf_tpu/trainer/trainer.py:1275-1500`): the
microbatch loss and the gradient-accumulated minibatch step, as plain
functions over the trainer's tensors.

- `microbatch_loss`: the policy's response logprobs (the fused path, with
  per-layer remat when `gradient_checkpointing`) → `INVALID_LOGPROB` at
  pads → `grpo_loss`; the entropy stat is the detached, unmasked mean of
  the fused op's per-token entropy.
- `update_minibatch`: microbatch g is the strided row set {g, G+g, …} (the
  JAX `reshape(-1, grad_accum)`); gradients of the trainable leaves only
  accumulate in f32, are divided by `grad_accum`, and AdamW steps the
  leaves in place. Stats are means over the microbatches, plus the
  pre-clip `grad_norm`.

Not ported (raise): the naive full-logits branch (`fused_logprob=False`),
sequence parallelism, the value head (PPO), the other algorithms' losses,
the env `loss_mask` and in-flight-swap segment ages.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.algos.losses import grpo_loss
from nanorlhf_tpu_torch.ops.masking import INVALID_LOGPROB
from nanorlhf_tpu_torch.trainer.config import AlgoName
from nanorlhf_tpu_torch.trainer.optim import AdamW, AdamWState, flatten, global_norm, unflatten
from nanorlhf_tpu_torch.trainer.scoring import fused_response_logprobs

# minibatch keys the GRPO update reads; anything else is an unported path
_GRPO_KEYS = {"query_responses", "responses", "logprobs", "ref_logprobs",
              "advantages", "padding_mask", "padding_mask_p1"}


def check_update_supported(cfg, minibatch: dict) -> None:
    unported = {
        "algo != GRPO": cfg.algo != AlgoName.GRPO,
        "sequence parallelism (mesh.sp > 1)": cfg.mesh.sp > 1,
        "the naive update branch (fused_logprob=False)": not cfg.fused_logprob,
    }
    extra = sorted(set(minibatch) - _GRPO_KEYS)
    if extra:
        unported[f"minibatch keys {extra} (value head, loss_mask, behavior "
                 "logprobs, segment ages)"] = True
    on = [what for what, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"not ported to nanorlhf_tpu_torch yet: {', '.join(on)}")


def microbatch_loss(policy: dict, mcfg, cfg, mb: dict, context_length: int,
                    pad_id: int, lora_scale: float, remat: bool):
    """(loss, aux) of one microbatch; aux holds the detached GRPO stats and
    `entropy`."""
    new_logprobs, ent_tok = fused_response_logprobs(
        policy, mcfg, mb["query_responses"], mb["responses"], pad_id,
        context_length, cfg, lora_scale=lora_scale, with_entropy=True,
        remat=remat)
    entropy = ent_tok.mean().detach()
    new_logprobs = torch.where(mb["padding_mask"],
                               torch.full_like(new_logprobs, INVALID_LOGPROB),
                               new_logprobs)
    loss, aux = grpo_loss(new_logprobs, mb["logprobs"], mb["ref_logprobs"],
                          mb["advantages"], ~mb["padding_mask"], cfg.cliprange,
                          cfg.kl_coef)
    aux["entropy"] = entropy
    return loss, aux


def update_minibatch(policy: dict, trainable: dict, optimizer: AdamW,
                     opt_state: AdamWState, minibatch: dict, mcfg, cfg,
                     context_length: int, pad_id: int, lora_scale: float):
    """One optimizer step over `gradient_accumulation_steps` microbatches.
    `trainable` holds the policy's trainable leaves (the same tensors, with
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
                                    remat=cfg.gradient_checkpointing)
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
