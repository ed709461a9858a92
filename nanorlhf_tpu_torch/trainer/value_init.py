"""PPO's value-model initializer — the port of
`nanorlhf_tpu/trainer/value_init.py`, the phase before PPO proper: roll
out one batch of prompts with the frozen policy (n = 1), shape the reward
with the policy/ref KL, take γ-discounted returns, and regress the value
model onto them with a masked MSE, an 80/20 train/val split, halving the
learning rate on a plateau and stopping early after
`early_stopping_patience` epochs without improvement.

The split and each epoch's permutation come from numpy's
`default_rng(0)` and `default_rng(epoch)`, as in JAX, so the two pick the
same rows; the rollout's draws come from the caller's torch generator.

On the trainer's mesh (`mesh`, JAX's "on the shared mesh"): the trees are
the trainer's fsdp shards. The one rollout is generated whole on every
rank from the gathered policy (the same generator on every rank, so the
same rows) and scored with the layers gathered as they run; each
regression batch splits its rows over the batch ranks (a loss over the
global rows, `parallel.mesh.own_rows`), the gradients are summed over the
mesh and every rank's Adam steps its shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nanorlhf_tpu_torch.algos.advantages import discounted_returns, sparse_terminal_rewards
from nanorlhf_tpu_torch.core.lora import value_trainable_mask
from nanorlhf_tpu_torch.core.model import (
    padded_forward_hidden,
    padded_forward_logits,
    score_forward,
    unembedding,
)
from nanorlhf_tpu_torch.ops.fused_logprob import fused_logprob
from nanorlhf_tpu_torch.ops.masking import (
    INVALID_LOGPROB,
    first_true_indices,
    logprobs_from_logits,
    masked_mean,
    masked_whiten,
    response_padding_masks,
    truncate_response,
)
from nanorlhf_tpu_torch.parallel.fsdp import forward_view, full_tree, reduce_grads
from nanorlhf_tpu_torch.parallel.mesh import batch_sharding, own_rows
from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate
from nanorlhf_tpu_torch.trainer.optim import AdamW, flatten, unflatten
from nanorlhf_tpu_torch.trainer.trainer import _trainable_leaves


@dataclasses.dataclass
class ValueInitConfig:
    """The JAX `ValueInitConfig`, field for field."""

    train_data_size: int = 500
    num_train_epochs: int = 8
    per_device_train_batch_size: int = 8
    learning_rate: float = 5e-5
    train_split_rate: float = 0.8
    early_stopping_patience: int = 3
    # reduce on plateau: halve on every epoch that does not improve
    plateau_factor: float = 0.5
    plateau_patience: int = 0


@torch.no_grad()
def _rollout_returns(policy_params, ref_params, reward_func, prompts, tokenizer,
                     model_config, response_length, temperature, kl_coef, gamma,
                     whiten_rewards, lora_scale, generator, fused_logprob_scoring,
                     mesh=None):
    """(query+response ids, returns [N, R] f32, padding_mask_p1) of one
    n = 1 rollout of `prompts` with KL-shaped rewards (every rank the
    whole rollout on a mesh)."""
    pad_id, eos_id = tokenizer.pad_token_id, tokenizer.eos_token_id
    device = policy_params["embed_tokens"].device
    context_length = prompts.shape[1]
    prompts_t = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    responses = generate(
        full_tree(policy_params, mesh), model_config, prompts_t, prompts_t != pad_id,
        generator,
        SamplingParams(temperature=temperature, top_p=0.95, n=1,
                       max_tokens=response_length),
        eos_token_id=eos_id, pad_token_id=pad_id, lora_scale=lora_scale,
    ).cpu().numpy()
    question_strings = [q.replace(tokenizer.pad_token, "")
                        for q in tokenizer.batch_decode(prompts)]
    decoded = tokenizer.batch_decode(responses)
    scores = np.asarray(reward_func([q + r for q, r in zip(question_strings, decoded)],
                                    tokenizer.eos_token), np.float32)

    qr = np.concatenate([prompts, responses], axis=1)

    def score_one(p, ids, scale):
        resp = ids[:, context_length:]
        p, hook = forward_view(p, mesh)
        if fused_logprob_scoring:
            w, w_t = unembedding(model_config, p)
            return fused_logprob(
                padded_forward_hidden(p, model_config, ids, pad_id, lora_scale=scale,
                                      response_context_length=context_length,
                                      layer_transform=hook),
                w, resp, temperature, transposed=w_t)
        return logprobs_from_logits(
            padded_forward_logits(p, model_config, ids, pad_id, lora_scale=scale,
                                  response_context_length=context_length,
                                  layer_transform=hook),
            resp, temperature)

    # ref_params=None (ref-free, kl_coef 0): no ref forward; the KL shaping
    # it would feed is multiplied away
    chunk = max(1, 28 * 2316 // qr.shape[1])
    lps, rlps = [], []
    for i in range(0, qr.shape[0], chunk):
        ids = torch.as_tensor(qr[i:i + chunk], device=device)
        lp = score_one(policy_params, ids, lora_scale)
        rlp = lp if ref_params is None else score_one(ref_params, ids, 1.0)
        lps.append(lp.float().cpu().numpy())
        rlps.append(rlp.float().cpu().numpy())
    logprobs, ref_logprobs = np.concatenate(lps), np.concatenate(rlps)

    post = truncate_response(eos_id, pad_id, torch.as_tensor(responses))
    seq_len = first_true_indices(post == pad_id) - 1
    padding_mask, padding_mask_p1 = (m.numpy() for m in response_padding_masks(post, seq_len))
    logprobs = np.where(padding_mask, INVALID_LOGPROB, logprobs)
    ref_logprobs = np.where(padding_mask, INVALID_LOGPROB, ref_logprobs)
    kl_penalty = (-kl_coef * np.where(padding_mask, 0.0, logprobs - ref_logprobs)
                  ).astype(np.float32)
    rewards = sparse_terminal_rewards(torch.as_tensor(scores), seq_len,
                                      responses.shape[1],
                                      kl_penalty=torch.as_tensor(kl_penalty))
    if whiten_rewards:
        pm1 = torch.as_tensor(padding_mask_p1)
        rewards = masked_whiten(rewards, ~pm1, shift_mean=True)
        rewards = torch.where(pm1, torch.zeros_like(rewards), rewards)
    returns = discounted_returns(rewards, gamma).numpy().astype(np.float32)
    return qr, returns, padding_mask_p1


def finetune_value_model(value_params: dict, policy_params: dict,
                         ref_params: dict | None, reward_func, prompts: np.ndarray,
                         tokenizer, model_config, response_length: int,
                         temperature: float, kl_coef: float, gamma: float,
                         vcfg: ValueInitConfig = ValueInitConfig(),
                         whiten_rewards: bool = False, lora_scale: float = 1.0,
                         value_lora_cfg=None,
                         generator: torch.Generator | None = None,
                         fused_logprob_scoring: bool = True, mesh=None) -> dict:
    """Regress `value_params` onto the returns of one rollout of `prompts`
    ([N, Tp] left-padded; the first `train_data_size` rows). With
    `value_lora_cfg` only the value tree's trainable partition trains (its
    LoRA adapters, score head and embeddings; the tree must carry its
    "lora" subtree), else every leaf. Plain Adam (no weight decay). The
    best epoch's trainable leaves are written back into `value_params` IN
    PLACE, and the tree is returned. `generator` (default: seeded 0) drives
    the rollout's sampling. `mesh`: the trainer's (module docstring); a
    training batch must split over its batch ranks."""
    device = value_params["embed_tokens"].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pad_id = tokenizer.pad_token_id
    prompts = np.asarray(prompts[: vcfg.train_data_size])
    context_length = prompts.shape[1]
    qr, returns, padding_mask_p1 = _rollout_returns(
        policy_params, ref_params, reward_func, prompts, tokenizer, model_config,
        response_length, temperature, kl_coef, gamma, whiten_rewards, lora_scale,
        generator, fused_logprob_scoring, mesh)

    n = qr.shape[0]
    n_train = int(n * vcfg.train_split_rate)
    perm = np.random.default_rng(0).permutation(n)
    tr, va = perm[:n_train], perm[n_train:]

    value_lora_scale = value_lora_cfg.scale if value_lora_cfg is not None else 1.0
    trainable = _trainable_leaves(value_params,
                                  value_trainable_mask(value_params, value_lora_cfg))
    leaves = flatten(trainable)
    paths, tensors = list(leaves), list(leaves.values())
    for t in tensors:
        t.requires_grad_(True)
    lr = [vcfg.learning_rate]
    optimizer = AdamW(lambda count: lr[0], eps=1e-8, weight_decay=0.0)
    opt_state = optimizer.init(trainable)

    def vloss(idx, split: bool = True):
        # a training batch splits its rows over the batch ranks; the
        # validation forward (no backward) runs whole on every rank
        m = mesh if split else None
        ids = torch.as_tensor(qr[idx], device=device)
        labels = torch.as_tensor(returns[idx], device=device)
        pm1 = torch.as_tensor(padding_mask_p1[idx], device=device)
        view, hook = forward_view(value_params, mesh)
        vpred = score_forward(view, model_config, ids[batch_sharding(m, len(idx))],
                              pad_id, lora_scale=value_lora_scale,
                              layer_transform=hook)[:, context_length - 1:-1, 0]
        vpred = own_rows(m, vpred)
        vpred = torch.where(pm1, torch.zeros_like(vpred), vpred)
        return 0.5 * masked_mean(torch.square(vpred - labels), ~pm1)

    def snapshot():
        return [t.detach().clone() for t in tensors]

    bs = vcfg.per_device_train_batch_size
    best_val, best, patience, plateau_wait = np.inf, snapshot(), 0, 0
    for epoch in range(vcfg.num_train_epochs):
        ep_perm = np.random.default_rng(epoch).permutation(len(tr))
        for i in range(0, len(tr) - bs + 1, bs):
            grads = [g.float() for g in
                     torch.autograd.grad(vloss(tr[ep_perm[i:i + bs]]), tensors)]
            reduce_grads(mesh, paths, grads, over_sp=False)
            opt_state = optimizer.step(trainable, unflatten(dict(zip(paths, grads))),
                                       opt_state, mesh=mesh)
        with torch.no_grad():
            val_losses = [float(vloss(va[i:i + bs], split=False))
                          for i in range(0, max(1, len(va) - bs + 1), bs)] or [0.0]
        val_loss = float(np.mean(val_losses))
        print(f"[value-init] epoch {epoch}: val_loss={val_loss:.5f}")
        if val_loss < best_val - 1e-6:
            best_val, best, patience, plateau_wait = val_loss, snapshot(), 0, 0
        else:
            patience += 1
            plateau_wait += 1
            if plateau_wait > vcfg.plateau_patience:
                # the JAX run holds its learning rate as an f32 array
                lr[0] = float(np.float32(lr[0]) * np.float32(vcfg.plateau_factor))
                print(f"[value-init] plateau: lr -> {lr[0]:.2e}")
                plateau_wait = 0
            if patience >= vcfg.early_stopping_patience:
                break
    with torch.no_grad():
        for t, b in zip(tensors, best):
            t.copy_(b)
    return value_params
