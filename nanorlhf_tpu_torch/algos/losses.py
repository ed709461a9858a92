"""Losses of the six algorithms — the port of `nanorlhf_tpu/algos/losses.py`:
token-level PPO-clip (PPO, REINFORCE, ReMax), GRPO's joint masked mean of
it with the k3 KL, sequence-level PPO-clip (RLOO), the clipped value loss
(PPO) and RAFT's SFT loss.

Every function returns `(loss, aux)` with the JAX package's `aux` keys:
the detached per-microbatch stats the trainer averages into its `_new`
metrics. The truncated-IS correction of the async orchestrator
(`behavior_logprobs`, `segment_ages`) is not ported: the synchronous path
passes None, and anything else raises.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.ops.masking import masked_mean


def _reject_is(behavior_logprobs, segment_ages) -> None:
    if behavior_logprobs is not None or segment_ages is not None:
        raise NotImplementedError(
            "truncated-IS off-policy correction (behavior_logprobs / "
            "segment_ages, the async orchestrator's) is not ported yet")


def _ratio_and_stats(new_logprobs, old_logprobs):
    """logprob diff / importance ratio shared by the PPO-style losses.
    Pads carry INVALID_LOGPROB in both tensors: diff 0, ratio exactly 1,
    so the unmasked `approxkl = 0.5 · mean(diff²)` matches the reference."""
    logprobs_diff = new_logprobs - old_logprobs
    ratio = torch.exp(logprobs_diff)
    approxkl = 0.5 * torch.mean(logprobs_diff ** 2)
    return logprobs_diff, ratio, approxkl


def _clip_terms(ratio, advantages, cliprange: float):
    pg_losses = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    return pg_losses, pg_losses2


def ppo_clip_loss_token(new_logprobs, old_logprobs, advantages, mask,
                        cliprange: float, behavior_logprobs=None,
                        is_truncation: float = 2.0, segment_ages=None):
    """Token-level clipped policy-gradient loss; `mask` is True on real
    tokens."""
    _reject_is(behavior_logprobs, segment_ages)
    _, ratio, approxkl = _ratio_and_stats(new_logprobs, old_logprobs)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    loss = masked_mean(torch.maximum(pg_losses, pg_losses2), mask)
    aux = {
        "pg_clipfrac": masked_mean((pg_losses2 > pg_losses).float(), mask),
        "approxkl": approxkl,
        "ratio_mean": torch.mean(ratio),
        "pg_loss": loss,
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def k3_kl(new_logprobs, ref_logprobs):
    """k3 KL estimator e^{-kl} + kl − 1 with kl = logπ − logπ_ref (≥ 0)."""
    kl = new_logprobs - ref_logprobs
    return torch.exp(-kl) + kl - 1.0


def grpo_loss(new_logprobs, old_logprobs, ref_logprobs, advantages, mask,
              cliprange: float, kl_coef: float, behavior_logprobs=None,
              is_truncation: float = 2.0, segment_ages=None):
    """GRPO = token-level PPO-clip + kl_coef · k3-KL, jointly masked-meaned
    (the KL term sits inside the masked mean with the clipped PG term)."""
    _reject_is(behavior_logprobs, segment_ages)
    _, ratio, approxkl = _ratio_and_stats(new_logprobs, old_logprobs)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    kl = new_logprobs - ref_logprobs
    pg_loss_max = (torch.maximum(pg_losses, pg_losses2)
                   + kl_coef * k3_kl(new_logprobs, ref_logprobs))
    loss = masked_mean(pg_loss_max, mask)
    aux = {
        "pg_clipfrac": masked_mean((pg_losses2 > pg_losses).float(), mask),
        "approxkl": approxkl,
        "ratio_mean": torch.mean(ratio),
        "refkl_mean": torch.mean(kl),
        "pg_loss": loss,
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def ppo_clip_loss_sequence(new_logprobs, old_logprobs, advantages, mask,
                           cliprange: float, behavior_logprobs=None,
                           is_truncation: float = 2.0, segment_ages=None):
    """Sequence-level PPO-clip (RLOO): the ratio of the masked sums of the
    logprobs, clipped against the [B] sequence advantages, plain mean."""
    _reject_is(behavior_logprobs, segment_ages)
    mask_f = mask.to(new_logprobs.dtype)
    logprobs_diff = ((new_logprobs * mask_f).sum(dim=1)
                     - (old_logprobs * mask_f).sum(dim=1))
    ratio = torch.exp(logprobs_diff)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    loss = torch.mean(torch.maximum(pg_losses, pg_losses2))
    aux = {
        "pg_clipfrac": torch.mean((pg_losses2 > pg_losses).float()),
        "approxkl": 0.5 * torch.mean(logprobs_diff ** 2),
        "ratio_mean": torch.mean(ratio),
        "pg_loss": loss,
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def value_loss_clipped(vpred, values, returns, mask_p1, cliprange_value: float):
    """PPO's clipped value loss 0.5 · masked_mean(max((v − R)², (v_clip − R)²));
    `mask_p1` is True on valid value positions (~padding_mask_p1)."""
    vpredclipped = torch.clamp(vpred, values - cliprange_value, values + cliprange_value)
    vf_losses1 = torch.square(vpred - returns)
    vf_losses2 = torch.square(vpredclipped - returns)
    loss = 0.5 * masked_mean(torch.maximum(vf_losses1, vf_losses2), mask_p1)
    aux = {
        "vf_loss": loss,
        "vf_clipfrac": masked_mean((vf_losses2 > vf_losses1).float(), mask_p1),
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def sft_loss(new_logprobs, mask):
    """RAFT: the negative summed logprob of the kept sample, masked before
    the sum, mean over the batch."""
    loss = -torch.mean((new_logprobs * mask.to(new_logprobs.dtype)).sum(dim=1))
    return loss, {"pg_loss": loss.detach()}
