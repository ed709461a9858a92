"""Policy losses — the port of `nanorlhf_tpu/algos/losses.py` (the GRPO
path: token-level PPO-clip, the k3 KL and their joint masked mean).

Every function returns `(loss, aux)` with the JAX package's `aux` keys:
the detached per-microbatch stats the trainer averages into its `_new`
metrics. The truncated-IS correction of the async orchestrator
(`behavior_logprobs`, `segment_ages`) is not ported: the synchronous path
passes None, and anything else raises. The sequence-level, value and SFT
losses of the other algorithms come with them.
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
