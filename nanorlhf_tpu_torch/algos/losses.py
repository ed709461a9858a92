"""Losses of the six algorithms — the port of `nanorlhf_tpu/algos/losses.py`:
token-level PPO-clip (PPO, REINFORCE, ReMax), GRPO's joint masked mean of
it with the k3 KL, sequence-level PPO-clip (RLOO), the clipped value loss
(PPO) and RAFT's SFT loss.

Every function returns `(loss, aux)` with the JAX package's `aux` keys:
the detached per-microbatch stats the trainer averages into its `_new`
metrics.

The PPO-style losses optionally take `behavior_logprobs` — the logprobs of
the STALE policy that actually sampled the tokens under the async rollout
orchestrator (the sampler captures them) — and re-weight each loss term by
the truncated importance ratio min(π_old/μ, ρ̄) (`truncated_is_weights`),
adding `is_weight_mean` and `is_trunc_frac` to `aux`. With in-flight
weight swaps one generation spans several behavior policies, and
`segment_ages` (per-token `v_newest_segment_in_row − v_segment(t)`)
tightens the clamp per segment (`segment_is_weights`). With
`behavior_logprobs=None` every loss is its synchronous form, and an
all-zero age map gives the whole-sequence weight bit for bit.
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.ops.masking import masked_mean


def truncated_is_weights(old_logprobs, behavior_logprobs, truncation: float):
    """Per-token truncated importance weight ρ = min(π_old/μ, ρ̄), and the
    tokens it truncated. Pads carry INVALID_LOGPROB in both tensors: their
    weight is exactly 1. Both inputs are data of the update (no gradient
    flows through them)."""
    raw = torch.exp(old_logprobs - behavior_logprobs)
    return torch.clamp(raw, max=truncation), raw > truncation


def _segment_clamp(segment_ages, truncation: float):
    """Per-token bound ρ̄_a = ρ̄^(1/(1+a)) for a token sampled `a` policy
    versions behind its row's newest segment (→ ρ̄ at age 0, → 1 as a
    grows); an age <= 0 gives the literal ρ̄, so an all-zero age map is
    the whole-sequence clamp bit for bit."""
    age = segment_ages.to(torch.float32)
    return torch.where(segment_ages <= 0,
                       torch.full_like(age, truncation),
                       torch.exp(torch.log(torch.tensor(truncation, dtype=torch.float32))
                                 / (1.0 + age)))


def segment_is_weights(old_logprobs, behavior_logprobs, segment_ages,
                       truncation: float):
    """`truncated_is_weights` with the per-segment `_segment_clamp` bound."""
    raw = torch.exp(old_logprobs - behavior_logprobs)
    clamp = _segment_clamp(segment_ages, truncation)
    return torch.minimum(raw, clamp), raw > clamp


# static cap on distinct IS segments per row for the sequence-level (RLOO)
# weight: runs of constant age beyond the cap merge into the last slot
MAX_IS_SEGMENTS = 8


def _segment_onehot(segment_ages):
    """[B, MAX_IS_SEGMENTS, T] bool one-hot of the runs of constant age
    along the token axis (versions rise strictly along a row, so two
    segments never share an age)."""
    boundary = torch.cat([torch.ones_like(segment_ages[:, :1], dtype=torch.bool),
                          segment_ages[:, 1:] != segment_ages[:, :-1]], dim=1)
    run = torch.cumsum(boundary.to(torch.int32), dim=1) - 1
    run = torch.clamp(run, max=MAX_IS_SEGMENTS - 1)
    slots = torch.arange(MAX_IS_SEGMENTS, device=segment_ages.device)
    return run[:, None, :] == slots[None, :, None]


def _is_aux(weights, truncated, mask):
    return {"is_weight_mean": masked_mean(weights, mask),
            "is_trunc_frac": masked_mean(truncated.float(), mask)}


def _is_weighted(pg_loss_max, old_logprobs, mask, behavior_logprobs,
                 is_truncation, segment_ages):
    """The token-level objective times its IS weight, and the IS stats
    (none without behavior logprobs)."""
    if behavior_logprobs is None:
        return pg_loss_max, {}
    if segment_ages is not None:
        w, truncated = segment_is_weights(old_logprobs, behavior_logprobs,
                                          segment_ages, is_truncation)
    else:
        w, truncated = truncated_is_weights(old_logprobs, behavior_logprobs,
                                            is_truncation)
    return w * pg_loss_max, _is_aux(w, truncated, mask)


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
    tokens. `behavior_logprobs` re-weights each token's clipped term by
    its truncated IS weight (per segment with `segment_ages`)."""
    _, ratio, approxkl = _ratio_and_stats(new_logprobs, old_logprobs)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    pg_loss_max, aux = _is_weighted(torch.maximum(pg_losses, pg_losses2),
                                    old_logprobs, mask, behavior_logprobs,
                                    is_truncation, segment_ages)
    loss = masked_mean(pg_loss_max, mask)
    aux = {
        **aux,
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
    (the KL term sits inside the masked mean with the clipped PG term).
    With `behavior_logprobs` the truncated IS weight multiplies the whole
    per-token objective (PG + KL)."""
    _, ratio, approxkl = _ratio_and_stats(new_logprobs, old_logprobs)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    kl = new_logprobs - ref_logprobs
    pg_loss_max, aux = _is_weighted(
        torch.maximum(pg_losses, pg_losses2) + kl_coef * k3_kl(new_logprobs, ref_logprobs),
        old_logprobs, mask, behavior_logprobs, is_truncation, segment_ages)
    loss = masked_mean(pg_loss_max, mask)
    aux = {
        **aux,
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
    logprobs, clipped against the [B] sequence advantages, plain mean.
    With `behavior_logprobs` the IS weight is sequence-level too,
    min(exp(Σ(logπ_old − logμ)), ρ̄); with `segment_ages` it factorizes
    over at most `MAX_IS_SEGMENTS` runs of constant age, each clamped by
    `_segment_clamp`."""
    mask_f = mask.to(new_logprobs.dtype)
    old_sum = (old_logprobs * mask_f).sum(dim=1)
    logprobs_diff = (new_logprobs * mask_f).sum(dim=1) - old_sum
    ratio = torch.exp(logprobs_diff)
    pg_losses, pg_losses2 = _clip_terms(ratio, advantages, cliprange)
    pg_loss_max = torch.maximum(pg_losses, pg_losses2)
    aux = {}
    if behavior_logprobs is not None and segment_ages is not None:
        onehot = _segment_onehot(segment_ages)                   # [B, S, T]
        oh_mask = onehot.to(mask_f.dtype) * mask_f[:, None, :]
        old_sum_s = (old_logprobs[:, None, :] * oh_mask).sum(dim=2)
        beh_sum_s = (behavior_logprobs[:, None, :] * oh_mask).sum(dim=2)
        raw_s = torch.exp(old_sum_s - beh_sum_s)                 # [B, S]
        age_s = torch.where(onehot, segment_ages[:, None, :],
                            torch.zeros_like(segment_ages[:, None, :])).amax(dim=2)
        clamp_s = _segment_clamp(age_s, is_truncation)
        # a run holding no real token contributes a factor of exactly 1
        seg_has = (onehot & mask[:, None, :]).any(dim=2)
        w_s = torch.where(seg_has, torch.minimum(raw_s, clamp_s),
                          torch.ones_like(raw_s))
        w = torch.prod(w_s, dim=1)
        trunc_s = seg_has & (raw_s > clamp_s)
        pg_loss_max = w * pg_loss_max
        aux = {"is_weight_mean": torch.mean(w),
               "is_trunc_frac": torch.mean(trunc_s.any(dim=1).float())}
    elif behavior_logprobs is not None:
        raw = torch.exp(old_sum - (behavior_logprobs * mask_f).sum(dim=1))
        w = torch.clamp(raw, max=is_truncation)
        pg_loss_max = w * pg_loss_max
        aux = {"is_weight_mean": torch.mean(w),
               "is_trunc_frac": torch.mean((raw > is_truncation).float())}
    loss = torch.mean(pg_loss_max)
    aux = {
        **aux,
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
