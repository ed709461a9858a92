"""Advantage estimators of the six algorithms — the port of
`nanorlhf_tpu/algos/advantages.py`: GRPO's group z-score and keep-1-of-N,
RLOO's leave-one-out baseline, ReMax's greedy baseline, RAFT's best-of-K,
the multi-turn per-turn z-score and per-turn terminal rewards, the sparse
terminal reward, its γ-discounted reversed cumsum (REINFORCE,
ReMax; γ=1 broadcasts GRPO's advantage) and PPO's GAE. The random draws
take an explicit `torch.Generator`: same distributions as JAX's keys,
other bits."""

from __future__ import annotations

import torch


def grpo_group_advantage(scores: torch.Tensor, sample_n: int) -> torch.Tensor:
    """Per-prompt-group z-score: (r - mean_group) / std_group, for flat
    group-major [B*N] scores. Unbiased (ddof=1) std as `torch.Tensor.std`
    in the reference; a zero-variance group's 0/0 NaN maps to 0."""
    groups = scores.reshape(-1, sample_n).float()
    mean = groups.mean(dim=1, keepdim=True)
    std = torch.sqrt(((groups - mean) ** 2).sum(dim=1, keepdim=True) / (sample_n - 1))
    adv = (groups - mean) / std
    adv = torch.where(torch.isnan(adv), torch.zeros_like(adv), adv)
    return adv.reshape(-1)


def grpo_turn_advantage(turn_rewards: torch.Tensor, sample_n: int) -> torch.Tensor:
    """Per-turn GRPO advantage: z-score each turn column of [B*N, K]
    group-major turn rewards within its group (absent turns hold 0; a
    column that ties within its group z-scores to 0 by the NaN→0 rule).
    K = 1 is exactly `grpo_group_advantage`."""
    rows, k = turn_rewards.shape
    groups = turn_rewards.reshape(-1, sample_n, k).float()
    mean = groups.mean(dim=1, keepdim=True)
    std = torch.sqrt(((groups - mean) ** 2).sum(dim=1, keepdim=True) / (sample_n - 1))
    adv = (groups - mean) / std
    adv = torch.where(torch.isnan(adv), torch.zeros_like(adv), adv)
    return adv.reshape(rows, k)


def per_turn_terminal_rewards(turn_rewards: torch.Tensor, turn_ends: torch.Tensor,
                              response_length: int) -> torch.Tensor:
    """Sparse per-token rewards with one spike at each turn's final model
    token: `turn_ends` [B, K] holds each turn's last position (−1 for an
    absent turn, whose reward is dropped — JAX's out-of-range
    `mode="drop"` scatter). `discounted_returns(γ=1)` over the result
    gives each turn's credit as reward-to-go."""
    batch = turn_rewards.shape[0]
    rewards = torch.zeros((batch, response_length), dtype=torch.float32,
                          device=turn_rewards.device)
    ends = turn_ends.long()
    keep = (ends >= 0) & (ends < response_length)
    rows = torch.arange(batch, device=turn_rewards.device)[:, None].expand_as(ends)
    rewards.index_put_((rows[keep], ends[keep]), turn_rewards.float()[keep],
                       accumulate=True)
    return rewards


def rloo_advantage(rlhf_reward: torch.Tensor, sample_n: int) -> torch.Tensor:
    """Leave-one-out baseline r_i − mean(r_{j≠i}) over flat group-major
    [B*N] sequence-level rewards (score + summed KL penalty)."""
    groups = rlhf_reward.reshape(-1, sample_n).float()
    baseline = (groups.sum(dim=1, keepdim=True) - groups) / (sample_n - 1)
    return (groups - baseline).reshape(-1)


def remax_advantage(scores: torch.Tensor, greedy_scores: torch.Tensor) -> torch.Tensor:
    """Sampled-rollout reward minus the greedy rollout's for the same prompt."""
    return scores - greedy_scores


def best_of_k_indices(rlhf_reward: torch.Tensor, sample_k: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """RAFT selection: the best of K samples per prompt (the first of equal
    maxima, as `jnp.argmax`), or, given `generator`, a uniformly random one
    (the reference as shipped)."""
    groups = rlhf_reward.reshape(-1, sample_k)
    if generator is not None:
        return torch.randint(0, sample_k, (groups.shape[0],), generator=generator,
                             device=generator.device)
    return torch.argmax(groups, dim=1)


def keep_one_of_n_indices(generator: torch.Generator, batch_size: int,
                          sample_n: int) -> torch.Tensor:
    """GRPO keep-1-of-N: a uniformly random sample index per prompt. The
    caller seeds `generator` from (seed, stream, index); it matches JAX's
    `jax.random.randint` in distribution, not bit for bit."""
    return torch.randint(0, sample_n, (batch_size,), generator=generator,
                         device=generator.device)


def sparse_terminal_rewards(scores: torch.Tensor, sequence_lengths: torch.Tensor,
                            response_length: int,
                            kl_penalty: torch.Tensor | None = None) -> torch.Tensor:
    """Per-token rewards: the score lands one past the last real token when
    that position exists, else on the last token; `kl_penalty` (dense) is
    added everywhere when given."""
    batch = scores.shape[0]
    rewards = (torch.zeros((batch, response_length), dtype=torch.float32,
                           device=scores.device)
               if kl_penalty is None else kl_penalty.float().clone())
    seq_p1 = sequence_lengths.long() + 1
    actual_end = torch.where(seq_p1 < response_length, seq_p1,
                             sequence_lengths.long())
    # a row whose first token is pad has seq_len −1: like JAX's `.at[-1]`,
    # that index wraps to the last position
    actual_end = torch.remainder(actual_end, response_length)
    rewards[torch.arange(batch, device=scores.device), actual_end] += scores.float()
    return rewards


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reversed cumulative sum with discount: A_t = r_t + γ A_{t+1}."""
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[:, 0])
    for t in range(rewards.shape[1] - 1, -1, -1):
        carry = rewards[:, t] + gamma * carry
        out[:, t] = carry
    return out


def gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float,
        lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, a reversed loop over T on the
    rewards' device: δ_t = r_t + γ V_{t+1} − V_t, A_t = δ_t + γλ A_{t+1}
    (V_T = 0). `values[:, t]` is the value before emitting token t. Returns
    (advantages, returns = advantages + values)."""
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[:, 0])
    next_value = torch.zeros_like(values[:, 0])
    for t in range(rewards.shape[1] - 1, -1, -1):
        delta = rewards[:, t] + gamma * next_value - values[:, t]
        carry = delta + gamma * lam * carry
        out[:, t] = carry
        next_value = values[:, t]
    return out, out + values
