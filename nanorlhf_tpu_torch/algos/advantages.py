"""Advantage estimators — the port of `nanorlhf_tpu/algos/advantages.py`
(the GRPO group z-score the rollout path uses)."""

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
