"""Sequence-masking / whitening / logprob numerics — the port of
`nanorlhf_tpu/ops/masking.py` (the functions the GRPO rollout, scoring and
update use). Same semantics, torch tensors in and out.
"""

from __future__ import annotations

import torch

# Sentinel written into logprob tensors at padded positions (a positive
# logprob is impossible, so masked reductions can never mistake it for data)
INVALID_LOGPROB = 1.0

# Floor for every temperature division: sampler capture, scoring logprobs
# and the entropy stat share ONE guard so their logprobs agree bit for bit.
MIN_TEMPERATURE = 1e-6


def exact_div(a: int, b: int, custom_error_message: str = "") -> int:
    """Integer division that refuses to lose a remainder."""
    q = a // b
    if a != q * b:
        raise ValueError(f"{custom_error_message}, inexact division: {a} / {b} = {a / b}")
    return q


def first_true_indices(bools: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Index of the first True along the last axis; row length if no True."""
    row_len = bools.shape[-1]
    idxs = torch.arange(row_len, dtype=torch.int64, device=bools.device)
    masked = torch.where(bools, idxs, torch.full_like(idxs, row_len))
    return masked.min(dim=-1).values.to(dtype)


def truncate_response(stop_token_id: int, pad_token_id: int,
                      responses: torch.Tensor) -> torch.Tensor:
    """Replace everything *after* the first stop token with pad; the stop
    token itself is kept (TRL's `truncate_response`)."""
    trunc = first_true_indices(responses == stop_token_id, torch.int64)[..., None]
    idxs = torch.arange(responses.shape[-1], device=responses.device)
    return torch.where(idxs > trunc, torch.full_like(responses, pad_token_id),
                       responses)


def response_padding_masks(responses: torch.Tensor, sequence_lengths: torch.Tensor):
    """(padding_mask, padding_mask_p1): True strictly after the last real
    token `sequence_lengths` (logprobs/advantages), and strictly after the
    one-past position (values/rewards)."""
    idxs = torch.arange(responses.shape[-1], device=responses.device)
    seq = sequence_lengths[..., None]
    return idxs > seq, idxs > seq + 1


def masked_mean(values: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean of `values` over positions where `mask` is True."""
    mask = mask.to(values.dtype)
    if axis is None:
        return (values * mask).sum() / torch.clamp(mask.sum(), min=1e-8)
    return (values * mask).sum(dim=axis) / torch.clamp(mask.sum(dim=axis), min=1e-8)


def masked_var(values: torch.Tensor, mask: torch.Tensor,
               unbiased: bool = True) -> torch.Tensor:
    """Variance over masked positions, Bessel-corrected by default."""
    mean = masked_mean(values, mask)
    centered = values - mean
    var = masked_mean(centered * centered, mask)
    if unbiased:
        n = mask.to(values.dtype).sum()
        var = var * (n / torch.clamp(n - 1, min=1.0))
    return var


def masked_whiten(values: torch.Tensor, mask: torch.Tensor,
                  shift_mean: bool = True) -> torch.Tensor:
    """Whiten to zero mean / unit variance over masked positions."""
    mean = masked_mean(values, mask)
    var = masked_var(values, mask)
    whitened = (values - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def guard_temperature(temperature):
    """`max(temperature, MIN_TEMPERATURE)` for a python number or a tensor."""
    if isinstance(temperature, (int, float)):
        return max(float(temperature), MIN_TEMPERATURE)
    return torch.clamp(temperature, min=MIN_TEMPERATURE)


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """log softmax(logits / temperature) gathered at `labels`, computed as
    `logit[label]/T − logsumexp(logits/T)` in f32."""
    temperature = guard_temperature(temperature)
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    lse = torch.logsumexp(logits.float() / temperature, dim=-1)
    return label_logits.float() / temperature - lse


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-position entropy: logsumexp(z) - sum softmax(z) * z."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - (probs * logits).sum(dim=-1)
