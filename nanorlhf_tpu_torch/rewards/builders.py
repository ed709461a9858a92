"""Reward-function builders — the port of `nanorlhf_tpu/rewards/builders.py`
(the rule-based builder, the decoder RM with a score head, and the
host-side torch RM).

Protocol: `reward_func(pmt_and_responses: list[str], eos_token: str) ->
array[B]`, host-side.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def make_rule_reward(fn: Callable[[str, str], float]):
    """Lift a per-string scoring fn into the reward protocol."""

    def reward_func(pmt_and_responses, eos_token):
        return np.asarray([fn(s, eos_token) for s in pmt_and_responses], np.float32)

    return reward_func


def make_rm_reward(rm_params: dict, model_config, tokenizer, batch_size: int = 16,
                   max_len: int = 2048, lora_scale: float = 1.0):
    """A decoder with a score head (`rm_params` carries "score", the value
    tree's layout) rates each string at its last real token (TRL's
    `get_reward`), on the device the tree lives on: `score_forward`, whose
    attention is the flash kernel on the card. Strings are encoded, cut to
    `max_len` tokens, batched by `batch_size` and right-padded, as in JAX."""
    from nanorlhf_tpu_torch.core.model import score_forward

    pad_id = tokenizer.pad_token_id
    device = rm_params["embed_tokens"].device

    @torch.no_grad()
    def score_batch(ids: torch.Tensor) -> torch.Tensor:
        scores = score_forward(rm_params, model_config, ids, pad_id, lora_scale)[:, :, 0]
        last = torch.clamp((ids != pad_id).sum(1) - 1, min=0)
        return scores[torch.arange(ids.shape[0], device=ids.device), last]

    def reward_func(pmt_and_responses, eos_token):
        out = []
        for i in range(0, len(pmt_and_responses), batch_size):
            enc = [tokenizer.encode(s)[:max_len]
                   for s in pmt_and_responses[i:i + batch_size]]
            ids = np.full((len(enc), max(len(e) for e in enc)), pad_id, np.int64)
            for j, e in enumerate(enc):
                ids[j, :len(e)] = e  # right-pad; the scorer reads the last real token
            out.append(score_batch(torch.from_numpy(ids).to(device)).cpu().numpy())
        return np.concatenate(out).astype(np.float32)

    return reward_func


def make_torch_rm_reward(model_path: str, batch_size: int = 16, device: str = "cpu"):
    """Host-side torch RM (the reference's deberta-v3 path): a local
    `transformers` sequence classifier with its own tokenizer, scored in
    batches on `device`. `transformers` is imported only here."""
    from transformers import AutoModelForSequenceClassification, AutoTokenizer

    model = AutoModelForSequenceClassification.from_pretrained(model_path).eval().to(device)
    rm_tok = AutoTokenizer.from_pretrained(model_path)

    def reward_func(pmt_and_responses, eos_token):
        out = []
        with torch.no_grad():
            for i in range(0, len(pmt_and_responses), batch_size):
                chunk = [s.replace(eos_token, "")
                         for s in pmt_and_responses[i:i + batch_size]]
                enc = rm_tok(chunk, return_tensors="pt", padding=True,
                             truncation=True, max_length=2048).to(device)
                logits = model(**enc).logits[:, 0]
                out.append(logits.float().cpu().numpy())
        return np.concatenate(out).astype(np.float32)

    return reward_func
