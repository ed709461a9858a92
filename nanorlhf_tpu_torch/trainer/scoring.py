"""Policy/ref logprob scoring of a rollout — the port of
`nanorlhf_tpu/trainer/trainer.py`'s `fused_response_logprobs` (:114) and the
scoring body of `RLTrainer._score_chunk_fn` (:1565-1598), as plain
functions. The fused branch (the default, `cfg.fused_logprob=True`) runs
the final hidden states straight into the fused hidden→logprob op; the
naive branch materializes logits. Sequence-parallel scoring is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from nanorlhf_tpu_torch.core.model import (
    padded_forward_hidden,
    padded_forward_logits,
    unembedding,
)
from nanorlhf_tpu_torch.ops.fused_logprob import fused_logprob
from nanorlhf_tpu_torch.ops.masking import logprobs_from_logits

# activation budget of one scoring forward, in tokens (the JAX trainer's)
ACTIVATION_TOKEN_BUDGET = 22 * 2316
_LOGITS_BYTES_BUDGET = 2 * 1024**3


def forward_token_budget(vocab_size: int, bytes_per_elem: int = 2,
                         fused_logprob: bool = False) -> int:
    """Tokens per scoring forward; the fused scorer has no vocab cap."""
    if fused_logprob:
        return ACTIVATION_TOKEN_BUDGET
    vocab_cap = max(1024, _LOGITS_BYTES_BUDGET // (vocab_size * bytes_per_elem))
    return min(ACTIVATION_TOKEN_BUDGET, vocab_cap)


def pad_chunk(rows: np.ndarray, chunk: int) -> np.ndarray:
    """Pad a short final chunk to `chunk` rows by repeating the last row."""
    n = rows.shape[0]
    if n >= chunk:
        return rows
    return np.concatenate([rows, np.repeat(rows[-1:], chunk - n, axis=0)], axis=0)


def fused_response_logprobs(tree, mcfg, query_responses, responses, pad_id,
                            context_length: int, cfg, lora_scale: float = 1.0,
                            with_entropy: bool = False, remat: bool = False):
    """Response-position hidden states → per-token logprobs (+ entropy)
    through the fused op, with the cfg's chunk/impl knobs — shared by the
    scoring pass and the update's microbatch loss, so their numerics cannot
    drift apart. The tied embedding goes in vocab-major ([V, D],
    transposed=True), never as a transposed copy."""
    hidden = padded_forward_hidden(
        tree, mcfg, query_responses, pad_id, lora_scale=lora_scale,
        response_context_length=context_length, remat=remat,
    )
    w, w_transposed = unembedding(mcfg, tree)
    return fused_logprob(
        hidden, w, responses, cfg.temperature,
        chunk=cfg.fused_logprob_chunk, impl=cfg.fused_logprob_impl,
        with_entropy=with_entropy, transposed=w_transposed,
    )


@torch.no_grad()
def score_chunk(params, ref_params, mcfg, cfg, query_responses,
                context_length: int, pad_id: int, lora_scale: float = 1.0):
    """(policy logprobs, ref logprobs) [rows, T_resp] f32 for one chunk of
    query+response rows. The policy runs with its LoRA adapters; the ref
    tree has none. `ref_params=None` is the ref-free run (kl_coef 0): no
    ref forward, the ref logprobs are the policy's."""
    if cfg.mesh.sp > 1:
        raise NotImplementedError(
            "sequence-parallel scoring (mesh.sp > 1) is not ported yet")
    responses = query_responses[:, context_length:]
    if cfg.fused_logprob:
        logprobs = fused_response_logprobs(
            params, mcfg, query_responses, responses, pad_id, context_length,
            cfg, lora_scale=lora_scale)
        if ref_params is None:
            return logprobs, logprobs
        ref_logprobs = fused_response_logprobs(
            ref_params, mcfg, query_responses, responses, pad_id,
            context_length, cfg)
        return logprobs, ref_logprobs
    logits = padded_forward_logits(params, mcfg, query_responses, pad_id,
                                   lora_scale=lora_scale,
                                   response_context_length=context_length)
    logprobs = logprobs_from_logits(logits, responses, cfg.temperature)
    if ref_params is None:
        return logprobs, logprobs
    ref_logits = padded_forward_logits(ref_params, mcfg, query_responses, pad_id,
                                       response_context_length=context_length)
    return logprobs, logprobs_from_logits(ref_logits, responses, cfg.temperature)
