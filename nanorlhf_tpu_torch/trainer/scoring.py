"""Policy/ref logprob scoring of a rollout — the port of
`nanorlhf_tpu/trainer/trainer.py`'s `fused_response_logprobs` (:114), the
scoring body of `RLTrainer._score_chunk_fn` (:1565-1598) and PPO's chunked
value pass (`_value_pass`, :3091-3138), as plain functions. The fused
branch (the default, `cfg.fused_logprob=True`) runs the final hidden
states straight into the fused hidden→logprob op; the naive branch
materializes logits. Under sequence parallelism (`mesh` with sp > 1) both
passes go around the ring (`parallel.sp.sp_score_logprobs`,
`sp_score_values`), as JAX's `_sp_on` branches do; K10 is not on that path.

On a mesh with batch ranks (data × fsdp > 1) every rank is handed the same
global chunk of rows, forwards its own block of them (`batch_sharding`)
and gathers the others' results, so every rank returns the global rows;
with fsdp > 1 the forward reads the sharded tree through
`parallel.fsdp.forward_view` (each layer gathered as it runs).
"""

from __future__ import annotations

import numpy as np
import torch

from nanorlhf_tpu_torch.core.model import (
    padded_forward_hidden,
    padded_forward_logits,
    score_forward,
    unembedding,
)
from nanorlhf_tpu_torch.ops.fused_logprob import fused_logprob
from nanorlhf_tpu_torch.ops.masking import logprobs_from_logits
from nanorlhf_tpu_torch.parallel.fsdp import forward_view
from nanorlhf_tpu_torch.parallel.mesh import batch_sharding, fsdp_axis, own_rows, ring
from nanorlhf_tpu_torch.parallel.sp import sp_score_logprobs, sp_score_values

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
                            with_entropy: bool = False, remat: bool = False,
                            mesh=None):
    """Response-position hidden states → per-token logprobs (+ entropy)
    through the fused op, with the cfg's chunk/impl knobs — shared by the
    scoring pass and the update's microbatch loss, so their numerics cannot
    drift apart. The tied embedding goes in vocab-major ([V, D],
    transposed=True), never as a transposed copy. `mesh` with fsdp > 1:
    the tree is sharded and the forward reads its view."""
    tree, hook = forward_view(tree, mesh)
    hidden = padded_forward_hidden(
        tree, mcfg, query_responses, pad_id, lora_scale=lora_scale,
        response_context_length=context_length, remat=remat, layer_transform=hook,
    )
    w, w_transposed = unembedding(mcfg, tree)
    return fused_logprob(
        hidden, w, responses, cfg.temperature,
        chunk=cfg.fused_logprob_chunk, impl=cfg.fused_logprob_impl,
        with_entropy=with_entropy, transposed=w_transposed,
    )


@torch.no_grad()
def score_chunk(params, ref_params, mcfg, cfg, query_responses,
                context_length: int, pad_id: int, lora_scale: float = 1.0,
                score_policy: bool = True, mesh=None):
    """(policy logprobs, ref logprobs) [rows, T_resp] f32 for one chunk of
    query+response rows. The policy runs with its LoRA adapters; the ref
    tree has none. `ref_params=None` is the ref-free run (kl_coef 0): no
    ref forward, the ref logprobs are the policy's. `score_policy=False`
    (the sampler captured the policy's logprobs) runs the ref alone and
    returns (None, ref logprobs). `mesh`: sp > 1 scores around the ring;
    batch ranks each score their block of the rows and gather the rest
    (module docstring). Every rank gets the same result."""
    query_responses = query_responses[batch_sharding(mesh, query_responses.shape[0])]
    responses = query_responses[:, context_length:]

    def block(tree, scale):
        if ring(mesh):
            return sp_score_logprobs(tree, mcfg, query_responses, pad_id,
                                     cfg.temperature, mesh, lora_scale=scale,
                                     fsdp_axis=fsdp_axis(mesh)
                                     )[:, context_length - 1:-1]
        if cfg.fused_logprob:
            return fused_response_logprobs(tree, mcfg, query_responses, responses,
                                           pad_id, context_length, cfg,
                                           lora_scale=scale, mesh=mesh)
        view, hook = forward_view(tree, mesh)
        logits = padded_forward_logits(view, mcfg, query_responses, pad_id,
                                       lora_scale=scale,
                                       response_context_length=context_length,
                                       layer_transform=hook)
        return logprobs_from_logits(logits, responses, cfg.temperature)

    def one(tree, scale):
        return own_rows(mesh, block(tree, scale))

    logprobs = one(params, lora_scale) if score_policy else None
    if ref_params is None:
        return logprobs, logprobs
    return logprobs, one(ref_params, 1.0)


@torch.no_grad()
def value_pass(value_params, mcfg, qr: np.ndarray, context_length: int,
               pad_id: int, lora_scale: float = 1.0, mesh=None) -> np.ndarray:
    """PPO's value predictions [rows, T_resp] f32 of query+response rows:
    `score_forward` of the value tree (with its LoRA), sliced to the
    positions before each response token, in chunks of the activation
    budget's rows (the scores are [B, T, 1]: no vocab cap applies);
    around the ring (`sp_score_values`) under `mesh` with sp > 1; each
    batch rank forwards its block of a chunk (a multiple of data × fsdp
    rows) and gathers the rest."""
    device = value_params["embed_tokens"].device
    total = qr.shape[0]
    n = 1 if mesh is None else mesh.batch
    chunk = max(1, min(total, ACTIVATION_TOKEN_BUDGET // qr.shape[1]))
    chunk = -(-chunk // n) * n
    vals = []
    for i in range(0, total, chunk):
        n_real = min(chunk, total - i)
        rows = torch.as_tensor(pad_chunk(qr[i:i + chunk], chunk), device=device)
        rows = rows[batch_sharding(mesh, chunk)]
        if ring(mesh):
            v = sp_score_values(value_params, mcfg, rows, pad_id, mesh,
                                lora_scale=lora_scale, fsdp_axis=fsdp_axis(mesh))
        else:
            view, hook = forward_view(value_params, mesh)
            v = score_forward(view, mcfg, rows, pad_id, lora_scale=lora_scale,
                              layer_transform=hook)
        v = own_rows(mesh, v)
        vals.append(v[:n_real, context_length - 1:-1, 0].cpu().numpy())
    return np.concatenate(vals)
