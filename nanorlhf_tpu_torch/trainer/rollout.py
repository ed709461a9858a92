"""One GRPO update's rollout-and-score half — the port of the trainer's
`rollout_body` (`nanorlhf_tpu/trainer/trainer.py:1727-1819`, the
monolithic contiguous path) followed by its reward, group-advantage,
keep-1-of-N and scoring steps (:2029-2189), then the response
post-processing (:2191-2221) and the GRPO branch of `_assemble_batch`
(:2987-3016), as plain functions:

    depad prompts → generate (prefill + sampled decode) → host reward →
    GRPO group z-score → keep 1 of N per prompt → fused policy (with LoRA)
    and ref logprobs of the kept rows → stop-token truncation, padding
    masks, INVALID_LOGPROB fill → sparse terminal reward → γ=1 returns.

As in JAX, the N−1 dropped samples per prompt leave BEFORE the logprob
pass: only `batch_size` rows are scored.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch.algos.advantages import (
    discounted_returns,
    grpo_group_advantage,
    keep_one_of_n_indices,
    sparse_terminal_rewards,
)
from nanorlhf_tpu_torch.ops.masking import (
    INVALID_LOGPROB,
    first_true_indices,
    masked_whiten,
    response_padding_masks,
    truncate_response,
)
from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate
from nanorlhf_tpu_torch.trainer.bucketing import depad_queries
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig
from nanorlhf_tpu_torch.trainer.scoring import (
    forward_token_budget,
    pad_chunk,
    score_chunk,
)

# the JAX trainer's rollout PRNG stream: fold_in(PRNGKey(seed), 0x5E11)
_ROLLOUT_STREAM = 0x5E11
# the port's own streams for the host-side draws the JAX trainer takes by
# splitting its evolving key: keep-1-of-N and the per-epoch permutation
KEEP_STREAM = 0x4EE9
PERM_STREAM = 0x9E77


def check_supported(cfg: RLConfig) -> None:
    """Raise NotImplementedError for every trainer knob that selects a path
    this port has not ported, instead of ignoring it. The sampler knobs
    (paged cache, speculative decode, compaction, chunked prefill) reach
    `sampler.compose_check` through `sampling_params(cfg)`, which raises
    for them."""
    unported = {
        "algo != GRPO": cfg.algo != AlgoName.GRPO,
        "rollout_orchestrator": cfg.rollout_orchestrator,
        "rollout_workers > 1 (fleet)": cfg.rollout_workers > 1,
        "rollout_ahead": cfg.rollout_ahead,
        "rollout_devices > 0": cfg.rollout_devices > 0,
        "env multi-turn (env_max_turns > 1)": bool(cfg.env_name) and cfg.env_max_turns > 1,
        "sequence parallelism (mesh.sp > 1)": cfg.mesh.sp > 1,
        "rollout_prefix_cache": cfg.rollout_prefix_cache,
        "kv_cache_quant='int8'": cfg.kv_cache_quant != "none",
        "rollout_quant='int8'": cfg.rollout_quant != "none",
        "sampler_logprob_capture": cfg.sampler_logprob_capture,
    }
    on = [what for what, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"not ported to nanorlhf_tpu_torch yet: {', '.join(on)}")


def stream_generator(seed: int, stream: int, *index: int,
                     device="cpu") -> torch.Generator:
    """A generator seeded from (seed, stream, *index): the counterpart of
    JAX's `fold_in` chains. Equal arguments give equal draws."""
    state = np.random.SeedSequence([int(seed), int(stream), *map(int, index)])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1)[0]))


def rollout_generator(seed: int, rollout_index: int, device) -> torch.Generator:
    """The generation stream of rollout `rollout_index`, the torch
    counterpart of the trainer's `fold_in(fold_in(PRNGKey(seed), 0x5E11),
    index)`."""
    return stream_generator(seed, _ROLLOUT_STREAM, rollout_index, device=device)


def sampling_params(cfg: RLConfig) -> SamplingParams:
    """The trainer's rollout SamplingParams for a GRPO run."""
    return SamplingParams(
        temperature=cfg.temperature, top_p=cfg.top_p, n=cfg.sample_n,
        max_tokens=cfg.response_length,
        capture_logprobs=cfg.sampler_logprob_capture,
        compaction_segments=cfg.rollout_compaction_segments,
        top_k=cfg.rollout_top_k, approx_top_k=cfg.rollout_approx_top_k,
        shared_prompt_prefill=cfg.rollout_shared_prefill,
        spec_k=cfg.rollout_spec_k, spec_ngram=cfg.rollout_spec_ngram,
        page_size=cfg.rollout_page_size, decode_rows=cfg.rollout_decode_rows,
        prefill_chunk=cfg.rollout_prefill_chunk,
    )


@torch.no_grad()
def rollout_and_score(params, ref_params, mcfg, cfg: RLConfig, tokenizer,
                      queries: np.ndarray, reward_func,
                      generator: torch.Generator, lora_scale: float,
                      keep_generator: torch.Generator,
                      ctx_menu: list[int] | None = None,
                      timings: dict | None = None,
                      sampling: SamplingParams | None = None) -> dict:
    """Roll out `queries` ([B, T] left-padded prompt ids), keep one sample
    per prompt and score the kept rows. Returns numpy arrays: `queries`
    (de-padded, [B, Tq]), `scores` [B·N] (every sample's raw score),
    `keep` [B] (the kept sample of each prompt, drawn from
    `keep_generator`), and for the kept rows `responses` [B, R],
    `advantages` [B] (their group z-scores), `logprobs`, `ref_logprobs`
    [B, R] f32. `ref_params=None` is the ref-free run (kl_coef 0): ref
    logprobs then equal the policy's. `timings`, when given, receives the
    wall seconds of each phase (device-synchronized) and the number of
    decode steps. `sampling` overrides the trainer's SamplingParams (e.g.
    greedy, for parity tests)."""
    check_supported(cfg)
    device = params["embed_tokens"].device
    pad_id, eos_id = tokenizer.pad_token_id, tokenizer.eos_token_id
    n = cfg.sample_n
    t = {} if timings is None else timings
    t_start = time.perf_counter()

    if ctx_menu is not None:
        queries = depad_queries(queries, pad_id, ctx_menu)
    queries_t = torch.as_tensor(queries, dtype=torch.int64, device=device)
    prompt_mask = queries_t != pad_id
    responses = generate(params, mcfg, queries_t, prompt_mask, generator,
                         sampling or sampling_params(cfg), eos_token_id=eos_id,
                         pad_token_id=pad_id, lora_scale=lora_scale,
                         timings=t)
    responses_np = responses.cpu().numpy()
    t["generate_s"] = time.perf_counter() - t_start

    # ---- reward (host-side, user callable) ----
    t0 = time.perf_counter()
    question_strings = [q.replace(tokenizer.pad_token, "")
                        for q in tokenizer.batch_decode(queries)]
    question_n = [q for q in question_strings for _ in range(n)]
    responses_decoded = tokenizer.batch_decode(responses_np)
    scores = np.asarray(reward_func(
        [q + r for q, r in zip(question_n, responses_decoded)],
        tokenizer.eos_token), dtype=np.float32)
    advantages = grpo_group_advantage(torch.as_tensor(scores), n).numpy()
    # keep 1 of N per prompt BEFORE scoring (the reference's forward/backward
    # saving): the group baseline above already saw all N
    batch = queries.shape[0]
    keep = keep_one_of_n_indices(keep_generator, batch, n).cpu().numpy()
    prompt = np.arange(batch)
    advantages = advantages.reshape(batch, n)[prompt, keep]
    responses_np = responses_np.reshape(batch, n, -1)[prompt, keep]
    t["reward_s"] = time.perf_counter() - t0

    # ---- logprob pass (chunked) ----
    t0 = time.perf_counter()
    context_length = queries.shape[1]
    qr = np.concatenate([queries, responses_np], axis=1)
    total = qr.shape[0]
    chunk = cfg.local_rollout_forward_batch_size or max(
        1, forward_token_budget(mcfg.vocab_size, fused_logprob=cfg.fused_logprob)
        // (context_length + cfg.response_length))
    chunk = max(1, min(total, chunk))
    lps, rlps = [], []
    for i in range(0, total, chunk):
        n_real = min(chunk, total - i)
        rows = torch.as_tensor(pad_chunk(qr[i:i + chunk], chunk), device=device)
        lp, rlp = score_chunk(params, ref_params, mcfg, cfg, rows,
                              context_length, pad_id, lora_scale)
        lps.append(lp[:n_real].float().cpu().numpy())
        rlps.append(rlp[:n_real].float().cpu().numpy())  # .cpu() waits for the device
    t["score_s"] = time.perf_counter() - t0
    t["total_s"] = time.perf_counter() - t_start
    return {
        "queries": queries, "responses": responses_np, "scores": scores,
        "keep": keep, "advantages": advantages,
        "logprobs": np.concatenate(lps), "ref_logprobs": np.concatenate(rlps),
        "context_length": context_length,
    }


def postprocess_responses(responses: np.ndarray, stop_id: int | None, pad_id: int):
    """(postprocessed responses, seq_lengths, padding_mask, padding_mask_p1):
    everything after the first stop token becomes pad (when `stop_id`),
    `seq_lengths` is the index of the last real token, and the masks are
    True strictly after it / after the one-past position."""
    post = torch.as_tensor(responses)
    if stop_id is not None:
        post = truncate_response(stop_id, pad_id, post)
    seq_lengths = first_true_indices(post == pad_id) - 1
    padding_mask, padding_mask_p1 = response_padding_masks(post, seq_lengths)
    return post.numpy(), seq_lengths.numpy(), padding_mask.numpy(), padding_mask_p1.numpy()


def assemble_grpo_batch(ro: dict, cfg: RLConfig, stop_id: int | None,
                        pad_id: int, eos_id: int):
    """The update's batch from a `rollout_and_score` result (numpy arrays,
    one row per kept sample), and the post-processed responses. GRPO keeps
    its KL in the loss: the advantage is the group z-score (less
    `missing_eos_penalty` for rows without EOS) placed one past the last
    real token and broadcast back over the row by the γ=1 reversed cumsum."""
    responses = ro["responses"]
    post, seq_lengths, padding_mask, padding_mask_p1 = postprocess_responses(
        responses, stop_id, pad_id)
    logprobs = np.where(padding_mask, INVALID_LOGPROB, ro["logprobs"]).astype(np.float32)
    ref_logprobs = np.where(padding_mask, INVALID_LOGPROB,
                            ro["ref_logprobs"]).astype(np.float32)
    scores_sel = ro["advantages"].astype(np.float32)
    if cfg.missing_eos_penalty is not None:
        contain_eos = (post == eos_id).any(axis=1)
        scores_sel = scores_sel.copy()
        scores_sel[~contain_eos] -= cfg.missing_eos_penalty
    T = responses.shape[1]
    rewards = sparse_terminal_rewards(torch.as_tensor(scores_sel),
                                      torch.as_tensor(seq_lengths), T)
    if cfg.whiten_rewards:
        rewards = masked_whiten(rewards, torch.as_tensor(~padding_mask_p1),
                                shift_mean=True)
        rewards = torch.where(torch.as_tensor(padding_mask_p1),
                              torch.zeros_like(rewards), rewards)
    adv = discounted_returns(rewards, 1.0)
    if cfg.advantage_whiten:
        adv = masked_whiten(adv, torch.as_tensor(~padding_mask))
    adv = np.where(padding_mask, 0.0, adv.numpy()).astype(np.float32)
    qr = np.concatenate([ro["queries"], responses], axis=1)
    batch = {
        "query_responses": qr,
        "responses": responses,
        "logprobs": logprobs,
        "padding_mask": padding_mask,
        "padding_mask_p1": padding_mask_p1,
        "advantages": adv,
        "ref_logprobs": ref_logprobs,
    }
    return batch, post
