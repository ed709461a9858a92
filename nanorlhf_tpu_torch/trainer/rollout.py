"""One update's rollout-and-score half — the port of the trainer's
`rollout_body` (`nanorlhf_tpu/trainer/trainer.py:1727-1819`: the
monolithic loop over the contiguous or paged cache, or the queued
continuous-batching scheduler, exact or with the int8 KV cache, with or
without speculative decode; ReMax's extra greedy rollout) followed by its
reward, GRPO's group advantage and keep-1-of-N, and scoring steps
(:2029-2189), then the response post-processing (:2191-2221) and
`_assemble_batch` (:2968-3089), as plain functions:

    depad prompts → generate (prefill + sampled decode; ReMax: + a greedy
    generate) → host reward → [GRPO: group z-score, keep 1 of N] → fused
    policy (with LoRA) and ref logprobs → stop-token truncation, padding
    masks, INVALID_LOGPROB fill → the algorithm's batch.

With `rollout_quant="int8"` generation samples from the trainer's int8
view of the base projections (`rollout_params`); scoring runs the exact
weights, as in JAX.

GRPO drops its N−1 other samples per prompt BEFORE the logprob pass (only
`batch_size` rows are scored); RLOO and RAFT score all B·N rows and select
after batch assembly, as in JAX.

The half splits where JAX's loop splits it: `generate_rollout` is the
producer's part (JAX's `rollout_body`: de-pad, generate, ReMax's greedy
generate, or the episode driver), which the async orchestrator and fleet
run on their own threads from a published snapshot; `score_rollout` is the
consumer's (reward, keep, scoring). `rollout_and_score` runs both. With
`sampler_logprob_capture` the sampler's logprobs replace the policy
scoring forward (JAX's `score_capture = capture and not use_is`); under
the truncated-IS correction they are the behavior policy's instead, the
policy forward still runs, and the kept rows carry `behavior_logprobs`
(and `segment_ages` when in-flight swaps left segments).

On a mesh with batch ranks (data × fsdp > 1; `mesh`) every rank holds the
same global prompt batch: `generate_rollout` de-pads it, generates only the
rank's `batch_sharding` block of prompts (each with its N samples) through
the normal `generate` — the decode loop holds no collective — from a
generator that folds in the batch rank, then all-gathers the responses
(and the captured logprobs, ReMax's greedy rows), so every rank holds the
global rollout. `score_rollout` grades each rank's own rows and gathers
the scores; advantages, the keep and the permutations are then drawn on
the global batch, the same on every rank, and the scoring forwards split
each chunk's rows over the batch ranks (`scoring.score_chunk`).

The reward goes through `dispatch_reward` (JAX `_dispatch_reward`): the
`reward.exec` fault site and `reward_retries` retries with backoff, a
`reward.dispatch` span on the "reward" track, `latency/reward_s` and the
lineage `reward` event. The host planes come from `planes` (the trainer:
its `faults`, `tracer`, `latency`, `lineage` and `timer`, each optional):
generation gets the tracer and the latency hub, and the three phases run
inside the timer's `rollout`, `reward` and `logprob` phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.algos.advantages import (
    best_of_k_indices,
    discounted_returns,
    gae,
    grpo_group_advantage,
    grpo_turn_advantage,
    keep_one_of_n_indices,
    per_turn_terminal_rewards,
    remax_advantage,
    rloo_advantage,
    sparse_terminal_rewards,
)
from nanorlhf_tpu_torch.parallel.mesh import A14C, batch_sharding
from nanorlhf_tpu_torch.resilience.retry import retry_with_backoff
from nanorlhf_tpu_torch.ops.masking import (
    INVALID_LOGPROB,
    first_true_indices,
    masked_whiten,
    response_padding_masks,
    truncate_response,
)
from nanorlhf_tpu_torch.sampler.sampler import (  # noqa: F401 (re-export)
    SamplingParams,
    compose_check,
    generate,
    stream_generator,
)
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


def check_fleet_values(cfg: RLConfig) -> None:
    """The JAX trainer's ValueErrors on the async orchestrator's and the
    rollout fleet's knobs (`nanorlhf_tpu/trainer/trainer.py:377-430`),
    in its order and with its messages."""
    if cfg.rollout_orchestrator:
        if cfg.rollout_ahead:
            raise ValueError(
                "rollout_orchestrator generalizes rollout_ahead — enable "
                "one, not both")
        if cfg.max_staleness < 0:
            raise ValueError(f"max_staleness={cfg.max_staleness}")
        if cfg.staleness_policy not in ("wait", "drop"):
            raise ValueError(
                f"staleness_policy={cfg.staleness_policy!r}: wait|drop")
    if cfg.rollout_workers < 1:
        raise ValueError(f"rollout_workers={cfg.rollout_workers}")
    if cfg.rollout_workers > 1 and not cfg.rollout_orchestrator:
        raise ValueError(
            "rollout_workers > 1 is the fleet generalization of the "
            "async pipeline — it requires rollout_orchestrator=True "
            "(docs/FLEET.md)")
    if cfg.rollout_transport not in ("inprocess", "rpc"):
        raise ValueError(
            f"rollout_transport={cfg.rollout_transport!r}: inprocess | rpc")
    if cfg.rollout_transport == "rpc" and cfg.rollout_workers <= 1:
        raise ValueError(
            "rollout_transport='rpc' is the fleet's network seam — it "
            "requires rollout_workers > 1 (docs/FLEET.md)")
    if cfg.offpolicy_correction not in ("truncated_is", "none"):
        raise ValueError(f"offpolicy_correction={cfg.offpolicy_correction!r}")
    if cfg.rollout_inflight_swaps:
        if not cfg.rollout_orchestrator:
            raise ValueError(
                "rollout_inflight_swaps reads the orchestrator's weight "
                "store mid-generation — it requires "
                "rollout_orchestrator=True (docs/ORCHESTRATOR.md)")
        if cfg.rollout_page_size <= 0 or cfg.rollout_decode_rows <= 0:
            raise ValueError(
                "rollout_inflight_swaps swaps weights at chunk boundaries "
                "of the queued paged scheduler — it requires "
                "rollout_page_size > 0 and rollout_decode_rows > 0 "
                "(docs/PAGED_CACHE.md)")


def uses_truncated_is(cfg: RLConfig) -> bool:
    """JAX's `_use_is`: the orchestrator may run stale (max_staleness > 0),
    the sampler captures the behavior policy's logprobs, and the
    correction is on."""
    return bool(cfg.rollout_orchestrator and cfg.max_staleness > 0
                and cfg.sampler_logprob_capture
                and cfg.offpolicy_correction == "truncated_is")


def check_supported(cfg: RLConfig) -> None:
    """The JAX trainer's ValueErrors on the orchestrator's and the fleet's
    knobs (`check_fleet_values`) first; then raise NotImplementedError for
    every trainer knob that selects a path this port has not ported
    (disaggregated rollout devices), instead of
    ignoring it, and run the decode features' legality matrix
    (`sampler.compose_check`, ValueError) once, as the JAX trainer does at
    construction. The mesh's axes are `parallel.mesh.make_mesh`'s to check
    (data, fsdp and sp are ported; tensor waits for A14c). Ported:
    compacting decode, sequence parallelism, the paged cache
    and continuous batching, the int8 KV cache, speculative decode, int8
    rollout weights, the radix prefix cache, chunked prefill, multi-turn
    environments (validated by the trainer), the async orchestrator and
    the fleet (`rollout_orchestrator`, `rollout_workers`,
    `rollout_transport`), `rollout_ahead`, `sampler_logprob_capture` and
    in-flight weight swaps."""
    check_fleet_values(cfg)
    if cfg.kv_cache_quant not in ("none", "int8"):
        raise ValueError(f"kv_cache_quant={cfg.kv_cache_quant!r}")
    if cfg.rollout_quant not in ("none", "int8"):
        raise ValueError(f"rollout_quant={cfg.rollout_quant!r}")
    if cfg.rollout_devices > 0 or cfg.rollout_mesh is not None:
        raise NotImplementedError(
            "rollout_devices > 0 (disaggregated rollout devices, rollout_mesh) is not "
            f"ported to nanorlhf_tpu_torch: it waits for {A14C}")
    compose_check(SamplingParams(page_size=cfg.rollout_page_size,
                                 decode_rows=cfg.rollout_decode_rows,
                                 spec_k=cfg.rollout_spec_k,
                                 prefill_chunk=cfg.rollout_prefill_chunk,
                                 compaction_segments=cfg.rollout_compaction_segments),
                  prefix_cache=cfg.rollout_prefix_cache)


def rollout_generator(seed: int, rollout_index: int, device,
                      batch_rank: int = 0) -> torch.Generator:
    """The generation stream of rollout `rollout_index`, the torch
    counterpart of the trainer's `fold_in(fold_in(PRNGKey(seed), 0x5E11),
    index)`; batch rank r > 0 folds r in, so no two ranks' rows share
    their draws (rank 0 keeps the one-rank stream)."""
    index = (rollout_index,) if batch_rank == 0 else (rollout_index, batch_rank)
    return stream_generator(seed, _ROLLOUT_STREAM, *index, device=device)


def gather_rows(mesh, rows: np.ndarray | None) -> np.ndarray | None:
    """Every batch rank's block of host rows, concatenated in rank order
    (the block itself without batch ranks)."""
    if rows is None or mesh is None or mesh.batch == 1:
        return rows
    return np.concatenate(mesh.batch_transport.all_gather_object(rows))


def rollout_model_config(mcfg, cfg: RLConfig):
    """The generation-side model config: the int8 KV cache is a rollout-only
    variant (`kv_cache_quant`); scoring and the update keep the exact
    config (they never build a cache), as in JAX."""
    if cfg.kv_cache_quant != mcfg.kv_cache_quant:
        return dataclasses.replace(mcfg, kv_cache_quant=cfg.kv_cache_quant)
    return mcfg


def sampling_params(cfg: RLConfig) -> SamplingParams:
    """The trainer's rollout SamplingParams."""
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


def env_sampling_params(cfg: RLConfig) -> SamplingParams:
    """The first turn's SamplingParams of a multi-turn episode (JAX
    trainer.py:1702-1713): the per-turn budget `env_turn_tokens` (default
    the whole response), no logprob capture, no speculative decode."""
    return SamplingParams(
        temperature=cfg.temperature, top_p=cfg.top_p, n=cfg.sample_n,
        max_tokens=cfg.env_turn_tokens or cfg.response_length,
        top_k=cfg.rollout_top_k, approx_top_k=cfg.rollout_approx_top_k,
        shared_prompt_prefill=cfg.rollout_shared_prefill,
        page_size=cfg.rollout_page_size, decode_rows=cfg.rollout_decode_rows,
    )


def _plane(planes, name: str):
    """`planes.<name>` when it is there and enabled, else None."""
    obj = getattr(planes, name, None)
    return obj if obj is not None and getattr(obj, "enabled", True) else None


def _phase(planes, name: str):
    timer = getattr(planes, "timer", None)
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def dispatch_reward(reward_func, texts: list[str], eos_token: str, retries: int,
                    planes=None, rollout_index: int | None = None,
                    step: int | None = None) -> np.ndarray:
    """Score `texts` with `reward_func(texts, eos_token)` — JAX's
    `_dispatch_reward`: each attempt fires the `reward.exec` fault site,
    and a failed attempt is retried `retries` times with backoff (base
    0.1 s); the dispatch is one `reward.dispatch` span on the "reward"
    track, its wall (backoff included) one `latency/reward_s` record, and,
    with a `rollout_index`, one lineage `reward` event (scores, the attempt
    that landed, the wall)."""
    faults, tracer = getattr(planes, "faults", None), _plane(planes, "tracer")
    latency, lineage = _plane(planes, "latency"), getattr(planes, "lineage", None)
    attempts_used = [0]

    def attempt():
        attempts_used[0] += 1
        if faults is not None:
            faults.fire("reward.exec")
        return np.asarray(reward_func(texts, eos_token), dtype=np.float32)

    span = (tracer.span("reward.dispatch", track="reward", rows=len(texts))
            if tracer is not None else contextlib.nullcontext())
    with span:
        t0 = time.perf_counter()
        scores = retry_with_backoff(attempt, attempts=retries + 1, backoff_base=0.1)
    if latency is not None:
        latency.record("latency/reward_s", time.perf_counter() - t0)
    if rollout_index is not None and lineage is not None:
        lineage.reward(rollout_index, step=step,
                       scores=[round(float(x), 6) for x in scores.tolist()],
                       attempt=attempts_used[0],
                       wall_s=round(time.perf_counter() - t0, 6))
    return scores


def _host(obj):
    """A payload's device scalars and tensors as host numbers and arrays, so
    a sample crosses threads and the RPC wire as data."""
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.dim() == 0 else obj.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_host(v) for v in obj]
    return obj


@torch.no_grad()
def generate_rollout(gen_params, mcfg, cfg: RLConfig, tokenizer, queries: np.ndarray,
                     generator: torch.Generator, lora_scale: float, *,
                     ctx_menu: list[int] | None = None,
                     sampling: SamplingParams | None = None,
                     timings: dict | None = None, planes=None,
                     prefix_cache=None, env=None, weight_refresh=None,
                     mesh=None) -> dict:
    """The producer half of one rollout (JAX's `rollout_body`): de-pad the
    [B, T] left-padded prompt ids, then generate from `gen_params` (the
    live policy, its int8 view, or a published snapshot) — ReMax also
    generates greedily, a multi-turn `env` runs the episode driver instead.
    Returns the payload, host data only: `queries` (de-padded), `responses`
    [B·N, R], `captured_logprobs` (the sampler's, with capture; else None),
    `greedy` (ReMax's [B, R], else None), `paged_stats`, `spec_stats`,
    `env` (the driver's payload, else None), `timings` (the generate's
    phases, `generate_s`) and, under `weight_refresh`, `segments`,
    `swap_installs` and `swap_wait_s` hoisted from the paged stats.
    `planes` gives generation the tracer, the latency hub and the fault
    injector. `mesh` with batch ranks: the global prompts are de-padded,
    this rank generates its block and the rows are all-gathered (module
    docstring; a multi-turn `env` is refused there, A14c)."""
    check_supported(cfg)
    if cfg.rollout_prefix_cache and prefix_cache is None:
        from nanorlhf_tpu_torch.serving.radix import RadixCache
        prefix_cache = RadixCache()
    device = gen_params["embed_tokens"].device
    pad_id, eos_id = tokenizer.pad_token_id, tokenizer.eos_token_id
    t = {} if timings is None else timings
    t_start = time.perf_counter()
    if ctx_menu is not None:
        queries = depad_queries(queries, pad_id, ctx_menu)
    if env is not None and mesh is not None and mesh.batch > 1:
        raise NotImplementedError(
            f"multi-turn environments on data x fsdp > 1 wait for {A14C}")
    block = batch_sharding(mesh, queries.shape[0])
    queries_t = torch.as_tensor(queries[block], dtype=torch.int64, device=device)
    prompt_mask = queries_t != pad_id
    paged_stats: list = []
    spec_stats: list = []
    compaction_stats: list = []
    gen_mcfg = rollout_model_config(mcfg, cfg)
    tracer, latency = _plane(planes, "tracer"), _plane(planes, "latency")
    out = {"queries": queries, "captured_logprobs": None, "greedy": None,
           "env": None}
    if env is not None:
        from nanorlhf_tpu_torch.envs.rollout import run_env_episodes

        env_sampling = sampling or env_sampling_params(cfg)
        payload = run_env_episodes(
            gen_params, gen_mcfg, queries_t, prompt_mask, generator, env_sampling,
            env, eos_token_id=eos_id, pad_token_id=pad_id, tokenizer=tokenizer,
            max_turns=cfg.env_max_turns, turn_tokens=env_sampling.max_tokens,
            obs_budget=cfg.env_obs_budget, response_length=cfg.response_length,
            page_size=cfg.rollout_page_size,
            decode_rows=cfg.env_decode_rows or cfg.rollout_decode_rows,
            lora_scale=lora_scale, faults=getattr(planes, "faults", None))
        out.update(responses=payload["tokens"], env=payload)
        t["tool_s"] = payload["stats"]["env/tool_wall_s"]
    else:
        sp = sampling or sampling_params(cfg)
        result = generate(
            gen_params, gen_mcfg, queries_t, prompt_mask, generator, sp,
            eos_token_id=eos_id, pad_token_id=pad_id, lora_scale=lora_scale,
            timings=t, paged_stats_out=paged_stats, spec_stats_out=spec_stats,
            tracer=tracer, latency=latency, prefix_cache=prefix_cache,
            weight_refresh=weight_refresh, compaction_stats_out=compaction_stats)
        if sp.capture_logprobs:
            result, captured = result
            out["captured_logprobs"] = captured.float().cpu().numpy()
        out["responses"] = result.cpu().numpy()
    if cfg.algo == AlgoName.REMAX:
        # the greedy rollout of the same prompts: ReMax's baseline
        tg: dict = {}
        out["greedy"] = generate(
            gen_params, gen_mcfg, queries_t, prompt_mask, generator,
            SamplingParams(greedy=True, max_tokens=cfg.response_length),
            eos_token_id=eos_id, pad_token_id=pad_id, lora_scale=lora_scale,
            timings=tg).cpu().numpy()
        t.update({f"greedy_{k}": v for k, v in tg.items()})
        if "graph_capture_s" in tg:
            t["graph_capture_s"] = t.get("graph_capture_s", 0.0) + tg["graph_capture_s"]
    for key in ("responses", "captured_logprobs", "greedy"):
        out[key] = gather_rows(mesh, out[key])
    t["generate_s"] = time.perf_counter() - t_start
    out["paged_stats"] = _host(paged_stats[0]) if paged_stats else None
    out["spec_stats"] = _host(spec_stats[0]) if spec_stats else None
    out["compaction_stats"] = compaction_stats[0] if compaction_stats else None
    if weight_refresh is not None and out["paged_stats"] is not None:
        # swap provenance at the payload's top level: the lineage ledger and
        # the per-segment IS assembly read it from here
        for k in ("segments", "swap_installs", "swap_wait_s"):
            if k in out["paged_stats"]:
                out[k] = out["paged_stats"][k]
    out["timings"] = t
    return out


def segment_ages(segments: list, shape) -> np.ndarray:
    """Per-token policy ages [rows, R] int32 from each row's swap segments
    (JAX trainer.py:2034-2048): the newest version in the row minus the
    token's segment version; rows no swap touched are all zero."""
    ages = np.zeros(shape, np.int32)
    for r, segs in enumerate(segments):
        newest = max(seg["policy_version"] for seg in segs)
        for seg in segs:
            lo, hi = seg["tok_range"]
            if newest > seg["policy_version"]:
                ages[r, lo:hi] = newest - seg["policy_version"]
    return ages


@torch.no_grad()
def score_rollout(payload: dict, params, ref_params, mcfg, cfg: RLConfig, tokenizer,
                  reward_func, lora_scale: float, keep_generator: torch.Generator,
                  timings: dict | None = None, planes=None,
                  rollout_index: int | None = None, step: int | None = None,
                  use_is: bool = False, use_seg: bool = False, mesh=None) -> dict:
    """The consumer half of one rollout (JAX's loop from the reward to the
    logprob pass): reward, [GRPO: group z-score, keep 1 of N], and the
    chunked logprob pass of `params` (with LoRA) and the ref. The capture
    matrix is JAX's: with captured logprobs and no IS correction the
    sampler's logprobs are the policy's (no policy forward; ref-free: no
    forward at all); with the IS correction (`use_is`) they are the
    behavior policy's and ride out as `behavior_logprobs`, with the
    per-token `segment_ages` when `use_seg` and the payload has segments.
    `mesh`: sp > 1 scores around the ring; batch ranks each grade their
    own rows (the scores are gathered) and split every scoring chunk's
    rows. Returns what `rollout_and_score` documents."""
    device = params["embed_tokens"].device
    pad_id = tokenizer.pad_token_id
    n = cfg.sample_n
    t = {} if timings is None else timings
    queries, responses_np = payload["queries"], payload["responses"]
    captured = payload["captured_logprobs"]
    envp = payload["env"]

    # ---- reward (host-side, user callable) ----
    t0 = time.perf_counter()
    question_strings = [q.replace(tokenizer.pad_token, "")
                        for q in tokenizer.batch_decode(queries)]
    question_n = [q for q in question_strings for _ in range(n)]
    responses_decoded = tokenizer.batch_decode(responses_np)
    with _phase(planes, "reward"):
        if envp is not None:
            # the episodes' rewards accrued turn by turn in the driver (the
            # terminal grader already ran per episode): no dispatch
            scores = envp["scores"]
            lineage = getattr(planes, "lineage", None)
            if rollout_index is not None and lineage is not None:
                lineage.reward(rollout_index, step=step,
                               scores=[round(float(x), 6) for x in scores.tolist()],
                               attempt=1, wall_s=envp["stats"]["env/tool_wall_s"])
                for rec in envp["turns"]:
                    lineage.turn(rollout_index, step=step, **rec)
        else:
            texts = [q + r for q, r in zip(question_n, responses_decoded)]
            scores = gather_rows(mesh, dispatch_reward(
                reward_func, texts[batch_sharding(mesh, len(texts))],
                tokenizer.eos_token, cfg.reward_retries, planes,
                rollout_index=rollout_index, step=step))
    batch = queries.shape[0]
    out = {"queries": queries, "scores": scores, "keep": None}
    if envp is not None:
        out["env"] = envp
    if payload["greedy"] is not None:
        texts = [q + r for q, r in zip(question_strings,
                                       tokenizer.batch_decode(payload["greedy"]))]
        out["greedy_scores"] = gather_rows(mesh, dispatch_reward(
            reward_func, texts[batch_sharding(mesh, len(texts))],
            tokenizer.eos_token, cfg.reward_retries, planes))
    seg_ages = None
    if use_seg and payload.get("segments") is not None:
        seg_ages = segment_ages(payload["segments"], responses_np.shape)
    if cfg.algo == AlgoName.GRPO:
        advantages = grpo_group_advantage(torch.as_tensor(scores), n).numpy()
        # keep 1 of N per prompt BEFORE scoring (the reference's
        # forward/backward saving): the group baseline above saw all N
        keep = keep_one_of_n_indices(keep_generator, batch, n).cpu().numpy()
        prompt = np.arange(batch)
        out["advantages"] = advantages.reshape(batch, n)[prompt, keep]
        out["keep"] = keep
        if envp is not None:
            # each turn column z-scored against the FULL group before the
            # keep drops N−1 siblings; the turn ends and the observation
            # mask ride the same selection
            turn_adv = grpo_turn_advantage(torch.as_tensor(envp["turn_rewards"]),
                                           n).numpy()
            for key, arr in (("turn_advantages", turn_adv),
                             ("turn_ends", envp["turn_ends"]),
                             ("loss_mask", envp["loss_mask"])):
                out[key] = arr.reshape(batch, n, -1)[prompt, keep]

        def kept(a):
            return None if a is None else a.reshape(batch, n, -1)[prompt, keep]

        responses_np, captured, seg_ages = kept(responses_np), kept(captured), kept(seg_ages)
        queries_rep = queries
    else:
        queries_rep = np.repeat(queries, n, axis=0)
    t["reward_s"] = time.perf_counter() - t0

    # ---- logprob pass (chunked) ----
    t0 = time.perf_counter()
    context_length = queries.shape[1]
    qr = np.concatenate([queries_rep, responses_np], axis=1)
    total = qr.shape[0]
    chunk = cfg.local_rollout_forward_batch_size or max(
        1, forward_token_budget(mcfg.vocab_size, fused_logprob=cfg.fused_logprob)
        // (context_length + cfg.response_length))
    chunk = max(1, min(total, chunk))
    if mesh is not None:
        # every chunk splits evenly over the batch ranks
        chunk = -(-chunk // mesh.batch) * mesh.batch
    # the sampler's logprobs stand for the policy's unless they are the
    # stale behavior policy's (truncated IS)
    score_capture = captured is not None and not use_is
    ref_free = ref_params is None
    lps, rlps = [], []
    with _phase(planes, "logprob"):
        if not (ref_free and score_capture):
            for i in range(0, total, chunk):
                n_real = min(chunk, total - i)
                rows = torch.as_tensor(pad_chunk(qr[i:i + chunk], chunk), device=device)
                lp, rlp = score_chunk(params, ref_params, mcfg, cfg, rows,
                                      context_length, pad_id, lora_scale,
                                      score_policy=not score_capture, mesh=mesh)
                if lp is not None:
                    lps.append(lp[:n_real].float().cpu().numpy())
                rlps.append(rlp[:n_real].float().cpu().numpy())  # .cpu() waits
    logprobs = (captured if score_capture else np.concatenate(lps)).astype(np.float32)
    ref_logprobs = logprobs.copy() if ref_free else np.concatenate(rlps)
    t["score_s"] = time.perf_counter() - t0
    out.update(responses=responses_np, logprobs=logprobs, ref_logprobs=ref_logprobs,
               context_length=context_length, score_capture=score_capture)
    if use_is:
        out["behavior_logprobs"] = captured.astype(np.float32)
    if seg_ages is not None:
        out["segment_ages"] = seg_ages
    for key in ("paged_stats", "spec_stats", "segments", "swap_installs",
                "swap_wait_s"):
        if payload.get(key) is not None:
            out[key] = payload[key]
    return out


@torch.no_grad()
def rollout_and_score(params, ref_params, mcfg, cfg: RLConfig, tokenizer,
                      queries: np.ndarray, reward_func,
                      generator: torch.Generator, lora_scale: float,
                      keep_generator: torch.Generator,
                      ctx_menu: list[int] | None = None,
                      timings: dict | None = None,
                      sampling: SamplingParams | None = None,
                      launches: dict | None = None,
                      rollout_params: dict | None = None, planes=None,
                      rollout_index: int | None = None,
                      step: int | None = None, on_generated=None,
                      prefix_cache=None, env=None) -> dict:
    """Roll out `queries` ([B, T] left-padded prompt ids), score each
    sample with `reward_func`, and run the logprob pass: `generate_rollout`
    then `score_rollout`. Returns numpy arrays: `queries` (de-padded, [B,
    Tq]), `scores` [B·N] (every sample's raw score), `logprobs`,
    `ref_logprobs` and `responses` [rows, R] f32 / ids. GRPO keeps one
    sample per prompt before scoring: rows = B, `keep` [B] (drawn from
    `keep_generator`) and `advantages` [B] (the kept rows' group z-scores).
    The other algorithms score all rows = B·N (`keep` None); ReMax also
    rolls out greedily and carries `greedy_scores` [B]. `ref_params=None`
    is the ref-free run (kl_coef 0): ref logprobs then equal the policy's.
    `timings`, when given, receives the wall seconds of each phase
    (device-synchronized) and the number of decode steps (and the decode
    loop's `graph_capture_s`, `graph_steps_run`, `graph_replays`:
    `sampler/graph.py`; ReMax's greedy generate adds its own under
    `greedy_*`, and its capture to `graph_capture_s`). `sampling` overrides
    the trainer's SamplingParams (e.g. greedy, for parity tests). On a
    paged rollout the result also carries `paged_stats`, on a speculative
    one `spec_stats` (the sampler's stats dicts, as host numbers).
    `launches`, when given, receives the kernel launches of the generation
    (`generate`, both of ReMax's: each CUDA-graph replay of the decode loop
    counts what it launched) and of the scoring pass (`score`).
    `rollout_params` is the tree generation samples from (default
    `params`): the trainer's int8 rollout view (`core/quant.rollout_view`);
    scoring always runs `params`. `planes`, `rollout_index` and `step`: the
    host planes (module docstring), and the rollout index and global step
    the lineage events carry. `on_generated(payload, generate_s)`, when
    given, is called once the tokens are on the host, before the reward.
    `prefix_cache` is the trainer's `RadixCache` (`rollout_prefix_cache`; a
    fresh one when None: the scheduler resets it at every call anyway, the
    trainer's keeps the cumulative stats).

    `env` (a multi-turn `Environment`, GRPO only) swaps generation for the
    episode driver (`envs/rollout.run_env_episodes`, the first turn from
    `sampling` or `env_sampling_params(cfg)`): the scores are the episodes'
    summed turn rewards (no reward dispatch; lineage gets the `reward`
    event and one `turn` event per (episode, turn)), and the kept rows
    also carry `turn_advantages` (each turn column z-scored in its group
    before the keep), `turn_ends` and `loss_mask` (False on observation
    tokens); the result carries the driver's payload as `env`."""
    t = {} if timings is None else timings
    t_start = time.perf_counter()
    counts0 = launch_counts()
    with _phase(planes, "rollout"):
        payload = generate_rollout(
            params if rollout_params is None else rollout_params, mcfg, cfg,
            tokenizer, queries, generator, lora_scale, ctx_menu=ctx_menu,
            sampling=sampling, timings=t, planes=planes,
            prefix_cache=prefix_cache, env=env)
    counts1 = launch_counts()
    if on_generated is not None:
        on_generated(payload, t["generate_s"])
    out = score_rollout(payload, params, ref_params, mcfg, cfg, tokenizer, reward_func,
                        lora_scale, keep_generator, timings=t, planes=planes,
                        rollout_index=rollout_index, step=step)
    t["total_s"] = time.perf_counter() - t_start
    if launches is not None:
        counts2 = launch_counts()
        launches["generate"] = {k: counts1[k] - counts0[k] for k in counts0}
        launches["score"] = {k: counts2[k] - counts1[k] for k in counts0}
    return out


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


def _whiten_rewards(rewards: torch.Tensor, padding_mask_p1: np.ndarray) -> torch.Tensor:
    """`whiten_rewards`: whiten over the valid value positions, zero after."""
    pm1 = torch.as_tensor(padding_mask_p1)
    rewards = masked_whiten(rewards, ~pm1, shift_mean=True)
    return torch.where(pm1, torch.zeros_like(rewards), rewards)


def _token_advantages(adv: torch.Tensor, cfg: RLConfig,
                      padding_mask: np.ndarray) -> np.ndarray:
    """`advantage_whiten` over the real tokens, then zero at the pads."""
    if cfg.advantage_whiten:
        adv = masked_whiten(adv, torch.as_tensor(~padding_mask))
    return np.where(padding_mask, 0.0, adv.numpy()).astype(np.float32)


def assemble_batch(ro: dict, cfg: RLConfig, stop_id: int | None, pad_id: int,
                   eos_id: int, keep_generator: torch.Generator | None = None,
                   value_fn=None):
    """The update's batch from a `rollout_and_score` result (numpy arrays),
    branch by branch as JAX's `_assemble_batch`. Each row's terminal score
    (GRPO: its group z-score; ReMax: score − greedy score; else the raw
    score, less `missing_eos_penalty` for rows without EOS) lands one past
    its last real token, then:

    - GRPO keeps its KL in the loss: the γ=1 reversed cumsum broadcasts
      the score over the row;
    - every other algorithm puts −kl_coef · (logπ − logπ_ref) into the
      per-token reward (`non_score_reward_old`, `rlhf_reward_old` are over
      all B·N rows); RLOO: the leave-one-out sequence advantage, then keep
      1 of N from `keep_generator`; RAFT: best-of-K (`raft_selection`
      "best", or "random" from `keep_generator`); PPO: `value_fn(qr)` →
      values, GAE(γ, λ) → advantages, returns; REINFORCE and ReMax: the
      γ-discounted returns.

    The kept rows' `behavior_logprobs` (pads INVALID) and `segment_ages`
    of an IS run ride into the batch and through every selection.

    Returns (batch, info): info holds the post-processed responses `post`,
    the INVALID-filled `logprobs` / `ref_logprobs` and `padding_mask` of
    every scored row (the `_old` metrics read them), the kept sample of
    each prompt `keep` (GRPO's from the rollout, RLOO's and RAFT's from
    here; None otherwise), and the two reward metrics."""
    responses = ro["responses"]
    # multi-turn episodes carry interior per-turn EOS tokens the stop-token
    # truncation would cut at; the driver packed them left-justified with
    # pads only at the tail, so the first-pad lengths stay right
    post, seq_lengths, padding_mask, padding_mask_p1 = postprocess_responses(
        responses, stop_id if "env" not in ro else None, pad_id)
    logprobs = np.where(padding_mask, INVALID_LOGPROB, ro["logprobs"]).astype(np.float32)
    ref_logprobs = np.where(padding_mask, INVALID_LOGPROB,
                            ro["ref_logprobs"]).astype(np.float32)
    algo = cfg.algo
    if algo == AlgoName.GRPO:
        scores_sel = ro["advantages"]
    elif algo == AlgoName.REMAX:
        scores_sel = remax_advantage(torch.as_tensor(ro["scores"]),
                                     torch.as_tensor(ro["greedy_scores"])).numpy()
    else:
        scores_sel = ro["scores"]
    scores_sel = scores_sel.astype(np.float32)
    if cfg.missing_eos_penalty is not None:
        contain_eos = (post == eos_id).any(axis=1)
        scores_sel = scores_sel.copy()
        scores_sel[~contain_eos] -= cfg.missing_eos_penalty
    T = responses.shape[1]
    qr = np.concatenate([np.repeat(ro["queries"], responses.shape[0]
                                   // ro["queries"].shape[0], axis=0), responses], axis=1)
    batch = {
        "query_responses": qr,
        "responses": responses,
        "logprobs": logprobs,
        "padding_mask": padding_mask,
        "padding_mask_p1": padding_mask_p1,
    }
    if "behavior_logprobs" in ro:
        # the stale sampling policy's logprobs, masked like `logprobs` so the
        # IS weight is 1 at the pads; they ride every selection below
        batch["behavior_logprobs"] = np.where(
            padding_mask, INVALID_LOGPROB, ro["behavior_logprobs"]).astype(np.float32)
    if "segment_ages" in ro:
        batch["segment_ages"] = ro["segment_ages"]
    info = {"post": post, "logprobs": logprobs, "ref_logprobs": ref_logprobs,
            "padding_mask": padding_mask, "keep": ro.get("keep")}
    if algo == AlgoName.GRPO:
        if "turn_advantages" in ro:
            # multi-turn episodes: one spike at each turn's last model token
            # instead of one terminal spike; the γ=1 cumsum below makes each
            # turn's credit reward-to-go over the tokens that produced it
            rewards = per_turn_terminal_rewards(torch.as_tensor(ro["turn_advantages"]),
                                                torch.as_tensor(ro["turn_ends"]), T)
        else:
            rewards = sparse_terminal_rewards(torch.as_tensor(scores_sel),
                                              torch.as_tensor(seq_lengths), T)
        if cfg.whiten_rewards:
            rewards = _whiten_rewards(rewards, padding_mask_p1)
        batch["advantages"] = _token_advantages(discounted_returns(rewards, 1.0),
                                                cfg, padding_mask)
        batch["ref_logprobs"] = ref_logprobs
        if "loss_mask" in ro:
            # observation tokens: conditioned on, never scored
            batch["loss_mask"] = ro["loss_mask"]
        info["non_score_reward_old"] = 0.0
        return batch, info

    # the KL-in-reward family
    kl_penalty = (-cfg.kl_coef * np.where(padding_mask, 0.0, logprobs - ref_logprobs)
                  ).astype(np.float32)
    rewards = sparse_terminal_rewards(torch.as_tensor(scores_sel),
                                      torch.as_tensor(seq_lengths), T,
                                      kl_penalty=torch.as_tensor(kl_penalty))
    if cfg.whiten_rewards:
        rewards = _whiten_rewards(rewards, padding_mask_p1)
    info["non_score_reward_old"] = float(kl_penalty.sum(1).mean())
    info["rlhf_reward_old"] = float(rewards.sum(1).mean())

    if algo in (AlgoName.RLOO, AlgoName.RAFT):
        n = cfg.sample_n
        prompts = responses.shape[0] // n
        rlhf_reward = rewards.sum(1)
        if algo == AlgoName.RLOO:
            keep = keep_one_of_n_indices(keep_generator, prompts, n).cpu().numpy()
        else:
            keep = best_of_k_indices(
                rlhf_reward, n,
                keep_generator if cfg.raft_selection == "random" else None).cpu().numpy()
        rows = np.arange(prompts)
        batch = {k: v.reshape(prompts, n, *v.shape[1:])[rows, keep]
                 for k, v in batch.items()}
        if algo == AlgoName.RLOO:
            adv_seq = rloo_advantage(rlhf_reward, n).reshape(prompts, n)[rows, keep]
            if cfg.advantage_whiten:
                adv_seq = masked_whiten(adv_seq, torch.ones_like(adv_seq, dtype=torch.bool))
            batch["advantages_seq"] = adv_seq.numpy().astype(np.float32)
        info["keep"] = keep
        return batch, info

    if algo == AlgoName.PPO:
        values = np.where(padding_mask_p1, 0.0, value_fn(qr)).astype(np.float32)
        adv, returns = gae(rewards, torch.as_tensor(values), cfg.gamma, cfg.lam)
        batch["advantages"] = _token_advantages(adv, cfg, padding_mask)
        batch["returns"] = returns.numpy().astype(np.float32)
        batch["values"] = values
        return batch, info

    # REINFORCE / ReMax: the γ-discounted reversed cumsum
    batch["advantages"] = _token_advantages(discounted_returns(rewards, cfg.gamma),
                                            cfg, padding_mask)
    return batch, info
