"""Draft-free speculative decode — the port of
`nanorlhf_tpu/sampler/speculative.py`: n-gram drafting against each row's
own prompt+output buffer, one k-token verify forward per iteration
(`core/model.decode_verify`: K6 over the contiguous cache, K9 over the
paged one), and the exact acceptance rule.

Per iteration, for every row:
  1. draft: the spec_k tokens that followed the most recent earlier
     occurrence of the row's last spec_ngram tokens (pads when there is
     none; verification rejects them);
  2. verify: one forward over [cur_tok, d_1..d_k] against the cache, giving
     the next-token distribution after each candidate prefix;
  3. accept: greedy rows keep the longest draft prefix equal to the argmax
     chain (the monolithic loop's tokens); sampled rows run
     deterministic-proposal rejection sampling (Leviathan et al. 2023,
     Chen et al. 2023) against the same filtered distribution
     `_sample_token` draws from, so the output distribution is unchanged.
     Every live row emits 1..k+1 tokens.

Bookkeeping is per row, as in JAX: `n_gen` [B] generated tokens, the
current token's cache slot Tp + n_gen - 1, accepted candidates made
visible by extending `key_mask`; rejected candidates leave K/V in slots
never marked valid, which the next verify overwrites. The contiguous cache
carries spec_k slack slots (`_prefill_state(cache_extra=spec_k)`); the
paged one none (a write past a row's pages lands on the scratch page).

The JAX `while_loop` becomes the port's compiled decode loop
(`sampler/graph.py`): the draft + verify body over device state, predicated
on JAX's condition (iteration <= max_tokens and not every row done),
replayed from a CUDA graph in chunks of `sync_every` iterations with a host
check between chunks (eager chunks on the CPU; `decode_loop="per_step"`
checks before every iteration). Sampled acceptance draws from the port's
generator — u, then the residual categorical, per iteration — so it
matches JAX in distribution, not bit for bit; greedy streams and their
statistics match exactly.

With an enabled `tracer` (a `telemetry.SpanTracer`) `generate_spec` runs
the traced loop instead (JAX `_generate_spec_instrumented`): the same draft
and verify bodies, one iteration per host step, eagerly (no graph), with a
`rollout.draft` and a `rollout.verify` span per iteration on the "rollout"
track and one device sync after each — the observability trade; its greedy
tokens equal the compiled loop's.

Under the radix prefix cache the queued session seeds each row's lookup
window with the tree's cached continuation of its matched prefix
(`_draft_fn`'s `seed_rep` / `seed_len`, JAX's `_spec_chunk_seeded`).
"""

from __future__ import annotations

import time

import torch

from nanorlhf_tpu_torch.core.model import decode_verify
from nanorlhf_tpu_torch.ops.masking import guard_temperature
from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, run_loop
from nanorlhf_tpu_torch.sampler.sampler import (
    _categorical,
    _prefill_state,
    filtered_logits_full,
    sync_device,
)

# the speculative counters of the state dict, in the stats tuple's order
_COUNTERS = ("n_drafted", "n_accepted", "n_emitted", "n_rowsteps")


def ngram_propose(buf, end, valid_start, *, k: int, m: int, pad_token_id: int):
    """Prompt-lookup drafting. buf: [B, S] per-row token buffer (left-padded
    prompt at [valid_start, Tp), generated tokens at [Tp, end), pads
    elsewhere); end / valid_start: [B]. Proposes the k tokens that followed
    the MOST RECENT earlier occurrence of the row's last m tokens; rows with
    no match get `pad_token_id` drafts. Returns (drafts [B, k], has_match
    [B] bool)."""
    B, S = buf.shape
    dev = buf.device
    ctx_pos = (end[:, None] - m + torch.arange(m, device=dev)[None, :]).clamp(0, S - 1)
    ctx = torch.gather(buf, 1, ctx_pos)                      # [B, m]
    # match[b, j]: the window ENDING at j equals ctx (buf shifted right by
    # d, zero-filled; the zero-filled j fail the range check)
    match = torch.ones((B, S), dtype=torch.bool, device=dev)
    for d in range(m):
        shifted = torch.cat([buf.new_zeros(B, d), buf[:, :S - d]], 1) if d else buf
        match &= shifted == ctx[:, m - 1 - d][:, None]
    j = torch.arange(S, device=dev)[None, :]
    in_range = (j - (m - 1) >= valid_start[:, None]) & (j <= end[:, None] - 2)
    j_star = torch.where(match & in_range, j, -1).max(dim=1).values
    has = j_star >= 0
    d_pos = (j_star[:, None] + 1 + torch.arange(k, device=dev)[None, :]).clamp(0, S - 1)
    drafts = torch.where(has[:, None], torch.gather(buf, 1, d_pos), pad_token_id)
    return drafts, has


def accept_candidates(logits, drafts, generator, *, temperature, top_p, top_k,
                      greedy, approx_top_k):
    """The exact acceptance rule over verify logits [B, k+1, V] (logits[:, i]:
    the next-token distribution after candidates 0..i) and drafts [B, k].
    Returns (emitted [B, k+1], acc [B]): emitted[:, :acc] are the accepted
    drafts, emitted[:, acc] the model's own token at the first mismatch (a
    bonus token when all k drafts survive).

    Greedy: accept while d_i equals the argmax chain. Sampled: accept d_i
    with probability p̃_i(d_i) under the filtered distribution; on
    rejection sample p̃_i with d_i removed, renormalized — the marginal at
    every position is exactly p̃_i. Draws: u [B, k], then one residual
    categorical per position, both from `generator`."""
    B, K1, V = logits.shape
    k = K1 - 1
    if greedy:
        t_hat = torch.argmax(logits, dim=-1)                 # [B, k+1]
        ok = drafts == t_hat[:, :k]
        acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        final = torch.gather(t_hat, 1, acc[:, None])[:, 0]
    else:
        filtered = filtered_logits_full(logits, temperature, top_p, top_k,
                                        approx_top_k)        # [B, k+1, V]
        logp = torch.log_softmax(filtered, dim=-1)
        p_draft = torch.exp(torch.gather(logp[:, :k], 2, drafts[..., None])[..., 0])
        u = torch.rand((B, k), generator=generator, device=logits.device)
        ok = u < p_draft
        acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        # residual / bonus draws for EVERY position, selected at `acc`:
        # positions i < k sample p̃ with the draft removed (the drafter is a
        # point mass), position k samples p̃ itself
        masked = filtered.clone()
        masked[:, :k].scatter_(2, drafts[..., None], -float("inf"))
        res = _categorical(generator, masked)                # [B, k+1]
        final = torch.gather(res, 1, acc[:, None])[:, 0]
    lane = torch.arange(K1, device=logits.device)[None, :]
    drafts_ext = torch.cat([drafts, drafts.new_zeros(B, 1)], dim=1)
    emitted = torch.where(lane < acc[:, None], drafts_ext,
                          torch.where(lane == acc[:, None], final[:, None], 0))
    return emitted, acc


def _draft_fn(prompt_rep, state, *, Tp, spec_k, spec_ngram, pad_token_id,
              seed_rep=None, seed_len=None):
    """Draft step over the state: the prompt+output buffer of every row and
    its spec_k proposals [B, spec_k].

    `seed_rep` ([B, W], right-aligned) / `seed_len` ([B]), when given,
    prepend a per-row SEED window to the lookup buffer — the radix-matched
    cached continuation the decode session installs at admission
    (`sampler/paged/session.py`), so prefix-heavy traffic drafts from the
    first generated token. Rows with `seed_len == 0` keep exactly the
    unseeded valid range (shifted by the constant W, which the match
    positions are relative to, so their proposals are unchanged). Greedy
    output is draft-independent either way."""
    n_gen, prompt_len = state["n_gen"], state["prompt_len"]
    if seed_rep is None:
        buf = torch.cat([prompt_rep, state["out"]], dim=1)
        drafts, _ = ngram_propose(buf, Tp + n_gen, Tp - prompt_len,
                                  k=spec_k, m=spec_ngram, pad_token_id=pad_token_id)
        return drafts
    W = seed_rep.shape[1]
    buf = torch.cat([seed_rep, prompt_rep, state["out"]], dim=1)
    valid_start = torch.where(seed_len > 0, W - seed_len, W + Tp - prompt_len)
    drafts, _ = ngram_propose(buf, W + Tp + n_gen, valid_start,
                              k=spec_k, m=spec_ngram, pad_token_id=pad_token_id)
    return drafts


def _verify_fn(params, config, state, drafts, *, Tp, max_tokens, eos_token_id,
               spec_k, temperature, top_p, greedy, lora_scale, top_k,
               capture_logprobs, approx_top_k, generator, page_table=None,
               page_size=0, active=None):
    """Verify + accept + per-row bookkeeping, in place on `state` and with
    no host read: one forward over the k+1 candidates (through
    `page_table` when `page_size` > 0), the acceptance rule, the
    multi-token output writes, the per-row cache-length / key_mask
    advance, EOS / budget termination and the acceptance counters.

    `active` (0-d bool on the device) predicates the iteration; None is
    the monolithic loop's condition, `spec_active`. An inactive iteration
    emits nothing and advances no flag or counter; its candidate K/V land
    in slots no mask marks valid."""
    if active is None:
        active = spec_active(state, max_tokens)
    out, key_mask, done = state["out"], state["key_mask"], state["done"]
    cur_tok, n_gen, prompt_len = state["cur_tok"], state["n_gen"], state["prompt_len"]
    B = cur_tok.shape[0]
    K1 = spec_k + 1
    dev = cur_tok.device
    lane = torch.arange(K1, device=dev)[None, :]

    tokens = torch.cat([cur_tok[:, None], drafts], dim=1)
    positions = (prompt_len + n_gen - 1)[:, None] + lane
    fill = Tp + n_gen - 1                                    # [B] slot of cur_tok
    paged = dict(page_table=page_table, page_size=page_size) if page_size > 0 else {}
    logits, _ = decode_verify(params, config, tokens, positions, fill, key_mask,
                              state["caches"], lora_scale=lora_scale, **paged)
    emitted, acc = accept_candidates(
        logits, drafts, generator, temperature=temperature, top_p=top_p,
        top_k=top_k, greedy=greedy, approx_top_k=approx_top_k)

    # emission length: acc drafts + 1 model token, cut after the first EOS
    # of the accepted block and at the response budget; 0 for done rows
    n_emit = acc + 1
    is_eos = (emitted == eos_token_id) & (lane < n_emit[:, None])
    n_emit = torch.where(is_eos.any(dim=1), torch.argmax(is_eos.int(), dim=1) + 1, n_emit)
    n_emit = torch.minimum(n_emit, max_tokens - n_gen)
    n_emit = torch.where(done | ~active, torch.zeros_like(n_emit), n_emit)

    # row b writes emitted[b, :n_emit[b]] at out[b, n_gen[b]:]: one column
    # per lane (no two writes of one call hit the same element)
    rows = torch.arange(B, device=dev)
    lp_mat = None
    if capture_logprobs:
        scaled = logits.float() / guard_temperature(temperature)
        lse = torch.logsumexp(scaled, dim=-1)
        lp_mat = torch.gather(scaled, 2, emitted[..., None])[..., 0] - lse
    for i in range(K1):
        col = (n_gen + i).clamp(max=max_tokens - 1)
        write = i < n_emit
        out[rows, col] = torch.where(write, emitted[:, i], out[rows, col])
        if lp_mat is not None:
            state["lp_out"][rows, col] = torch.where(write, lp_mat[:, i],
                                                     state["lp_out"][rows, col])

    # advance: the last emitted token becomes cur_tok; its slot stays
    # outside key_mask (it is (re)written by the next verify)
    last = torch.gather(emitted, 1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
    cur_tok.copy_(torch.where(n_emit > 0, last, cur_tok))
    slot = torch.arange(key_mask.shape[1], device=dev)[None, :]
    key_mask |= (slot >= fill[:, None]) & (slot < (fill + n_emit)[:, None])
    n_gen += n_emit
    eos_emitted = ((emitted == eos_token_id) & (lane < n_emit[:, None])).any(dim=1)
    live = (~done & active).long()
    done.copy_(done | (active & (eos_emitted | (n_gen >= max_tokens))))

    acc_row = live * torch.minimum(acc, (n_emit - 1).clamp(min=0))
    state["n_drafted"] += live.sum() * spec_k
    state["n_accepted"] += acc_row.sum()
    state["n_emitted"] += n_emit.sum()
    state["n_rowsteps"] += live.sum()          # live (row, verify-step) pairs
    state["row_acc"] += acc_row                # per-row accepted drafts
    state["it"] += active


def spec_active(state, max_tokens):
    """The monolithic speculative loop's condition, on the device: JAX's
    `(it <= max_tokens) & ~all(done)` (every live row emits >= 1 token an
    iteration, so max_tokens bounds the trip count)."""
    return (state["it"] <= max_tokens) & ~state["done"].all()


def _spec_state(base: dict) -> dict:
    """Prefill state → speculative state: the step counter becomes per-row
    generated-token counts `n_gen` plus the acceptance counters; `it`
    counts verify iterations (from 1). Every counter is a device tensor."""
    B = base["cur_tok"].shape[0]
    dev = base["cur_tok"].device
    state = {k: base[k] for k in ("out", "lp_out", "caches", "key_mask", "done",
                                  "cur_tok", "prompt_len", "table", "page_size")}
    state["it"] = torch.ones((), dtype=torch.int64, device=dev)
    state["n_gen"] = torch.ones((B,), dtype=torch.int64, device=dev)
    for name in _COUNTERS:
        state[name] = torch.zeros((), dtype=torch.int64, device=dev)
    state["row_acc"] = torch.zeros((B,), dtype=torch.int64, device=dev)
    return state


def spec_stats(state: dict, verify_steps: int) -> dict:
    """The stats dict of a speculative run (tensors stay on the device)."""
    drafted, accepted, emitted, row_steps = (state[n] for n in _COUNTERS)
    return {"verify_steps": verify_steps, "drafted": drafted,
            "accepted": accepted, "emitted": emitted, "row_steps": row_steps,
            "accepted_rows": state["row_acc"]}


@torch.no_grad()
def generate_tokens_spec(params, config, prompt_ids, prompt_mask,
                         generator: torch.Generator, *, max_tokens: int,
                         eos_token_id: int, pad_token_id: int, spec_k: int,
                         spec_ngram: int = 3, temperature: float = 1.0,
                         top_p: float = 0.95, greedy: bool = False,
                         lora_scale: float = 1.0, top_k: int = 64,
                         capture_logprobs: bool = False,
                         approx_top_k: bool = True, prompt_fanout: int = 1,
                         page_size: int = 0, timings: dict | None = None,
                         sync_every: int = SYNC_EVERY,
                         decode_loop: str = "chunked"):
    """The speculative decode loop. Same output contract as
    `generate_tokens` plus the stats dict: (tokens [B*fanout, max_tokens],
    logprobs f32, stats). `verify_steps` is the count of verify forwards
    that ran with a live row (the monolithic loop pays one per token);
    `row_steps` counts live (row, verify-step) pairs, so emitted /
    row_steps is the mean tokens per row per forward. `timings`:
    prefill_s, decode_s (the verify loop, graph capture included),
    decode_steps (= verify_steps), emitted_tokens, graph_capture_s,
    graph_steps_run, graph_replays and graph_pool_bytes,
    device-synchronized."""
    Tp = prompt_ids.shape[1]
    kw = dict(max_tokens=max_tokens, eos_token_id=eos_token_id,
              temperature=temperature, top_p=top_p, greedy=greedy,
              lora_scale=lora_scale, top_k=top_k,
              capture_logprobs=capture_logprobs, approx_top_k=approx_top_k)
    t0 = time.perf_counter()
    base = _prefill_state(params, config, prompt_ids, prompt_mask, generator,
                          pad_token_id=pad_token_id, prompt_fanout=prompt_fanout,
                          cache_extra=spec_k, page_size=page_size, **kw)
    if timings is not None:
        sync_device(prompt_ids.device)
        timings["prefill_s"] = time.perf_counter() - t0
    prompt_rep = (prompt_ids.repeat_interleave(prompt_fanout, dim=0)
                  if prompt_fanout > 1 else prompt_ids)
    state = _spec_state(base)

    def body():
        drafts = _draft_fn(prompt_rep, state, Tp=Tp, spec_k=spec_k,
                           spec_ngram=spec_ngram, pad_token_id=pad_token_id)
        _verify_fn(params, config, state, drafts, Tp=Tp, spec_k=spec_k,
                   generator=generator, page_table=state["table"],
                   page_size=page_size, **kw)

    t0 = time.perf_counter()
    run_loop(body, lambda: bool(spec_active(state, max_tokens)),
             sync_every=sync_every, decode_loop=decode_loop,
             device=prompt_ids.device, generator=generator, what="speculative",
             timings=timings)
    steps = int(state["it"]) - 1
    if timings is not None:
        sync_device(prompt_ids.device)
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_steps"] = steps
        timings["emitted_tokens"] = int(state["n_emitted"])
    return state["out"], state["lp_out"], spec_stats(state, steps)


@torch.no_grad()
def generate_tokens_spec_traced(params, config, prompt_ids, prompt_mask,
                                generator: torch.Generator, tracer, *,
                                max_tokens: int, eos_token_id: int,
                                pad_token_id: int, spec_k: int,
                                spec_ngram: int = 3, temperature: float = 1.0,
                                top_p: float = 0.95, greedy: bool = False,
                                lora_scale: float = 1.0, top_k: int = 64,
                                capture_logprobs: bool = False,
                                approx_top_k: bool = True,
                                prompt_fanout: int = 1, page_size: int = 0,
                                timings: dict | None = None):
    """The speculative loop driven from the host, one draft + verify per
    iteration, each in its own span on the "rollout" track
    (`rollout.draft` / `rollout.verify`, arg `iteration`) and ended by a
    device sync; the loop stops when every row is done (a host read before
    each iteration) or after `max_tokens` iterations, JAX's condition.
    Same contract as `generate_tokens_spec`; `timings` gets prefill_s,
    decode_s, decode_steps and emitted_tokens."""
    Tp = prompt_ids.shape[1]
    dev = prompt_ids.device
    kw = dict(max_tokens=max_tokens, eos_token_id=eos_token_id,
              temperature=temperature, top_p=top_p, greedy=greedy,
              lora_scale=lora_scale, top_k=top_k,
              capture_logprobs=capture_logprobs, approx_top_k=approx_top_k)
    t0 = time.perf_counter()
    base = _prefill_state(params, config, prompt_ids, prompt_mask, generator,
                          pad_token_id=pad_token_id, prompt_fanout=prompt_fanout,
                          cache_extra=spec_k, page_size=page_size, **kw)
    if timings is not None:
        sync_device(dev)
        timings["prefill_s"] = time.perf_counter() - t0
    prompt_rep = (prompt_ids.repeat_interleave(prompt_fanout, dim=0)
                  if prompt_fanout > 1 else prompt_ids)
    state = _spec_state(base)
    t0 = time.perf_counter()
    for it in range(max_tokens):
        if bool(state["done"].all()):
            break
        with tracer.span("rollout.draft", track="rollout", iteration=it):
            drafts = _draft_fn(prompt_rep, state, Tp=Tp, spec_k=spec_k,
                               spec_ngram=spec_ngram, pad_token_id=pad_token_id)
            sync_device(dev)
        with tracer.span("rollout.verify", track="rollout", iteration=it):
            _verify_fn(params, config, state, drafts, Tp=Tp, spec_k=spec_k,
                       generator=generator, page_table=state["table"],
                       page_size=page_size, **kw)
            sync_device(dev)
    steps = int(state["it"]) - 1
    if timings is not None:
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_steps"] = steps
        timings["emitted_tokens"] = int(state["n_emitted"])
    return state["out"], state["lp_out"], spec_stats(state, steps)


def generate_spec(params, config, prompt_ids, prompt_mask,
                  generator: torch.Generator, *, max_tokens: int,
                  eos_token_id: int, pad_token_id: int, spec_k: int,
                  spec_ngram: int = 3, temperature: float = 1.0,
                  top_p: float = 0.95, greedy: bool = False,
                  lora_scale: float = 1.0, top_k: int = 64,
                  capture_logprobs: bool = False, approx_top_k: bool = True,
                  prompt_fanout: int = 1, spec_stats_out: list | None = None,
                  tracer=None, page_size: int = 0,
                  timings: dict | None = None, sync_every: int = SYNC_EVERY,
                  decode_loop: str = "chunked"):
    """`generate`-contract entry of the speculative path: tokens, or
    (tokens, logprobs) with capture; the stats dict goes to
    `spec_stats_out` when given. An enabled `tracer` runs the traced loop
    (`generate_tokens_spec_traced`; `sync_every` and `decode_loop` then do
    not apply)."""
    kw = dict(max_tokens=max_tokens, eos_token_id=eos_token_id,
              pad_token_id=pad_token_id, spec_k=spec_k, spec_ngram=spec_ngram,
              temperature=temperature, top_p=top_p, greedy=greedy,
              lora_scale=lora_scale, top_k=top_k,
              capture_logprobs=capture_logprobs, approx_top_k=approx_top_k,
              prompt_fanout=prompt_fanout, page_size=page_size, timings=timings)
    if tracer is not None and getattr(tracer, "enabled", False):
        out, lp, stats = generate_tokens_spec_traced(
            params, config, prompt_ids, prompt_mask, generator, tracer, **kw)
    else:
        out, lp, stats = generate_tokens_spec(
            params, config, prompt_ids, prompt_mask, generator,
            sync_every=sync_every, decode_loop=decode_loop, **kw)
    if spec_stats_out is not None:
        spec_stats_out.append(stats)
    return (out, lp) if capture_logprobs else out
