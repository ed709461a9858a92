"""Autoregressive sampler — the port of `nanorlhf_tpu/sampler/sampler.py`
(the monolithic loop over the contiguous or the paged cache, and the
dispatch to speculative decode, `sampler/speculative.py`, and to the
continuous-batching scheduler, `sampler/paged/`).

Output contract as in JAX (vllm_generate): `[B*N, max_tokens]` int,
N consecutive samples per prompt, each row the generated tokens including
the terminating EOS, right-padded with `pad_token_id`; `(tokens, logprobs)`
with `capture_logprobs`.

The JAX loop is a jitted `lax.while_loop`; here its body (`_decode_body`)
runs over device state in chunks of `sync_every` iterations with the same
exit (the step bound or every row done) checked on the host between
chunks: CUDA-graph replays on the card, eager chunks on the CPU
(`sampler/graph.py`); `decode_loop="per_step"` checks before every step.
`jax.random` keys become a `torch.Generator`: the per-step
`fold_in(key, step)` draws become consecutive draws from the generator, so
sampled streams match JAX in distribution, not bit for bit (greedy streams
match exactly). `approx_top_k` is exact here (`torch.topk`): the JAX
docstring notes ApproxTopK is exact off-TPU too.

`page_size > 0` runs the same loop over the paged layout (a pool of
exactly rows × blocks-per-row pages with the dense identity table: a pure
re-layout of the contiguous cache, bit-identical to it on the CPU); with
`0 < decode_rows < rows` as well, `generate` hands the queue to the
continuous-batching scheduler (`sampler/paged/scheduler.py`). `spec_k > 0`
runs speculative decode on either layout and on the queued path, where the
radix prefix cache (`prefix_cache`) and chunked prefill (`prefill_chunk`)
compose with it. The int8 KV cache is the model config's `kv_cache_quant`.
Compaction, not ported yet, raises NotImplementedError instead of being
ignored.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.core.model import (
    decode_step,
    init_kv_cache,
    init_paged_kv_cache,
    prefill,
)
from nanorlhf_tpu_torch.ops.masking import guard_temperature
from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, check_decode_loop, run_loop
from nanorlhf_tpu_torch.sampler.paged.pages import blocks_per_row, full_table


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 0.95
    n: int = 1
    max_tokens: int = 256
    greedy: bool = False
    top_k: int = 64
    capture_logprobs: bool = False
    approx_top_k: bool = True
    compaction_segments: int = 0
    page_size: int = 0
    decode_rows: int = 0
    spec_k: int = 0
    spec_ngram: int = 3
    prefill_chunk: int = 0
    shared_prompt_prefill: bool = True
    # the port's decode loops (`sampler/graph.py`): iterations between host
    # checks, and "chunked" (CUDA-graph replays on the card) or "per_step"
    sync_every: int = SYNC_EVERY
    decode_loop: str = "chunked"


def compose_check(sampling: SamplingParams, *, prefix_cache: bool = False) -> None:
    """THE decode-feature composition gate (JAX's matrix): ValueError on
    every illegal combination, with the reason. The features compose by
    default — spec decode under the radix prefix cache, chunked prefill
    under either, serving's per-row sampling on the same loop. What is
    illegal, and why:

      * compaction_segments > 0 with page_size > 0 — compaction's
        between-segment row gather assumes per-row [T_max] slabs, which
        the paged layout's block table does not have;
      * compaction_segments > 0 with spec_k > 0 — the gather also assumes
        every live row sits at the same decode step;
      * prefix_cache without continuous batching (page_size > 0 AND
        decode_rows > 0) — the radix cache lives at the admission point,
        which the monolithic paths do not have;
      * prefill_chunk > 0 without continuous batching — chunked prefill
        protects resident rows' cadence during a long admission.

    Per-row serving constraints (spec requires static greedy, no logprob
    capture) are the `DecodeSession` constructor's. Then the one knob
    this port has not ported, compacting decode, raises
    NotImplementedError."""
    if sampling.page_size > 0 and sampling.compaction_segments > 0:
        raise ValueError(
            "page_size > 0 is incompatible with compaction_segments > 0: "
            "compaction is the contiguous-layout straggler lever (same-step "
            "row gathers over per-row slabs), and the paged cache replaces "
            "it — set decode_rows > 0 for continuous batching instead")
    if sampling.spec_k > 0 and sampling.compaction_segments > 0:
        raise ValueError(
            "spec_k > 0 is incompatible with compaction_segments > 0: "
            "compacting decode assumes every live row sits at the same "
            "decode step, which speculative decode's per-row accept "
            "lengths break — use the paged cache with decode_rows > 0")
    check_decode_loop(sampling.decode_loop, sampling.sync_every)
    queued_capable = sampling.page_size > 0 and sampling.decode_rows > 0
    if prefix_cache and not queued_capable:
        raise ValueError(
            "prefix_cache requires continuous batching: set page_size > 0 "
            "and decode_rows > 0 (rollout_page_size / rollout_decode_rows "
            "on the trainer) — the monolithic paths have no admission "
            "point to cache across")
    if sampling.prefill_chunk > 0 and not queued_capable:
        raise ValueError(
            "prefill_chunk > 0 requires continuous batching: set "
            "page_size > 0 and decode_rows > 0 — chunked prefill "
            "interleaves a long admission with resident rows' decode "
            "chunks, and the monolithic paths have neither")
    if sampling.compaction_segments > 0:
        raise NotImplementedError(
            "compaction_segments > 0 (compacting decode) is not ported to "
            "nanorlhf_tpu_torch yet: the monolithic sampler (contiguous or "
            "paged), speculative decode and the queued paged scheduler "
            "(radix prefix cache, chunked prefill) are")


def stream_generator(seed: int, stream: int, *index: int,
                     device="cpu") -> torch.Generator:
    """A generator seeded from (seed, stream, *index): the counterpart of
    JAX's `fold_in` chains. Equal arguments give equal draws."""
    state = np.random.SeedSequence([int(seed), int(stream), *map(int, index)])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1)[0]))


def top_p_filter_bisect(logits: torch.Tensor, top_p: float,
                        iters: int = 26) -> torch.Tensor:
    """Nucleus filter by bisection on the probability threshold (no sort):
    keep {i : p_i >= tau}, tau the smallest probability of the minimal
    prefix reaching mass top_p."""
    probs = torch.softmax(logits, dim=-1)
    p_max = probs.max(dim=-1, keepdim=True).values
    lo = torch.zeros_like(p_max)
    hi = p_max * (1 + 1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, torch.zeros_like(probs)).sum(
            dim=-1, keepdim=True)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(probs >= lo, logits, torch.full_like(logits, -float("inf")))


def _nucleus_candidates(logits, top_p, top_k, approx_top_k):
    """(top_logits, top_idx, keep): the top-k candidates (descending) and the
    exclusive-cum nucleus keep rule over their TRUE probabilities. `logits`
    arrive temperature-scaled. `approx_top_k` is exact here."""
    k = min(top_k, logits.shape[-1])
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(top_logits - lse)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    return top_logits, top_idx, keep


def filtered_logits_full(logits, temperature, top_p, top_k, approx_top_k):
    """Full-vocab filtered, temperature-scaled logits whose softmax is
    exactly the distribution `_sample_token` draws from (-inf outside)."""
    scaled = logits.float() / guard_temperature(temperature)
    if top_p >= 1.0:
        return scaled
    if top_k <= 0:
        return top_p_filter_bisect(scaled, top_p)
    lead, V = scaled.shape[:-1], scaled.shape[-1]
    flat = scaled.reshape(-1, V)
    top_logits, top_idx, keep = _nucleus_candidates(flat, top_p, top_k, approx_top_k)
    kept = torch.where(keep, top_logits, torch.full_like(top_logits, -float("inf")))
    full = torch.full_like(flat, -float("inf")).scatter(-1, top_idx, kept)
    return full.reshape(*lead, V)


def sync_device(device: torch.device) -> None:
    """Wait for the device (a no-op on the CPU) — for phase timings."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _categorical(generator, logits):
    """Gumbel-max draw per row (what `jax.random.categorical` does)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_token(generator, logits, temperature, top_p, greedy, top_k=64,
                  approx_top_k=True):
    """One token per row: argmax when greedy; an exact full-vocab categorical
    when top_p >= 1 (bisection nucleus when top_k <= 0); else the top-k
    candidates with the nucleus rule and a k-space categorical."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / guard_temperature(temperature)
    if top_p >= 1.0 or top_k <= 0:
        if top_p < 1.0:
            logits = top_p_filter_bisect(logits, top_p)
        return _categorical(generator, logits)
    top_logits, top_idx, keep = _nucleus_candidates(logits, top_p, top_k, approx_top_k)
    top_logits = torch.where(keep, top_logits, torch.full_like(top_logits, -float("inf")))
    choice = _categorical(generator, top_logits)
    return torch.gather(top_idx, -1, choice[:, None])[:, 0]


def _token_logprob(logits, tok, temperature):
    """Full-distribution logprob of `tok` at the sampling temperature (the
    scoring pass's quantity, through the same temperature guard)."""
    scaled = logits.float() / guard_temperature(temperature)
    lse = torch.logsumexp(scaled, dim=-1)
    return torch.gather(scaled, -1, tok[:, None].long())[:, 0] - lse


def _fan_out_pages(pool, rows: int, nb: int, fanout: int):
    """Fan a stacked pool [L, rows·nb + 1, ...] out ×`fanout` by whole page
    groups: row r of the fanned identity table lands on a copy of row
    r // fanout's pages (page-major, as JAX does), then a fresh scratch
    page."""
    live = pool[:, :rows * nb]
    fanned = live.reshape(pool.shape[0], rows, nb, *pool.shape[2:]).repeat_interleave(
        fanout, dim=1).reshape(pool.shape[0], rows * fanout * nb, *pool.shape[2:])
    return torch.cat([fanned, pool[:, -1:]], dim=1)


def _prefill_state(params, config, prompt_ids, prompt_mask, generator, *,
                   max_tokens, eos_token_id, pad_token_id, temperature, top_p,
                   greedy, lora_scale, top_k, capture_logprobs, approx_top_k,
                   prompt_fanout=1, cache_extra=0, page_size=0):
    """Prefill + first sampled token → the decode-loop state dict. With
    `prompt_fanout` N the [B] prompts are prefilled once and the first
    logits, prompt KV and row metadata fan out ×N (prompt-major).

    `cache_extra` widens the contiguous cache and key_mask past
    Tp + max_tokens: speculative decode's spec_k slack, room for a full
    k + 1 candidate write by a row one token short of its budget. On the
    paged layout it is 0: a candidate write past a row's pages lands on
    the scratch page, and those candidates lie past `max_tokens`, where
    the emission clamp cuts them anyway.

    `page_size` > 0 allocates the paged layout instead of a contiguous
    slab: a pool of exactly rows·ceil(T_max/page_size) pages (plus the
    scratch page) with the dense identity table — a pure re-layout of the
    contiguous cache, no recycling. The state then carries `table`."""
    B, Tp = prompt_ids.shape
    if page_size > 0:
        cache_extra = 0
    T_max = Tp + max_tokens + cache_extra
    prompt_mask = prompt_mask.bool()
    dtype = params["embed_tokens"].dtype
    device = prompt_ids.device
    table = None
    if page_size > 0:
        nb = blocks_per_row(T_max, page_size)
        caches = init_paged_kv_cache(config, B * nb, page_size, dtype, device)
        first_logits, caches = prefill(
            params, config, prompt_ids, prompt_mask, caches,
            lora_scale=lora_scale,
            page_table=torch.as_tensor(full_table(B, nb), device=device),
            page_size=page_size, logical_len=T_max)
    else:
        caches = init_kv_cache(config, B, T_max, dtype, device)
        first_logits, caches = prefill(params, config, prompt_ids, prompt_mask,
                                       caches, lora_scale=lora_scale)
    if prompt_fanout > 1:
        first_logits = first_logits.repeat_interleave(prompt_fanout, dim=0)
        if page_size > 0:
            caches = tuple(_fan_out_pages(c, B, nb, prompt_fanout) for c in caches)
        else:
            caches = tuple(c.repeat_interleave(prompt_fanout, dim=1) for c in caches)
        prompt_mask = prompt_mask.repeat_interleave(prompt_fanout, dim=0)
        B = B * prompt_fanout
    if page_size > 0:
        table = torch.as_tensor(full_table(B, nb), device=device)

    prompt_len = prompt_mask.sum(dim=1).to(torch.int64)
    key_mask = torch.zeros((B, T_max), dtype=torch.bool, device=device)
    key_mask[:, :Tp] = prompt_mask
    out = torch.full((B, max_tokens), pad_token_id, dtype=torch.int64, device=device)
    lp_out = torch.zeros((B, max_tokens), dtype=torch.float32, device=device)
    tok = _sample_token(generator, first_logits, temperature, top_p, greedy,
                        top_k, approx_top_k)
    out[:, 0] = tok
    if capture_logprobs:
        lp_out[:, 0] = _token_logprob(first_logits, tok, temperature)
    step = torch.ones((), dtype=torch.int64, device=device)
    return {"step": step, "out": out, "lp_out": lp_out, "caches": caches,
            "key_mask": key_mask, "done": tok == eos_token_id, "cur_tok": tok,
            "prompt_len": prompt_len, "table": table, "page_size": page_size}


def _set_column(buf, col, where, value) -> None:
    """buf[:, col] = value where `where` (per row), in place; `col` a [1]
    index tensor."""
    old = buf.index_select(1, col)[:, 0]
    buf.index_copy_(1, col, torch.where(where, value, old)[:, None])


def _loop_active(state, max_tokens):
    """The monolithic loop's condition, on the device: JAX's
    `(step < max_tokens) & ~all(done)`."""
    return (state["step"] < max_tokens) & ~state["done"].all()


def _decode_body(params, config, state, *, Tp, max_tokens, eos_token_id,
                 pad_token_id, temperature, top_p, greedy, lora_scale, top_k,
                 capture_logprobs, approx_top_k, generator):
    """One decode iteration over the device state, in place and with no
    host read, predicated on `_loop_active`: an inactive iteration (past
    the bound, or every row done) changes no output, flag, counter or
    valid cache slot (its K/V lands in a slot no mask marks valid)."""
    step, done, key_mask = state["step"], state["done"], state["key_mask"]
    active = _loop_active(state, max_tokens)
    # token `step` was sampled from logits at position prompt_len + step - 1;
    # its KV lands in cache slot Tp + step - 1
    # the slot and column are [1] index tensors: a 0-d tensor index is
    # read back to the host by torch's indexing
    cache_slot = (Tp + step - 1).clamp(max=key_mask.shape[1] - 1).view(1)
    _set_column(key_mask, cache_slot, active, True)
    position = state["prompt_len"] + step - 1
    logits, _ = decode_step(params, config, state["cur_tok"], position,
                            cache_slot, key_mask, state["caches"],
                            lora_scale=lora_scale, page_table=state["table"],
                            page_size=state["page_size"])
    tok = _sample_token(generator, logits, temperature, top_p, greedy, top_k,
                        approx_top_k)
    tok = torch.where(done, torch.full_like(tok, pad_token_id), tok)
    live = ~done & active
    col = step.clamp(max=max_tokens - 1).view(1)
    _set_column(state["out"], col, live, tok)
    if capture_logprobs:
        _set_column(state["lp_out"], col, live,
                    _token_logprob(logits, tok, temperature))
    done.copy_(done | (active & (tok == eos_token_id)))
    state["cur_tok"].copy_(torch.where(active, tok, state["cur_tok"]))
    step.add_(active.to(step.dtype))


@torch.no_grad()
def generate_tokens(params, config: ModelConfig, prompt_ids, prompt_mask,
                    generator: torch.Generator, *, max_tokens: int,
                    eos_token_id: int, pad_token_id: int,
                    temperature: float = 1.0, top_p: float = 0.95,
                    greedy: bool = False, lora_scale: float = 1.0,
                    top_k: int = 64, capture_logprobs: bool = False,
                    approx_top_k: bool = True, prompt_fanout: int = 1,
                    page_size: int = 0, timings: dict | None = None,
                    sync_every: int = SYNC_EVERY, decode_loop: str = "chunked"):
    """Core loop: prefill, then decode until `max_tokens` or every row has
    emitted EOS. Returns [B*fanout, max_tokens] (+ logprobs f32).
    `page_size` > 0 runs it over the paged layout (identity table).
    `sync_every` / `decode_loop`: see `sampler/graph.py`. `timings`, when
    given, receives `prefill_s`, `decode_s` (wall seconds,
    device-synchronized; the graph capture included), `decode_steps`
    (iterations that ran with a live row), `graph_capture_s`,
    `graph_steps_run`, `graph_replays` and `graph_pool_bytes`."""
    Tp = prompt_ids.shape[1]
    kw = dict(max_tokens=max_tokens, eos_token_id=eos_token_id,
              pad_token_id=pad_token_id, temperature=temperature, top_p=top_p,
              greedy=greedy, lora_scale=lora_scale, top_k=top_k,
              capture_logprobs=capture_logprobs, approx_top_k=approx_top_k)
    t0 = time.perf_counter()
    state = _prefill_state(params, config, prompt_ids, prompt_mask, generator,
                           prompt_fanout=prompt_fanout, page_size=page_size, **kw)
    if timings is not None:
        sync_device(prompt_ids.device)
        timings["prefill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_loop(lambda: _decode_body(params, config, state, Tp=Tp,
                                  generator=generator, **kw),
             lambda: bool(_loop_active(state, max_tokens)),
             sync_every=sync_every, decode_loop=decode_loop,
             device=prompt_ids.device, generator=generator, timings=timings)
    if timings is not None:
        sync_device(prompt_ids.device)
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_steps"] = int(state["step"]) - 1
    out = state["out"]
    return (out, state["lp_out"]) if capture_logprobs else out


def generate(params, config: ModelConfig, prompt_ids, prompt_mask,
             generator: torch.Generator, sampling: SamplingParams,
             eos_token_id: int, pad_token_id: int, lora_scale: float = 1.0,
             timings: dict | None = None, paged_stats_out: list | None = None,
             spec_stats_out: list | None = None, tracer=None, latency=None,
             prefix_cache=None):
    """vllm_generate-contract entry: [B*N, max_tokens], N consecutive per
    prompt; (tokens, logprobs) when `sampling.capture_logprobs`. `timings`:
    see `generate_tokens`.

    `sampling.spec_k > 0` runs speculative decode (`sampler/speculative.py`)
    on the monolithic paths, or inside the queued scheduler;
    `spec_stats_out` then receives one stats dict per call (verify_steps,
    drafted, accepted, emitted, row_steps, accepted_rows).

    `page_size > 0 and 0 < decode_rows < B*N` runs the continuous-batching
    scheduler: each prompt repeated N times becomes its own queue entry
    (no shared-prompt fan-out there, as in JAX). `paged_stats_out` (paged
    paths only) receives one stats dict per call: page_utilization,
    pages_recycled, admitted_midloop (+ the scheduler's session counters).
    `decode_rows > 0` with `page_size == 0` is ignored, as in JAX.

    `tracer` (an enabled `telemetry.SpanTracer`) switches the monolithic
    speculative path to its traced loop (per-iteration `rollout.draft` /
    `rollout.verify` spans); `latency` (an enabled `telemetry.LatencyHub`)
    gets the queued path's per-request `latency/ttft_s` and per-chunk
    `latency/intertoken_s` records. The other paths ignore both, as in
    JAX.

    `prefix_cache` (an enabled `serving.RadixCache`): the queued path
    admits rows through the cross-request radix prefix cache (reset per
    call; `sampling.prefill_chunk` chunks long admissions). The non-queued
    paths ignore both, as in JAX."""
    compose_check(sampling, prefix_cache=getattr(prefix_cache, "enabled", False))
    total_rows = prompt_ids.shape[0] * sampling.n
    queued = (sampling.page_size > 0 and sampling.decode_rows > 0
              and sampling.decode_rows < total_rows)
    fanout = 1
    if sampling.n > 1:
        if sampling.shared_prompt_prefill and not queued:
            fanout = sampling.n  # prefill once, fan the prompt KV out
        else:
            prompt_ids = prompt_ids.repeat_interleave(sampling.n, dim=0)
            prompt_mask = prompt_mask.repeat_interleave(sampling.n, dim=0)
    kw = dict(max_tokens=sampling.max_tokens, eos_token_id=eos_token_id,
              pad_token_id=pad_token_id, temperature=sampling.temperature,
              top_p=sampling.top_p, greedy=sampling.greedy,
              lora_scale=lora_scale, top_k=sampling.top_k,
              capture_logprobs=sampling.capture_logprobs,
              approx_top_k=sampling.approx_top_k, timings=timings,
              sync_every=sampling.sync_every, decode_loop=sampling.decode_loop)
    if queued:
        from nanorlhf_tpu_torch.sampler.paged.scheduler import generate_tokens_queued

        return generate_tokens_queued(
            params, config, prompt_ids, prompt_mask, generator,
            page_size=sampling.page_size, decode_rows=sampling.decode_rows,
            spec_k=sampling.spec_k, spec_ngram=sampling.spec_ngram,
            paged_stats_out=paged_stats_out, spec_stats_out=spec_stats_out,
            latency=latency, prefix_cache=prefix_cache,
            prefill_chunk=sampling.prefill_chunk, **kw)
    if sampling.spec_k > 0:
        from nanorlhf_tpu_torch.sampler.speculative import generate_spec

        result = generate_spec(
            params, config, prompt_ids, prompt_mask, generator,
            spec_k=sampling.spec_k, spec_ngram=sampling.spec_ngram,
            prompt_fanout=fanout, page_size=sampling.page_size,
            spec_stats_out=spec_stats_out, tracer=tracer, **kw)
        _monolithic_paged_stats(result, sampling, prompt_mask, fanout,
                                pad_token_id, paged_stats_out)
        return result
    result = generate_tokens(params, config, prompt_ids, prompt_mask, generator,
                             prompt_fanout=fanout, page_size=sampling.page_size,
                             **kw)
    _monolithic_paged_stats(result, sampling, prompt_mask, fanout,
                            pad_token_id, paged_stats_out)
    return result


def _monolithic_paged_stats(result, sampling, prompt_mask, fanout,
                            pad_token_id, paged_stats_out):
    """`paged_stats_out` of the monolithic paged path: no recycling, no
    admissions — utilization is the final cache occupancy over the fully
    provisioned pool."""
    if paged_stats_out is None or sampling.page_size <= 0:
        return
    toks = result[0] if sampling.capture_logprobs else result
    rows, Tp = toks.shape[0], prompt_mask.shape[1]
    P = sampling.page_size
    nb = blocks_per_row(Tp + sampling.max_tokens, P)
    used = float(prompt_mask.sum()) * fanout + float((toks != pad_token_id).sum())
    paged_stats_out.append({
        "page_utilization": used / (rows * nb * P),
        "pages_recycled": 0,
        "admitted_midloop": 0,
        "decode_iterations": None,
        "rows": rows,
        "num_pages": rows * nb,
        "page_size": P,
        "admissions": [],
    })
