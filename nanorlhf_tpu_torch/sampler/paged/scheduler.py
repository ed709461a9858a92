"""Continuous batching over the paged KV cache — the port of
`nanorlhf_tpu/sampler/paged/scheduler.py` (`generate_tokens_queued`, with
speculative decode; without the radix prefix cache, chunked prefill or
in-flight weight swaps).

`decode_rows` rows are resident in a `DecodeSession` over a pool sized for
exactly those rows. The session runs in chunks of `sync_every` iterations
(CUDA-graph replays on the card, `sampler/graph.py`);
at each host sync, rows that emitted EOS (or reached `max_tokens`) are
flushed to the output in queue order, their pages go back to the free
stack, and the next queued prompts are admitted into the freed rows
mid-loop. The batch and pool shapes never change. With `spec_k > 0` each
iteration is a draft + verify (`sampler/speculative.py`) through the live
table, and the accepted drafts of each row are collected per queue index.

Greedy queued rows equal the monolithic greedy rows (the carry is exact
and a row's computation does not depend on its neighbours); sampled rows
match in distribution only — see `session.py` for the PRNG streams.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
from nanorlhf_tpu_torch.sampler.sampler import sync_device
from nanorlhf_tpu_torch.sampler.speculative import spec_stats


@torch.no_grad()
def generate_tokens_queued(params, config, prompt_ids, prompt_mask,
                           generator: torch.Generator, *, max_tokens: int,
                           eos_token_id: int, pad_token_id: int,
                           page_size: int, decode_rows: int,
                           spec_k: int = 0, spec_ngram: int = 3,
                           temperature: float = 1.0, top_p: float = 0.95,
                           greedy: bool = False, lora_scale: float = 1.0,
                           top_k: int = 64, capture_logprobs: bool = False,
                           approx_top_k: bool = True, sync_every: int = SYNC_EVERY,
                           decode_loop: str = "chunked",
                           paged_stats_out: list | None = None,
                           spec_stats_out: list | None = None,
                           timings: dict | None = None, latency=None):
    """The `generate_tokens` contract over the whole queue ([Q, Tp]
    left-padded prompts → [Q, max_tokens] in queue order, or (tokens,
    logprobs)), with only `decode_rows` rows resident at a time.

    `paged_stats_out` receives one dict: page_utilization (mean pool
    occupancy after each sync), pages_recycled, admitted_midloop,
    decode_iterations, rows, num_pages, page_size, admissions (row, queue
    index, iteration of each mid-loop admission), prefill_token_dispatch,
    dispatch_events, chunked_admissions and prefill_backlog_peak (0: no
    chunked prefill), and the session's end-of-call `status()`.
    `spec_stats_out` (spec_k > 0) receives the speculative stats dict:
    verify_steps (the decode iterations), drafted, accepted, emitted,
    row_steps, and accepted_rows [Q] in queue order.

    `timings`, when given, receives `prefill_s` (the batched bootstrap and
    every admission prefill), `decode_s` (the decode chunks, each ending in
    the host sync that reads the done flags, and the graph capture),
    `decode_steps` (decode iterations that ran with a live row),
    `admissions`, and the session loop's `graph_capture_s`,
    `graph_steps_run`, `graph_replays` and `graph_pool_bytes` — wall seconds,
    device-synchronized.

    `latency` (an enabled `telemetry.LatencyHub`): the session records one
    `latency/ttft_s` per request and one `latency/intertoken_s` per chunk
    (`DecodeSession`)."""
    Q, Tp = prompt_ids.shape
    R = min(int(decode_rows), Q)
    device = prompt_ids.device
    sess = DecodeSession(
        params, config, rows=R, prompt_len=Tp, max_tokens=max_tokens,
        page_size=page_size, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id, generator=generator,
        temperature=temperature, top_p=top_p, greedy=greedy, top_k=top_k,
        approx_top_k=approx_top_k, capture_logprobs=capture_logprobs,
        lora_scale=lora_scale, spec_k=spec_k, spec_ngram=spec_ngram,
        sync_every=sync_every, decode_loop=decode_loop, latency=latency)
    prompt_np = prompt_ids.cpu().numpy()
    pmask_np = prompt_mask.bool().cpu().numpy()

    out_all = np.full((Q, max_tokens), pad_token_id, np.int64)
    lp_all = np.zeros((Q, max_tokens), np.float32)
    acc_all = np.zeros((Q,), np.int64)   # spec: accepted drafts per queue index
    t_prefill = t_decode = 0.0
    t0 = time.perf_counter()
    sess.bootstrap(prompt_ids, prompt_mask)
    sync_device(device)
    t_prefill += time.perf_counter() - t0
    owner = list(range(R))   # resident row → queue index (-1: empty)
    next_q = R
    recycled = 0
    admissions: list[dict] = []
    util_samples: list[float] = []

    while True:
        t0 = time.perf_counter()
        done_h = sess.step()   # ends in a host read of the done flags
        t_decode += time.perf_counter() - t0
        it_now = sess.iterations()
        finished = [r for r in range(R) if done_h[r] and owner[r] >= 0]
        if finished:
            out_h = sess.state["out"].cpu().numpy()
            lp_h = sess.state["lp_out"].cpu().numpy() if capture_logprobs else None
            acc_h = sess.state["row_acc"].cpu().numpy() if spec_k else None
        t0 = time.perf_counter()
        for r in finished:
            q = owner[r]
            out_all[q] = out_h[r]
            if capture_logprobs:
                lp_all[q] = lp_h[r]
            if spec_k:
                acc_all[q] = acc_h[r]
            owner[r] = -1
            recycled += sess.release(r)
        for r in finished:
            if next_q >= Q:
                continue
            sess.admit(r, prompt_np[next_q], pmask_np[next_q], next_q)
            owner[r] = next_q
            admissions.append({"row": r, "queue_index": next_q,
                               "iteration": it_now})
            next_q += 1
        if finished:
            sync_device(device)
            t_prefill += time.perf_counter() - t0
        # pool occupancy AFTER this sync's churn: allocated / total pages
        util_samples.append(sess.utilization())
        if next_q >= Q and all(o < 0 for o in owner):
            break

    n_iter = sess.iterations()
    if timings is not None:
        timings.update(prefill_s=t_prefill, decode_s=t_decode,
                       decode_steps=n_iter, admissions=len(admissions),
                       **sess.loop_stats())
    if paged_stats_out is not None:
        paged_stats_out.append({
            "page_utilization": float(np.mean(util_samples)),
            "pages_recycled": recycled,
            "admitted_midloop": len(admissions),
            "decode_iterations": n_iter,
            "rows": R,
            "num_pages": sess.num_pages,
            "page_size": int(page_size),
            "admissions": admissions,
            "prefill_token_dispatch": sess.dispatch_tokens,
            "dispatch_events": sess.dispatch_events(),
            "chunked_admissions": 0,      # no chunked prefill in the port
            "prefill_backlog_peak": 0,
            "session": sess.status(),
        })
    if spec_k and spec_stats_out is not None:
        spec_stats_out.append({
            **spec_stats(sess.state, n_iter),
            "accepted_rows": torch.as_tensor(acc_all, device=device)})
    toks = torch.as_tensor(out_all, device=device)
    if capture_logprobs:
        return toks, torch.as_tensor(lp_all, device=device)
    return toks
