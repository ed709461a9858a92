"""Continuous batching over the paged KV cache — the port of
`nanorlhf_tpu/sampler/paged/scheduler.py` (`generate_tokens_queued`, with
speculative decode, the radix prefix cache, chunked prefill and in-flight
weight swaps).

`decode_rows` rows are resident in a `DecodeSession` over a pool sized for
exactly those rows. The session runs in chunks of `sync_every` iterations
(CUDA-graph replays on the card, `sampler/graph.py`);
at each host sync, rows that emitted EOS (or reached `max_tokens`) are
flushed to the output in queue order, their pages go back to the free
stack, and the next queued prompts are admitted into the freed rows
mid-loop. The batch and pool shapes never change. With `spec_k > 0` each
iteration is a draft + verify (`sampler/speculative.py`) through the live
table, and the accepted drafts of each row are collected per queue index.
With `prefix_cache` (an enabled `serving.RadixCache`) every row, the first
`decode_rows` included, is admitted through the tree, which resets at each
call (cached K/V belongs to the weights that wrote it); with spec decode
a finished row's text extends the tree for later drafters. With
`prefill_chunk > 0` long admissions prefill one chunk per host sync
(`session.py`); a row whose chunks are pending is not finished.

Greedy queued rows equal the monolithic greedy rows (the carry is exact
and a row's computation does not depend on its neighbours); sampled rows
match in distribution only — see `session.py` for the PRNG streams.

In-flight weight swaps (`weight_refresh`, JAX scheduler.py:226-355): the
callback is polled once before the loop (a returned tree is the base
install, not counted) and once per host sync; a newer tree is installed
into the session's tensors IN PLACE (`DecodeSession.install_params`) before
the next chunk, and every live row gets a segment boundary at its current
generated length. Install copies each leaf of the fresh tree that is not
the live tree's own tensor, so the tree `generate` is given must own the
leaves a swap replaces (the trainer hands it private copies of the
trainable leaves).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
from nanorlhf_tpu_torch.sampler.sampler import sync_device
from nanorlhf_tpu_torch.sampler.speculative import spec_stats


def _finalize_segments(bounds: list, total: int) -> list:
    """Close one request's `{policy_version, tok_range}` list (JAX's):
    `bounds` is the chronological [(version, start_tok), ...] recorded at
    admission and at each swap; each segment ends where the next begins,
    the last at `total` generated tokens. Empty spans are dropped, so the
    survivors tile [0, total) with strictly increasing versions."""
    segs = [
        {"policy_version": bounds[i][0],
         "tok_range": [bounds[i][1],
                       bounds[i + 1][1] if i + 1 < len(bounds) else total]}
        for i in range(len(bounds))
        if (bounds[i + 1][1] if i + 1 < len(bounds) else total) > bounds[i][1]
    ]
    if not segs:
        segs = [{"policy_version": bounds[-1][0] if bounds else None,
                 "tok_range": [0, total]}]
    return segs


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
                           timings: dict | None = None, latency=None,
                           prefix_cache=None, prefill_chunk: int = 0,
                           weight_refresh=None):
    """The `generate_tokens` contract over the whole queue ([Q, Tp]
    left-padded prompts → [Q, max_tokens] in queue order, or (tokens,
    logprobs)), with only `decode_rows` rows resident at a time.

    `paged_stats_out` receives one dict: page_utilization (mean pool
    occupancy after each sync), pages_recycled, admitted_midloop,
    decode_iterations, rows, num_pages, page_size, admissions (row, queue
    index, iteration of each mid-loop admission), prefill_token_dispatch,
    dispatch_events, chunked_admissions and prefill_backlog_peak (the
    chunked prefill's), and the session's end-of-call `status()`; under the
    radix cache also prefix_hit_tokens, prefix_hit_frac, cow_splits,
    evicted_pages and shared_pages (the peak), as in JAX.
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
    (`DecodeSession`).

    `weight_refresh` (`() -> (version, tree|None)`,
    `orchestrator.weight_store.make_swap_refresh`): in-flight weight swaps
    (module docstring). The paged-stats entry then also carries `segments`
    (queue-order per-request `{policy_version, tok_range}` lists tiling
    `[0, n_generated)` with strictly increasing versions), `swap_installs`
    and `swap_wait_s`. With no mid-rollout publish every poll returns no
    tree and the token stream equals `weight_refresh=None`'s."""
    Q, Tp = prompt_ids.shape
    R = min(int(decode_rows), Q)
    device = prompt_ids.device
    radix = prefix_cache if getattr(prefix_cache, "enabled", False) else None
    sess = DecodeSession(
        params, config, rows=R, prompt_len=Tp, max_tokens=max_tokens,
        page_size=page_size, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id, generator=generator,
        temperature=temperature, top_p=top_p, greedy=greedy, top_k=top_k,
        approx_top_k=approx_top_k, capture_logprobs=capture_logprobs,
        lora_scale=lora_scale, spec_k=spec_k, spec_ngram=spec_ngram,
        prefix_cache=radix, prefill_chunk=int(prefill_chunk),
        sync_every=sync_every, decode_loop=decode_loop, latency=latency)
    stats0 = dict(radix.stats) if radix is not None else None
    prompt_np = prompt_ids.cpu().numpy()
    pmask_np = prompt_mask.bool().cpu().numpy()

    out_all = np.full((Q, max_tokens), pad_token_id, np.int64)
    lp_all = np.zeros((Q, max_tokens), np.float32)
    acc_all = np.zeros((Q,), np.int64)   # spec: accepted drafts per queue index
    t_prefill = t_decode = 0.0
    admissions: list[dict] = []
    util_samples: list[float] = []
    shared_peak = 0
    recycled = 0
    # in-flight weight swaps: per-queue-index (version, start_tok) bounds
    swaps = weight_refresh is not None
    cur_version = None
    swap_installs = 0
    swap_wait_s = 0.0
    seg_bounds: dict[int, list] = {}
    seg_final: dict[int, list] = {}
    if swaps:
        t0 = time.perf_counter()
        cur_version, fresh = weight_refresh()
        if fresh is not None:
            # base install: a publish raced the dispatch — the whole stream
            # starts on the newer tree (one segment, the newer version)
            sess.install_params(fresh)
            swap_wait_s += time.perf_counter() - t0

    t0 = time.perf_counter()
    if radix is not None:
        # the first rows admit one by one through the tree, as mid-loop
        # admissions do
        for r in range(R):
            sess.admit(r, prompt_np[r], pmask_np[r], r)
    else:
        sess.bootstrap(prompt_ids, prompt_mask)
    sync_device(device)
    t_prefill += time.perf_counter() - t0
    owner = list(range(R))   # resident row → queue index (-1: empty)
    next_q = R
    if swaps:
        for q in range(R):
            seg_bounds[q] = [(cur_version, 0)]

    while True:
        t0 = time.perf_counter()
        done_h = sess.step()   # ends in a host read of the done flags
        t_decode += time.perf_counter() - t0
        it_now = sess.iterations()
        if sess.installed is not None:
            admissions.append({"row": sess.installed[0],
                               "queue_index": owner[sess.installed[0]],
                               "iteration": it_now, "chunked": True})
        pending = sess.pending_rows()
        finished = [r for r in range(R)
                    if done_h[r] and owner[r] >= 0 and r not in pending]
        if finished:
            out_h = sess.state["out"].cpu().numpy()
            lp_h = sess.state["lp_out"].cpu().numpy() if capture_logprobs else None
            acc_h = sess.state["row_acc"].cpu().numpy() if spec_k else None
            n_gen_h = (sess.state["n_gen"].cpu().numpy()
                       if spec_k or swaps else None)
        t0 = time.perf_counter()
        for r in finished:
            q = owner[r]
            out_all[q] = out_h[r]
            if capture_logprobs:
                lp_all[q] = lp_h[r]
            gen = None
            if spec_k:
                acc_all[q] = acc_h[r]
                gen = out_h[r][:int(n_gen_h[r])]
            if swaps:
                seg_final[q] = _finalize_segments(seg_bounds.pop(q), int(n_gen_h[r]))
            owner[r] = -1
            # radix: drop the request's refs; the tree's survive as cached
            # prefix K/V (and, with spec, the text extends the tree)
            recycled += sess.release(r, gen_tokens=gen)
        for r in finished:
            if next_q >= Q:
                continue
            sess.admit(r, prompt_np[next_q], pmask_np[next_q], next_q)
            owner[r] = next_q
            if swaps:
                seg_bounds[next_q] = [(cur_version, 0)]
            if not sess.is_pending(r):
                admissions.append({"row": r, "queue_index": next_q,
                                   "iteration": it_now})
            next_q += 1
        if finished:
            sync_device(device)
            t_prefill += time.perf_counter() - t0
        if swaps:
            # the host sync point: one poll a chunk; a newer tree is
            # installed before the next chunk, and every live row's segment
            # list gets a boundary at its current generated length (rows
            # admitted at this sync read 0: an empty segment, dropped)
            t0 = time.perf_counter()
            version, fresh = weight_refresh()
            if fresh is not None:
                n_gen_now = sess.state["n_gen"].cpu().numpy()
                for r in range(R):
                    if owner[r] >= 0:
                        seg_bounds[owner[r]].append((version, int(n_gen_now[r])))
                sess.install_params(fresh)
                cur_version = version
                swap_installs += 1
                swap_wait_s += time.perf_counter() - t0
        # pool occupancy AFTER this sync's churn: allocated / total pages
        util_samples.append(sess.utilization())
        shared_peak = max(shared_peak, sess.shared_pages())
        if next_q >= Q and all(o < 0 for o in owner) and not sess.has_pending():
            break

    n_iter = sess.iterations()
    if timings is not None:
        timings.update(prefill_s=t_prefill, decode_s=t_decode,
                       decode_steps=n_iter, admissions=len(admissions),
                       **sess.loop_stats())
    if paged_stats_out is not None:
        entry = {
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
            "chunked_admissions": sess.chunked_admissions,
            "prefill_backlog_peak": sess.backlog_peak,
            "session": sess.status(),
        }
        if swaps:
            entry.update({
                "segments": [seg_final[q] for q in range(Q)],
                "swap_installs": swap_installs,
                "swap_wait_s": swap_wait_s,
            })
        if radix is not None:
            lookup_tok = radix.stats["lookup_tokens"] - stats0["lookup_tokens"]
            entry.update({
                "prefix_hit_tokens": sess.hit_tokens,
                "prefix_hit_frac": (sess.hit_tokens / lookup_tok if lookup_tok else 0.0),
                "cow_splits": radix.stats["cow_splits"] - stats0["cow_splits"],
                "evicted_pages": radix.stats["evicted_pages"] - stats0["evicted_pages"],
                "shared_pages": shared_peak,
            })
        paged_stats_out.append(entry)
    if spec_k and spec_stats_out is not None:
        spec_stats_out.append({
            **spec_stats(sess.state, n_iter),
            "accepted_rows": torch.as_tensor(acc_all, device=device)})
    toks = torch.as_tensor(out_all, device=device)
    if capture_logprobs:
        return toks, torch.as_tensor(lp_all, device=device)
    return toks
