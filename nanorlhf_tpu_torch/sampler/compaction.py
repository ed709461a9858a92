"""Compacting decode over the contiguous cache — the port of
`nanorlhf_tpu/sampler/compaction.py`.

The monolithic loop (`sampler.generate_tokens`) decodes until EVERY row has
emitted EOS, so one straggler holds the whole batch. This loop decodes in
SEGMENTS of `ceil(max_tokens / segments)` steps; after each, the finished
rows are flushed to the output through `owner` (the original row each
physical row writes to), and when the live rows fit a power-of-two menu
batch of half the current one or less (at least `_MIN_BATCH`), they are
GATHERED with their KV caches (`_gather_rows`: every row sits at the same
step, so the slot layout is untouched) and decoding goes on at the smaller
batch. Menu padding repeats the first live row with owner −1, marked done,
and never flushes.

Each segment runs `sampler._decode_body` in the port's chunked loop
(`sampler/graph.py`), bounded by a device scalar `limit` (the segment's
end) that the body's predicate reads: on the card the first chunk at a
batch size runs eagerly and later chunks replay one captured CUDA graph,
kept for the next segment while the batch (and so every state tensor) is
the same; a gather makes new tensors and a new capture. So a generate
captures once per menu size it decodes at (the capture cost is in
`timings["graph_capture_s"]`). On the CPU every chunk is eager.

The random stream follows the port's rule: the draws come from the one
explicit generator, batch-shaped, so after a compaction the streams differ
from the monolithic loop's — same distribution, not the same bits. Greedy
output is the monolithic loop's exactly on the CPU.

`batch_sharding` (JAX's mesh-aware carry, `_shard_state` /
`_batch_axis_size`) takes the port's mesh: the carry is per rank — each
batch rank compacts its own `parallel.mesh.batch_sharding` block of the
prompts (so the batch-axis term of JAX's smallest menu size is 1 on each
rank, which leaves `_MIN_BATCH`), and the rows are all-gathered at the end,
so the result is the whole batch's, as in JAX. A greedy block is the
one-rank run's rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.parallel.mesh import batch_sharding
from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, ChunkedLoop, check_decode_loop
from nanorlhf_tpu_torch.sampler.sampler import (
    _decode_body,
    _loop_active,
    _prefill_state,
    sync_device,
)

_MIN_BATCH = 8


def segment_length(max_tokens: int, segments: int) -> int:
    """Decode steps a segment: ceil(max_tokens / segments)."""
    return max(1, -(-max_tokens // max(segments, 1)))


def compacted_size(live: int, size: int) -> int | None:
    """The menu batch that `live` rows move to from a batch of `size`: the
    power of two that holds them (at least `_MIN_BATCH`) when it is half of
    `size` or less, else None (no compaction)."""
    target = max(_MIN_BATCH, 1 << (live - 1).bit_length())
    return target if target <= size // 2 else None


def predicted_menu(ends, max_tokens: int, segments: int) -> list[int]:
    """The batch sizes the loop decodes at when row r's EOS is its token at
    column `ends[r]` (None: it never emits one): the first size is the
    batch, each later one follows a compaction. Exact for greedy rows; for
    sampled rows exact up to the first compaction (until then the batch,
    and so every draw, is the monolithic loop's)."""
    seg = segment_length(max_tokens, segments)
    menu, step = [len(ends)], 1
    while step < max_tokens:
        step = min(step + seg, max_tokens)
        live = sum(1 for e in ends if e is None or e >= step)
        if live == 0 or step >= max_tokens:
            break
        size = compacted_size(live, menu[-1])
        if size is not None:
            menu.append(size)
    return menu


def _gather_rows(state: dict, idx: torch.Tensor) -> dict:
    """Row-gather the whole decode state (caches carry batch on axis 1)."""
    take = lambda x: x.index_select(0, idx)  # noqa: E731
    out = dict(state)
    out["caches"] = tuple(c.index_select(1, idx) for c in state["caches"])
    for key in ("out", "lp_out", "key_mask", "done", "cur_tok", "prompt_len"):
        out[key] = take(state[key])
    return out


@torch.no_grad()
def generate_tokens_compact(params, config, prompt_ids, prompt_mask,
                            generator: torch.Generator, *, max_tokens: int,
                            eos_token_id: int, pad_token_id: int, segments: int,
                            temperature: float = 1.0, top_p: float = 0.95,
                            greedy: bool = False, lora_scale: float = 1.0,
                            top_k: int = 64, capture_logprobs: bool = False,
                            approx_top_k: bool = True, batch_sharding=None,
                            prompt_fanout: int = 1, timings: dict | None = None,
                            sync_every: int = SYNC_EVERY, decode_loop: str = "chunked",
                            stats_out: list | None = None):
    """Segmented decode with batch compaction: `generate_tokens`'s output
    contract ([B·fanout, max_tokens], + f32 logprobs with capture), one
    host sync per segment. `timings` as `generate_tokens` (the graph
    counters summed over the menu sizes). `stats_out` receives one dict:
    `menu`, one (batch, steps, kernel launches) entry per batch size in
    the order decoded, and `compactions`. `batch_sharding` (a
    `parallel.mesh.Mesh`): this rank compacts its block of the prompts and
    the blocks are gathered (module docstring)."""
    if batch_sharding is not None and batch_sharding.batch > 1:
        return _compact_block(
            params, config, prompt_ids, prompt_mask, generator, batch_sharding,
            max_tokens=max_tokens, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            segments=segments, temperature=temperature, top_p=top_p, greedy=greedy,
            lora_scale=lora_scale, top_k=top_k, capture_logprobs=capture_logprobs,
            approx_top_k=approx_top_k, prompt_fanout=prompt_fanout, timings=timings,
            sync_every=sync_every, decode_loop=decode_loop, stats_out=stats_out)
    check_decode_loop(decode_loop, sync_every)
    device = prompt_ids.device
    B0, Tp = prompt_ids.shape
    B0 *= prompt_fanout
    kw = dict(max_tokens=max_tokens, eos_token_id=eos_token_id,
              pad_token_id=pad_token_id, temperature=temperature, top_p=top_p,
              greedy=greedy, lora_scale=lora_scale, top_k=top_k,
              capture_logprobs=capture_logprobs, approx_top_k=approx_top_k)
    t0 = time.perf_counter()
    state = _prefill_state(params, config, prompt_ids, prompt_mask, generator,
                           prompt_fanout=prompt_fanout, **kw)
    # the segment's end: a device scalar the loop's predicate reads, so a
    # captured chunk stays valid from one segment to the next
    state["limit"] = torch.ones((), dtype=torch.int64, device=device)
    if timings is not None:
        sync_device(device)
        timings["prefill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    final_out = np.full((B0, max_tokens), pad_token_id, np.int64)
    final_lp = np.zeros((B0, max_tokens), np.float32)
    owner = np.arange(B0)
    seg = segment_length(max_tokens, segments)
    menu: list[list] = []

    def flush(rows, out_np, lp_np):
        live_owner = owner[rows]
        keep = live_owner >= 0
        final_out[live_owner[keep]] = out_np[rows[keep]]
        if capture_logprobs:
            final_lp[live_owner[keep]] = lp_np[rows[keep]]

    def new_loop(st):
        return ChunkedLoop(
            lambda: _decode_body(params, config, st, Tp=Tp, generator=generator, **kw),
            sync_every=sync_every, device=device, generator=generator,
            what="compacting decode")

    loop = new_loop(state)
    loops = [loop]
    menu.append([B0, 0, {}])
    step = 1
    while step < max_tokens:
        state["limit"].fill_(min(step + seg, max_tokens))
        counts0 = launch_counts()
        run = loop.body if decode_loop == "per_step" else loop.run_chunk
        while bool(_loop_active(state, max_tokens)):
            run()
        counts1 = launch_counts()
        new_step = int(state["step"])
        menu[-1][1] += new_step - step
        for name, n in counts1.items():
            if n - counts0[name]:
                menu[-1][2][name] = menu[-1][2].get(name, 0) + n - counts0[name]
        step = new_step
        done = state["done"].cpu().numpy()
        if done.all() or step >= max_tokens:
            break
        live = np.where(~done)[0]
        target = compacted_size(len(live), len(done))
        if target is not None:
            flush(np.where(done)[0], state["out"].cpu().numpy(),
                  state["lp_out"].cpu().numpy())
            idx = np.concatenate([live, np.repeat(live[:1], target - len(live))])
            new_owner = owner[idx]
            new_owner[len(live):] = -1
            state = _gather_rows(state, torch.as_tensor(idx, device=device))
            owner = new_owner
            if len(live) < target:
                # padding duplicates must read as done, or they keep sampling
                # and can hold the batch at max_tokens after every real row
                state["done"][len(live):] = True
            loop = new_loop(state)
            loops.append(loop)
            menu.append([target, 0, {}])

    flush(np.arange(len(owner)), state["out"].cpu().numpy(), state["lp_out"].cpu().numpy())
    if timings is not None:
        sync_device(device)
        timings["decode_s"] = time.perf_counter() - t0
        timings["decode_steps"] = step - 1
        for lp in loops:
            lp.record(timings)
    if stats_out is not None:
        stats_out.append({"menu": [tuple(m) for m in menu],
                          "compactions": len(menu) - 1})
    out = torch.as_tensor(final_out, device=device)
    return (out, torch.as_tensor(final_lp, device=device)) if capture_logprobs else out


def _compact_block(params, config, prompt_ids, prompt_mask, generator, mesh, **kw):
    """The per-rank carry: this batch rank's block of the prompts through
    the one-rank loop, then every rank's rows gathered in rank order."""
    block = batch_sharding(mesh, prompt_ids.shape[0])
    got = generate_tokens_compact(params, config, prompt_ids[block], prompt_mask[block],
                                  generator, **kw)
    tr = mesh.batch_transport
    if kw["capture_logprobs"]:
        out, lp = got
        return (torch.cat(tr.all_gather(out)), torch.cat(tr.all_gather(lp)))
    return torch.cat(tr.all_gather(got))
