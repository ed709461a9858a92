"""The decode session — the port of `nanorlhf_tpu/sampler/paged/session.py`
in its rollout mode: one resident decode batch over a recycled page pool.

`DecodeSession` owns the carry of `rows` resident rows (`it, out, lp_out,
caches, key_mask, done, cur_tok, n_gen, prompt_len` and the acceptance
counters and per-row `row_acc` of `sampler/speculative.py`, which stay 0
without speculative decode), the resident prompts the drafter reads, the
page allocator
(host numpy, `pages.py`; the block table is uploaded to the device when an
admission or a release changes it) and the admission generators. The
scheduler (`scheduler.py`) drives it: `bootstrap` the first `rows` prompts
in one batched prefill, then `step`, `release` finished rows and `admit`
queued prompts into the freed rows, until the queue drains.

Choices where the port differs from JAX's jitted chunk:

  * **The chunk.** `step` runs `sync_every` iterations of one body over
    device state (`_decode_body` or `_spec_body`), predicated on
    `~all(done)`: on the card the first chunk runs eagerly and every later
    one replays a CUDA graph captured once per session
    (`sampler/graph.py`); on the CPU each chunk runs eagerly. JAX's
    `while_loop` stops inside a chunk once every row is done; here the
    chunk's tail runs predicated off, so the iteration counter still
    counts only iterations that ran with a live row (`iterations()` means
    what it means in JAX), while the kernels' launch counts include the
    tail. Admissions and releases write the carry, the resident prompts
    and the block table in place, so a replay reads what they wrote.
    `decode_loop="per_step"` checks `done.all()` on the host before every
    iteration instead — the plain version the chunk is held against; when
    it stops early it still takes the draws the chunk's predicated-off
    iterations would take (`_skip_draws`), so both see one random stream.
  * **PRNG streams.** Decode draws come from the session's generator, one
    draw per iteration; the first token of queue entry q comes from its own
    generator, `stream_generator(seed, ADMIT_STREAM, q)` with `seed` the
    session generator's seed — the counterpart of JAX's
    `fold_in(key, _ADMIT_BASE + q)`: a row's first token does not depend on
    which resident row it landed in. Sampled streams match JAX in
    distribution only (Philox vs threefry); greedy streams match exactly.
  * **Dropped writes.** A done row keeps stepping (its token is masked and
    its output write dropped); once released, its table row is sentinel and
    its K/V writes land on the pool's scratch page (`core/model.py`).
  * **Speculative decode.** With `spec_k > 0` an iteration is one draft +
    verify (`speculative._draft_fn` / `_verify_fn`) through the live table;
    the pool has no slack slots, so a candidate write past a row's pages
    lands on the scratch page, past `max_tokens`, where the emission clamp
    cuts it.

With an enabled `latency` hub (`telemetry.LatencyHub`) the session records,
as JAX's does, one `latency/ttft_s` per admitted request (the bootstrap's
rows: the batched prefill's wall; a mid-loop admission: from the `admit`
call to its first token, synchronized) and one `latency/intertoken_s` per
chunk (the chunk's wall over the iterations it advanced).

The serving mode (`per_row`), the radix prefix cache (and with it the
drafter's seed window) and chunked prefill are not ported: asking for them
raises NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch.core.model import decode_step, prefill
from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, ChunkedLoop, check_decode_loop
from nanorlhf_tpu_torch.sampler.paged.pages import (
    PageState,
    alloc_row,
    blocks_per_row,
    full_table,
    release_row,
)
from nanorlhf_tpu_torch.sampler.sampler import (
    _prefill_state,
    _sample_token,
    _token_logprob,
    stream_generator,
    sync_device,
)
from nanorlhf_tpu_torch.sampler.speculative import (
    _draft_fn,
    _spec_state,
    _verify_fn,
    accept_candidates,
)

# the admission stream, far from any other stream constant of the port (the
# counterpart of JAX's `_ADMIT_BASE` fold offset)
ADMIT_STREAM = 10_000_000


class DecodeSession:
    """One resident decode batch (rollout mode). See the module docstring."""

    def __init__(self, params, config, *, rows, prompt_len, max_tokens,
                 page_size, eos_token_id, pad_token_id, generator,
                 temperature=1.0, top_p=0.95, greedy=False, top_k=64,
                 approx_top_k=True, capture_logprobs=False, lora_scale=1.0,
                 per_row=False, spec_k=0, spec_ngram=3, prefix_cache=None,
                 prefill_chunk=0, sync_every=SYNC_EVERY, decode_loop="chunked",
                 latency=None):
        unported = {"per_row (serving mode)": per_row,
                    "prefix_cache (radix prefix cache)": prefix_cache is not None,
                    "prefill_chunk > 0 (chunked prefill)": prefill_chunk > 0}
        on = [what for what, flag in unported.items() if flag]
        if on:
            raise NotImplementedError(
                f"DecodeSession: {', '.join(on)} not ported to "
                "nanorlhf_tpu_torch yet (rollout mode only, with or without "
                "speculative decode)")
        self.params, self.config = params, config
        self.rows = int(rows)
        self.Tp = int(prompt_len)
        self.max_tokens = int(max_tokens)
        self.page_size = int(page_size)
        self.eos_token_id = int(eos_token_id)
        self.pad_token_id = int(pad_token_id)
        check_decode_loop(decode_loop, sync_every)
        self.sync_every = int(sync_every)
        self.decode_loop = decode_loop
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.lora_scale = lora_scale
        self.capture_logprobs = bool(capture_logprobs)
        self.generator = generator
        self.device = params["embed_tokens"].device
        self._hub = latency if getattr(latency, "enabled", False) else None
        self._it_prev = 0
        self._sample_kw = dict(temperature=temperature, top_p=top_p,
                               greedy=greedy, top_k=top_k,
                               approx_top_k=approx_top_k)
        self.T_max = self.Tp + self.max_tokens
        self.nb = blocks_per_row(self.T_max, self.page_size)
        self.num_pages = self.rows * self.nb
        # the free stack starts EMPTY: bootstrap() claims the whole pool
        # through the identity table, churn begins at the first release
        self._pstate = PageState(np.arange(self.num_pages, dtype=np.int32), 0,
                                 full_table(self.rows, self.nb))
        self.table = torch.as_tensor(self._pstate.table, device=self.device)
        self.state: dict = {}
        self._loop = ChunkedLoop(
            lambda: self._spec_body() if self.spec_k else self._decode_body(),
            sync_every=self.sync_every, device=self.device, generator=generator,
            what="queued speculative" if self.spec_k else "queued decode")
        self.launches = 0          # admission prefills (incl. the bootstrap)
        self.dispatch_tokens = 0   # prompt tokens prefilled

    def _upload_table(self) -> None:
        """Copy the host table into the one device buffer the decode chunk
        reads (a replay reads this storage)."""
        self.table.copy_(torch.as_tensor(self._pstate.table))

    # ------------------------------------------------------------- #
    # admission
    # ------------------------------------------------------------- #

    def bootstrap(self, prompt_ids, prompt_mask) -> None:
        """Batched initial admission: one prefill of the first `rows`
        prompts over the whole pool through the identity table (the
        monolithic paged prefill), first tokens drawn from the session
        generator."""
        R = self.rows
        t0 = time.perf_counter()
        st = _prefill_state(
            self.params, self.config, prompt_ids[:R], prompt_mask[:R],
            self.generator, max_tokens=self.max_tokens,
            eos_token_id=self.eos_token_id, pad_token_id=self.pad_token_id,
            lora_scale=self.lora_scale, capture_logprobs=self.capture_logprobs,
            page_size=self.page_size, **self._sample_kw)
        self.launches += 1
        self.dispatch_tokens += R * self.Tp
        self.state = _spec_state(st)
        # the resident prompts, the drafter's lookup buffer
        self.prompt_res = prompt_ids[:R].clone()
        if self._hub is not None:
            # every initial row's first token exists once this prefill
            # lands: one TTFT observation per admitted request
            sync_device(self.device)
            ttft0 = time.perf_counter() - t0
            for _ in range(R):
                self._hub.record("latency/ttft_s", ttft0)
        self._it_prev = 0

    def admit(self, r: int, toks_np, mask_np, admit_index: int) -> None:
        """Admit one prompt ([Tp] ids and mask, left-padded) into resident
        row `r`: claim its pages, prefill the full row (pads included)
        through its table row into the shared pool, draw its first token
        from the admission generator of `admit_index` (the queue index),
        and re-initialise the row's carry."""
        t0 = time.perf_counter()
        self._pstate, ok = alloc_row(self._pstate, r, self.nb)
        if not ok:
            raise RuntimeError("allocator underflow: full-budget rows recycle "
                               "uniformly, a release must precede each admit")
        self._upload_table()
        ids = torch.as_tensor(np.asarray(toks_np)[None, :], dtype=torch.int64,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(mask_np, bool)[None, :],
                               device=self.device)
        logits, _ = prefill(
            self.params, self.config, ids, mask, self.state["caches"],
            lora_scale=self.lora_scale, page_table=self.table[r:r + 1],
            page_size=self.page_size, logical_len=self.T_max)
        tok0 = _sample_token(self.admission_generator(admit_index), logits,
                             **self._sample_kw)
        lp0 = _token_logprob(logits, tok0, self._sample_kw["temperature"])
        self.launches += 1
        self.dispatch_tokens += self.Tp
        self.prompt_res[r] = ids[0]
        if self._hub is not None:
            sync_device(self.device)  # this request's first token exists
            self._hub.record("latency/ttft_s", time.perf_counter() - t0)
        self._install_row(r, tok0[0], lp0[0], mask[0], mask[0].sum())

    def admission_generator(self, admit_index: int) -> torch.Generator:
        """The generator of queue entry `admit_index`'s first token: keyed
        on (the session generator's seed, ADMIT_STREAM, admit_index)."""
        return stream_generator(self.generator.initial_seed(), ADMIT_STREAM,
                                admit_index, device=self.device)

    def _install_row(self, r, tok0, lp0, pmask_row, plen) -> None:
        s = self.state
        s["out"][r] = self.pad_token_id
        s["out"][r, 0] = tok0
        s["lp_out"][r] = 0.0
        s["lp_out"][r, 0] = lp0
        s["key_mask"][r] = False
        s["key_mask"][r, :self.Tp] = pmask_row
        s["done"][r] = tok0 == self.eos_token_id
        s["cur_tok"][r] = tok0
        s["n_gen"][r] = 1
        s["prompt_len"][r] = plen
        s["row_acc"][r] = 0

    # ------------------------------------------------------------- #
    # stepping
    # ------------------------------------------------------------- #

    def _decode_body(self) -> None:
        """One decode iteration over every resident row, in place and with
        no host read — the monolithic `_decode_body` with per-row depths:
        row r's current token sits at slot Tp + n_gen[r] - 1; done rows
        write nothing to the output, and a row is done at EOS or at
        `max_tokens` generated tokens. Predicated on `~all(done)`."""
        s = self.state
        n_gen, done = s["n_gen"], s["done"]
        active = ~done.all()
        R = n_gen.shape[0]
        rows = torch.arange(R, device=self.device)
        slot = self.Tp + n_gen - 1
        s["key_mask"][rows, slot] = s["key_mask"][rows, slot] | active
        position = s["prompt_len"] + n_gen - 1
        logits, _ = decode_step(
            self.params, self.config, s["cur_tok"], position, slot,
            s["key_mask"], s["caches"], lora_scale=self.lora_scale,
            page_table=self.table, page_size=self.page_size)
        tok = _sample_token(self.generator, logits, **self._sample_kw)
        tok = torch.where(done, torch.full_like(tok, self.pad_token_id), tok)
        live = ~done & active
        write = live & (n_gen < self.max_tokens)  # JAX drops the rest
        col = n_gen.clamp(max=self.max_tokens - 1)
        s["out"][rows, col] = torch.where(write, tok, s["out"][rows, col])
        if self.capture_logprobs:
            lp = _token_logprob(logits, tok, self._sample_kw["temperature"])
            s["lp_out"][rows, col] = torch.where(write, lp, s["lp_out"][rows, col])
        s["cur_tok"].copy_(torch.where(live, tok, s["cur_tok"]))
        n_gen += live.to(n_gen.dtype)
        done.copy_(done | (active & ((tok == self.eos_token_id)
                                     | (n_gen >= self.max_tokens))))
        s["it"] += active

    def _spec_body(self) -> None:
        """One draft + verify iteration over every resident row, through the
        live table (JAX `_spec_loop`'s body), predicated on `~all(done)`;
        advances `it`."""
        drafts = _draft_fn(self.prompt_res, self.state, Tp=self.Tp,
                           spec_k=self.spec_k, spec_ngram=self.spec_ngram,
                           pad_token_id=self.pad_token_id)
        _verify_fn(self.params, self.config, self.state, drafts, Tp=self.Tp,
                   max_tokens=self.max_tokens, eos_token_id=self.eos_token_id,
                   spec_k=self.spec_k, lora_scale=self.lora_scale,
                   capture_logprobs=self.capture_logprobs,
                   generator=self.generator, page_table=self.table,
                   page_size=self.page_size, active=~self.state["done"].all(),
                   **self._sample_kw)

    def _skip_draws(self) -> None:
        """Take the draws of one predicated-off iteration from the session
        generator (the sampler on zero logits), without touching the
        carry: the per-step loop's stand-in for a chunk's tail."""
        R, V = self.rows, self.config.vocab_size
        if self._sample_kw["greedy"]:
            return
        if self.spec_k:
            K1 = self.spec_k + 1
            accept_candidates(torch.zeros((R, K1, V), device=self.device),
                              torch.zeros((R, K1 - 1), dtype=torch.int64,
                                          device=self.device),
                              self.generator, **self._sample_kw)
        else:
            _sample_token(self.generator, torch.zeros((R, V), device=self.device),
                          **self._sample_kw)

    def step(self) -> np.ndarray:
        """One chunk of `sync_every` decode (or draft + verify) iterations,
        no host read inside (graph replay on the card); per step, a host
        check before each iteration. Returns the host done flags [rows]."""
        t0 = time.perf_counter()
        if self.decode_loop == "chunked":
            self._loop.run_chunk()
        else:
            for i in range(self.sync_every):
                if bool(self.state["done"].all()):
                    for _ in range(self.sync_every - i):
                        self._skip_draws()
                    break
                self._loop.body()
        done_h = self.state["done"].cpu().numpy()  # the chunk's device sync
        if self._hub is not None:
            it_now = self.iterations()
            self._hub.record("latency/intertoken_s",
                             (time.perf_counter() - t0)
                             / max(1, it_now - self._it_prev))
            self._it_prev = it_now
        return done_h

    def loop_stats(self) -> dict:
        """graph_capture_s, graph_steps_run, graph_replays and
        graph_pool_bytes so far."""
        stats: dict = {}
        self._loop.record(stats)
        return stats

    # ------------------------------------------------------------- #
    # release / introspection
    # ------------------------------------------------------------- #

    def release(self, r: int) -> int:
        """Hand row `r`'s pages back to the free stack; its table row
        becomes sentinel. Returns the pages freed (0 on a second release)."""
        self._pstate, m = release_row(self._pstate, r)
        self._upload_table()
        return m

    def iterations(self) -> int:
        """Decode iterations that ran with a live row so far."""
        return int(self.state["it"]) - 1

    def dispatch_events(self) -> int:
        """Model-forward launches: admission prefills plus decode
        iterations."""
        return self.launches + self.iterations()

    def utilization(self) -> float:
        """Allocated / total pages right now."""
        return 1.0 - self._pstate.top / self.num_pages

    def status(self) -> dict:
        """The JAX session's status record (rollout mode): resident rows,
        the (empty) chunked-prefill backlog, per-row flags and counters."""
        done_h = self.state["done"].cpu().numpy()
        return {
            "rows": self.rows,
            "live_rows": int((~done_h).sum()),
            "mode": "rollout",
            "features": {"spec_k": self.spec_k, "prefix_cache": False, "prefill_chunk": 0,
                         "per_row_sampling": False, "drafter_seed_window": 0},
            "pending_prefill": {"rows": [], "backlog_tokens": 0},
            "row_flags": [{"live": bool(not d), "chunk_pending": False,
                           "seeded_draft_len": 0} for d in done_h],
            "counters": {
                "launches": self.launches,
                "decode_iterations": self.iterations(),
                "dispatch_events": self.dispatch_events(),
                "dispatch_tokens": self.dispatch_tokens,
                "prefix_hit_tokens": 0,
                "chunked_admissions": 0,
                "prefill_backlog_peak": 0,
            },
        }
