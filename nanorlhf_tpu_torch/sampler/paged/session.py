"""The decode session — the port of `nanorlhf_tpu/sampler/paged/session.py`:
one resident decode batch over a recycled page pool, in its three modes
and their compositions.

`DecodeSession` owns the carry of `rows` resident rows (`it, out, lp_out,
caches, key_mask, done, cur_tok, n_gen, prompt_len` and the acceptance
counters and per-row `row_acc` of `sampler/speculative.py`, which stay 0
without speculative decode), the resident prompts the drafter reads, the
page table (the host free stack of `pages.py`, or the radix cache's
refcounts; uploaded to the device when an admission or a release changes
it), the per-row sampling parameters of the serving mode, the drafter's
seed windows and the chunked-prefill backlog. Two drivers use it: the
rollout scheduler (`scheduler.py`: `bootstrap` the first `rows` prompts in
one batched prefill, or admit them one by one through the radix cache,
then `step`, `release` finished rows and `admit` queued prompts into the
freed rows until the queue drains) and the serving engine
(`serving/engine.py`, `per_row=True`).

Modes, as in JAX:

  * **rollout** (`per_row=False`): static sampling parameters, every row's
    budget `max_tokens`; speculative decode composes (`spec_k > 0`).
  * **serving** (`per_row=True`): per-row temperature, top-p, greedy flag
    and token budget, held in device tensors [R] that an admission writes
    in place (`r_temp`, `r_topp`, `r_greedy`, `r_budget`): the chunk that
    a CUDA graph replays reads those tensors, so a new request's
    parameters reach it. Sampling is JAX's `_serving_sample` (top-k
    candidate space always; both branches computed, greedy selected per
    row). `capture_logprobs` is refused, and so is a sampled spec session.
  * **radix prefix cache** (`prefix_cache`, `serving/radix.py`): an
    admission plans its row through the tree (shared full pages by
    refcount, a mid-page match copied on write), prefills only the
    unmatched suffix through `suffix_logits` (K9 at Tq = the suffix's
    bucket on the card), inserts its prompt into the tree, and drops only
    the row's references at release. With `spec_k > 0` a finished row's
    text extends the tree and later admissions seed their drafter's
    lookup window from the cached continuation (`seed_rep`, `seed_len`).
    The tree resets once, at construction.
  * **empty start** (`empty_start=True`, rollout mode without the radix
    cache): every row starts done and every page free, as the multi-turn
    episode driver (`envs/rollout.py`) needs; rows come in through
    `admit`, never `bootstrap`.
  * **chunked prefill** (`prefill_chunk > 0`): an admission whose real
    suffix is longer than the chunk is parked (`_PendingPrefill`, the row
    done) and advanced one KV-only `decode_verify(want_logits=False)`
    chunk per `step`; the final chunk runs through `suffix_logits` and
    draws the first token from the same admission generator as an
    unchunked admission, so greedy streams are equal with and without.

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
    tail. Admissions and releases write the carry, the resident prompts,
    the per-row parameters, the seed windows and the block table in
    place, so a replay reads what they wrote.
    `decode_loop="per_step"` checks `done.all()` on the host before every
    iteration instead — the plain version the chunk is held against; when
    it stops early it still takes the draws the chunk's predicated-off
    iterations would take (`_skip_draws`), so both see one random stream.
  * **`step` returns the host done flags** (as before); the (row, first
    token) of an admission whose final chunk landed in that step is
    `installed` (JAX returns the pair).
  * **PRNG streams.** Decode draws come from the session's generator, one
    draw per iteration; the first token of queue entry (or request) q
    comes from its own generator, `stream_generator(admit_seed,
    ADMIT_STREAM, q)` — the counterpart of JAX's
    `fold_in(admit_key, _ADMIT_BASE + q)`: a row's first token does not
    depend on which resident row it landed in. Sampled streams match JAX
    in distribution only (Philox vs threefry); greedy streams match
    exactly.
  * **Dropped writes.** A done row keeps stepping (its token is masked and
    its output write dropped); once released, its table row is sentinel and
    its K/V writes land on the pool's scratch page (`core/model.py`).
  * **Speculative decode.** With `spec_k > 0` an iteration is one draft +
    verify (`speculative._draft_fn` / `_verify_fn`) through the live table;
    the pool has no slack slots, so a candidate write past a row's pages
    lands on the scratch page, past `max_tokens`, where the emission clamp
    cuts it.
  * **In-flight weight swaps.** `install_params` copies a fresh tree into
    the session's parameter tensors in place, on the session's stream,
    between chunks: a replayed CUDA graph reads the tensors it captured,
    so rebinding `self.params` (what JAX's scheduler does with its traced
    argument) would leave every later replay on the old weights.
  * **`status()`** reads host copies (the done flags of the last step), so
    the serving engine's HTTP threads never touch the device.

With an enabled `latency` hub (`telemetry.LatencyHub`) the session records,
as JAX's does, one `latency/ttft_s` per admitted request (the bootstrap's
rows: the batched prefill's wall; any other admission: from its start to
its first token, synchronized) and one `latency/intertoken_s` per chunk
(the chunk's wall over the iterations it advanced; the serving mode only
when the counter advanced).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nanorlhf_tpu_torch.core.model import (
    decode_step,
    decode_verify,
    init_paged_kv_cache,
    prefill,
)
from nanorlhf_tpu_torch.ops.masking import guard_temperature
from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, ChunkedLoop, check_decode_loop
from nanorlhf_tpu_torch.sampler.paged.pages import (
    PageState,
    alloc_row,
    blocks_per_row,
    full_table,
    init_page_state,
    release_row,
)
from nanorlhf_tpu_torch.sampler.sampler import (
    _categorical,
    _nucleus_candidates,
    _prefill_state,
    _sample_token,
    _token_logprob,
    stream_generator,
    sync_device,
)
from nanorlhf_tpu_torch.sampler.speculative import (
    _COUNTERS,
    _draft_fn,
    _spec_state,
    _verify_fn,
    accept_candidates,
)

@torch.no_grad()
def copy_params(live: dict, fresh: dict) -> int:
    """Install `fresh` into `live` IN PLACE: every tensor leaf of `fresh`
    that is not `live`'s own tensor is copied into it on the current
    stream; the dict and its tensors stay the objects a captured CUDA graph
    read (rebinding them would leave every later replay on the old
    weights). `live` must own each leaf a fresh tree replaces. Returns the
    leaves copied."""
    copied = 0
    for k, v in fresh.items():
        cur = live[k]
        if isinstance(v, dict):
            copied += copy_params(cur, v)
        elif isinstance(v, torch.Tensor) and v is not cur:
            if v.shape != cur.shape or v.dtype != cur.dtype:
                raise ValueError(f"weight swap: leaf {k!r} {tuple(v.shape)} {v.dtype} "
                                 f"does not fit the live {tuple(cur.shape)} {cur.dtype}")
            cur.copy_(v)
            copied += 1
    return copied


# the admission stream, far from any other stream constant of the port (the
# counterpart of JAX's `_ADMIT_BASE` fold offset)
ADMIT_STREAM = 10_000_000


def _serving_sample(generator, logits, temperature, top_p, greedy, *, top_k,
                    approx_top_k):
    """Per-ROW sampling (JAX `_serving_sample`): temperature / top_p /
    greedy are [R] tensors. Both branches are computed and selected per
    row; the nucleus keep rule broadcasts top_p[:, None] against the [R, K]
    candidates. Unlike the rollout sampler there is no exact full-vocab
    escape for top_p >= 1 — serving always samples in top-k candidate
    space (top_p = 1 keeps every candidate). One [R, K] draw per call."""
    scaled = logits.float() / guard_temperature(temperature)[:, None]
    top_logits, top_idx, keep = _nucleus_candidates(scaled, top_p[:, None],
                                                    top_k, approx_top_k)
    kept = torch.where(keep, top_logits, torch.full_like(top_logits, -float("inf")))
    choice = _categorical(generator, kept)
    sampled = torch.gather(top_idx, -1, choice[:, None])[:, 0]
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


@dataclass
class _PendingPrefill:
    """A chunked admission in flight: the row's pages are claimed and its
    carry row stays done; `next_slot` advances one chunk per session step
    until the final chunk installs the row."""
    row: int
    toks: np.ndarray              # [Tp] left-padded
    mask: np.ndarray              # [Tp] bool
    pad_count: int
    next_slot: int                # next absolute cache slot to prefill
    admit_index: int
    t_start: float
    kelems: Optional[tuple] = None        # radix key (radix mode)
    plan_hit: int = 0
    seed: Optional[np.ndarray] = None     # drafter seed (spec × radix)
    budget: Optional[int] = None          # per-row mode request params
    temperature: float = 1.0
    top_p: float = 1.0
    greedy: bool = False
    full_cold: bool = False               # chunked from the first real token


class DecodeSession:
    """One resident decode batch with uniform per-row state. See the module
    docstring."""

    def __init__(self, params, config, *, rows, prompt_len, max_tokens,
                 page_size, eos_token_id, pad_token_id, generator,
                 temperature=1.0, top_p=0.95, greedy=False, top_k=64,
                 approx_top_k=True, capture_logprobs=False, lora_scale=1.0,
                 per_row=False, spec_k=0, spec_ngram=3, prefix_cache=None,
                 prefill_chunk=0, sync_every=SYNC_EVERY, decode_loop="chunked",
                 latency=None, admit_seed=None, empty_start=False):
        if per_row and capture_logprobs:
            raise ValueError(
                "capture_logprobs is incompatible with per-row sampling "
                "params: the logprob write shares the chunk body's static "
                "temperature — see sampler.compose_check")
        if per_row and spec_k > 0 and not greedy:
            raise ValueError(
                "per-row spec decode requires the session's static "
                "greedy=True: the verify/accept rule runs against static "
                "sampling params, so a spec serving engine admits greedy "
                "requests only — see sampler.compose_check")
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
        self.per_row = bool(per_row)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.prefill_chunk = int(prefill_chunk)
        self.lora_scale = lora_scale
        self.capture_logprobs = bool(capture_logprobs)
        self.generator = generator
        self.admit_seed = (generator.initial_seed() if admit_seed is None
                           else int(admit_seed))
        self.device = params["embed_tokens"].device
        self._hub = latency if getattr(latency, "enabled", False) else None
        self._it_prev = 0
        self._sample_kw = dict(temperature=temperature, top_p=top_p,
                               greedy=greedy, top_k=top_k,
                               approx_top_k=approx_top_k)
        self.T_max = self.Tp + self.max_tokens
        self.nb = blocks_per_row(self.T_max, self.page_size)
        R, dev = self.rows, self.device

        self._radix = prefix_cache if getattr(prefix_cache, "enabled", False) else None
        if self._radix is not None:
            self.num_pages = (R * self.nb + self._radix.extra_pages(R, self.nb))
            self._radix.reset(num_pages=self.num_pages, page_size=self.page_size)
            self.table_np = np.full((R, self.nb), self.num_pages, np.int32)
            self._pstate = None
        elif empty_start:
            # the multi-turn episode driver's start (JAX `ensure_carry`):
            # every page free, every table row sentinel, admit() claims rows
            self.num_pages = R * self.nb
            self._pstate = init_page_state(self.num_pages, R, self.nb)
            self.table_np = self._pstate.table
        else:
            self.num_pages = R * self.nb
            # the free stack starts EMPTY: bootstrap() claims the whole pool
            # through the identity table, churn begins at the first release
            self._pstate = PageState(np.arange(self.num_pages, dtype=np.int32), 0,
                                     full_table(R, self.nb))
            self.table_np = self._pstate.table
        self.table = torch.as_tensor(self.table_np, device=dev)

        self.state: dict = {}
        self.prompt_res = torch.full((R, self.Tp), self.pad_token_id,
                                     dtype=torch.int64, device=dev)
        self._empty_start = self._radix is not None or self.per_row or bool(empty_start)
        if self._empty_start:
            # the empty carry: every row starts done; admit() installs rows
            # (the rollout mode without the radix cache bootstraps instead,
            # unless it asked for an empty start)
            self.state = self._empty_state()
        # per-row sampling parameters (serving mode), written in place
        self.r_temp = torch.ones((R,), dtype=torch.float32, device=dev)
        self.r_topp = torch.ones((R,), dtype=torch.float32, device=dev)
        self.r_greedy = torch.zeros((R,), dtype=torch.bool, device=dev)
        self.r_budget = torch.ones((R,), dtype=torch.int64, device=dev)
        # the drafter's seed windows (spec × radix), right-aligned
        self.seed_window = (self.max_tokens + self.spec_ngram
                            if (self.spec_k and self._radix is not None) else 0)
        self.seed_rep = torch.full((R, self.seed_window), self.pad_token_id,
                                   dtype=torch.int64, device=dev)
        self.seed_len = torch.zeros((R,), dtype=torch.int64, device=dev)
        self._seed_len_h = np.zeros((R,), np.int64)

        self._kelems: list = [None] * R       # radix keys of resident rows
        self._pending: list[_PendingPrefill] = []
        self._done_h = np.ones((R,), bool)    # host copies for status()
        self._it_h = 0
        self.installed = None                 # (row, tok0) of the last step

        self._loop = ChunkedLoop(
            lambda: self._spec_body() if self.spec_k else self._decode_body(),
            sync_every=self.sync_every, device=dev, generator=generator,
            what="queued speculative" if self.spec_k else "queued decode")
        # dispatch accounting (JAX's): launches = model forwards outside the
        # decode/verify loop (prefills, suffix forwards, prefill chunks);
        # decode iterations come from the carry's own counter
        self.launches = 0
        self.dispatch_tokens = 0   # prompt / suffix / chunk tokens prefilled
        self.hit_tokens = 0
        self.chunked_admissions = 0
        self.backlog_peak = 0

    def _empty_state(self) -> dict:
        R, dev = self.rows, self.device
        caches = init_paged_kv_cache(self.config, self.num_pages, self.page_size,
                                     self.params["embed_tokens"].dtype, dev)
        state = {
            "out": torch.full((R, self.max_tokens), self.pad_token_id,
                              dtype=torch.int64, device=dev),
            "lp_out": torch.zeros((R, self.max_tokens), dtype=torch.float32, device=dev),
            "caches": caches,
            "key_mask": torch.zeros((R, self.T_max), dtype=torch.bool, device=dev),
            "done": torch.ones((R,), dtype=torch.bool, device=dev),
            "cur_tok": torch.zeros((R,), dtype=torch.int64, device=dev),
            "prompt_len": torch.zeros((R,), dtype=torch.int64, device=dev),
            "table": self.table, "page_size": self.page_size,
            "it": torch.ones((), dtype=torch.int64, device=dev),
            "n_gen": torch.ones((R,), dtype=torch.int64, device=dev),
            "row_acc": torch.zeros((R,), dtype=torch.int64, device=dev),
        }
        for name in _COUNTERS:
            state[name] = torch.zeros((), dtype=torch.int64, device=dev)
        return state

    def install_params(self, fresh: dict) -> int:
        """An in-flight weight swap between chunks: `copy_params` of
        `fresh` into the session's own tree (never a rebinding of
        `self.params`, which the captured chunk would not see). Returns the
        leaves copied."""
        return copy_params(self.params, fresh)

    def _upload_table(self) -> None:
        """Copy the host table into the one device buffer the decode chunk
        reads (a replay reads this storage)."""
        self.table.copy_(torch.as_tensor(self.table_np))

    # ------------------------------------------------------------- #
    # admission
    # ------------------------------------------------------------- #

    def bootstrap(self, prompt_ids, prompt_mask) -> None:
        """Batched initial admission for the rollout mode without the radix
        cache: one prefill of the first `rows` prompts over the whole pool
        through the identity table (the monolithic paged prefill), first
        tokens drawn from the session generator. Never chunked: chunked
        prefill protects RESIDENT rows' latency, and there are none yet."""
        assert not self._empty_start, "an empty-start session admits rows individually"
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
        self.prompt_res = prompt_ids[:R].clone()
        self._done_h[:] = False
        if self._hub is not None:
            # every initial row's first token exists once this prefill
            # lands: one TTFT observation per admitted request
            sync_device(self.device)
            ttft0 = time.perf_counter() - t0
            for _ in range(R):
                self._hub.record("latency/ttft_s", ttft0)
        self._it_prev = 0

    def admit(self, r: int, toks_np, mask_np, admit_index: int, *,
              budget=None, temperature=None, top_p=None, greedy=None,
              t_start=None):
        """Admit one prompt ([Tp] ids and mask, left-padded) into resident
        row `r`.

        `admit_index` keys the admission generator — the rollout driver
        passes the queue index, the engine the request id. Rollout mode
        ignores the per-request keywords (sampling params are the
        session's); serving mode requires `budget`.

        Radix mode may raise RuntimeError (pool exhausted even after
        eviction) BEFORE any row state changes — the engine sheds on it.

        Returns the first token as a host int in per-row mode (the engine
        streams it at once), None in rollout mode (no forced device sync),
        and None for a chunked admission in either mode (its first token
        lands when the final chunk installs the row — drivers treat
        `is_pending(r)` rows as not yet done)."""
        toks_np = np.asarray(toks_np, np.int64)
        mask_np = np.asarray(mask_np, bool)
        t0 = time.perf_counter() if t_start is None else t_start
        pad_count = int(self.Tp - mask_np.sum())

        kelems = plan = seed = None
        if self._radix is not None:
            from nanorlhf_tpu_torch.serving.radix import copy_page, prompt_key
            kelems = prompt_key(toks_np, mask_np)
            # may raise RuntimeError — before any state mutation
            plan = self._radix.plan(kelems, pad_count=pad_count,
                                    n_blocks=self.nb, prompt_len=self.Tp)
            if self.seed_window:
                seed = self._radix.matched_continuation(kelems, self.seed_window)
            self.table_np[r] = plan.row_pages
            if plan.cow_src is not None:
                copy_page(self.state["caches"], plan.cow_src, plan.cow_dst)
            # per-row mode runs the suffix forward even on a cold miss
            # (start = pad_count, pad KV never written); rollout mode keeps
            # the cold full-row prefill so its streams stay equal to the
            # uncached scheduler's
            if plan.m > 0:
                start = plan.m
            elif self.per_row:
                start = pad_count
            else:
                start = None
        else:
            self._pstate, ok = alloc_row(self._pstate, r, self.nb)
            if not ok:
                raise RuntimeError("allocator underflow: full-budget rows recycle "
                                   "uniformly, a release must precede each admit")
            self.table_np = self._pstate.table
            start = None
        self._upload_table()

        pend = _PendingPrefill(
            row=r, toks=toks_np, mask=mask_np, pad_count=pad_count,
            next_slot=0, admit_index=int(admit_index), t_start=t0,
            kelems=kelems, plan_hit=(plan.hit_tokens if plan is not None else 0),
            seed=seed, budget=budget,
            temperature=1.0 if temperature is None else float(temperature),
            top_p=1.0 if top_p is None else float(top_p),
            greedy=bool(greedy))
        # cold full-row prefill (rollout mode) or the suffix from `start`;
        # with chunking on, a cold row is chunked from its first REAL token
        full_cold = start is None
        start_abs = pad_count if full_cold else start
        C = self.prefill_chunk
        if C > 0 and self.Tp - start_abs > C:
            pend.next_slot = start_abs
            pend.full_cold = full_cold
            self._pending.append(pend)
            self.backlog_peak = max(self.backlog_peak, self._backlog_tokens())
            self.chunked_admissions += 1
            return None
        return self._admit_now(pend, full_cold=full_cold, start_abs=start_abs)

    def admission_generator(self, admit_index: int) -> torch.Generator:
        """The generator of queue entry (request) `admit_index`'s first
        token: keyed on (admit_seed, ADMIT_STREAM, admit_index)."""
        return stream_generator(self.admit_seed, ADMIT_STREAM, admit_index,
                                device=self.device)

    def _admit_now(self, p: _PendingPrefill, *, full_cold: bool, start_abs: int):
        """Unchunked (or final-chunk) admission forward + install."""
        caches = self.state["caches"]
        gen = self.admission_generator(p.admit_index)
        if full_cold and not self.per_row and self.prefill_chunk == 0:
            # the cold path: one full-row prefill (pads included) through
            # the row's table, as the uncached scheduler admits
            ids = torch.as_tensor(p.toks[None, :], device=self.device)
            mask = torch.as_tensor(p.mask[None, :], device=self.device)
            logits, _ = prefill(
                self.params, self.config, ids, mask, caches,
                lora_scale=self.lora_scale, page_table=self.table[p.row:p.row + 1],
                page_size=self.page_size, logical_len=self.T_max)
            self.dispatch_tokens += self.Tp
        else:
            from nanorlhf_tpu_torch.serving.radix import bucket_len, suffix_logits
            s_real = self.Tp - start_abs
            Sb = bucket_len(s_real, self.T_max - start_abs)
            suffix = np.zeros((1, Sb), np.int64)
            suffix[0, :s_real] = p.toks[start_abs:]
            pos = (start_abs - p.pad_count) + np.arange(Sb, dtype=np.int64)[None]
            km = np.zeros((1, self.T_max), bool)
            km[0, p.pad_count:start_abs] = True
            dev = self.device
            row_logits, _ = suffix_logits(
                self.params, self.config, torch.as_tensor(suffix, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.tensor([start_abs], device=dev), s_real - 1,
                torch.as_tensor(km, device=dev), caches, self.table[p.row],
                page_size=self.page_size, lora_scale=self.lora_scale)
            logits = row_logits[None]
            self.dispatch_tokens += Sb
            self.hit_tokens += p.plan_hit
        if self.per_row:
            dev = self.device
            tok0 = _serving_sample(
                gen, logits, torch.tensor([p.temperature], device=dev),
                torch.tensor([p.top_p], device=dev),
                torch.tensor([p.greedy], device=dev),
                top_k=self._sample_kw["top_k"],
                approx_top_k=self._sample_kw["approx_top_k"])
            lp0 = torch.zeros((1,), device=dev)
        else:
            tok0 = _sample_token(gen, logits, **self._sample_kw)
            lp0 = _token_logprob(logits, tok0, self._sample_kw["temperature"])
        self.launches += 1
        return self._install(p, tok0[0], lp0[0])

    def _install(self, p: _PendingPrefill, tok0, lp0):
        """Install an admitted row into the carry (and the tree, the per-row
        parameters and the drafter's buffers), in place."""
        r = p.row
        dev = self.device
        if self._radix is not None:
            self._radix.insert(p.kelems, self.table_np[r], self.Tp)
            self._kelems[r] = p.kelems
        if self.per_row:
            self.r_temp[r] = p.temperature
            self.r_topp[r] = p.top_p
            self.r_greedy[r] = p.greedy
            self.r_budget[r] = int(p.budget)
        self.prompt_res[r] = torch.as_tensor(p.toks, device=dev)
        if self.seed_window:
            W = self.seed_window
            n = 0 if p.seed is None else min(len(p.seed), W)
            row = np.full((W,), self.pad_token_id, np.int64)
            if n:
                row[W - n:] = p.seed[:n]
            self.seed_rep[r] = torch.as_tensor(row, device=dev)
            self.seed_len[r] = n
            self._seed_len_h[r] = n
        tok0_h = None
        if self._hub is not None or self.per_row:
            # the admission forward's sampled first token: reading it gives
            # this request's true TTFT (and the engine streams the int)
            tok0_h = int(tok0)
        if self._hub is not None:
            self._hub.record("latency/ttft_s", time.perf_counter() - p.t_start)
        s = self.state
        mask = torch.as_tensor(p.mask, device=dev)
        s["out"][r] = self.pad_token_id
        s["out"][r, 0] = tok0
        s["lp_out"][r] = 0.0
        s["lp_out"][r, 0] = lp0
        s["key_mask"][r] = False
        s["key_mask"][r, :self.Tp] = mask
        done0 = tok0 == self.eos_token_id
        if self.per_row:
            done0 = done0 | (int(p.budget) <= 1)
        s["done"][r] = done0
        s["cur_tok"][r] = tok0
        s["n_gen"][r] = 1
        s["prompt_len"][r] = int(p.mask.sum())
        s["row_acc"][r] = 0
        self._done_h[r] = (bool(tok0_h == self.eos_token_id or int(p.budget) <= 1)
                           if self.per_row else False)
        return tok0_h if self.per_row else None

    # ------------------------------------------------------------- #
    # stepping
    # ------------------------------------------------------------- #

    def _decode_body(self) -> None:
        """One decode iteration over every resident row, in place and with
        no host read — the monolithic `_decode_body` with per-row depths:
        row r's current token sits at slot Tp + n_gen[r] - 1; done rows
        write nothing to the output, and a row is done at EOS or at its
        budget (`max_tokens`, or `r_budget[r]` in serving mode).
        Predicated on `~all(done)`."""
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
        if self.per_row:
            tok = _serving_sample(self.generator, logits, self.r_temp, self.r_topp,
                                  self.r_greedy, top_k=self._sample_kw["top_k"],
                                  approx_top_k=self._sample_kw["approx_top_k"])
            limit = self.r_budget
        else:
            tok = _sample_token(self.generator, logits, **self._sample_kw)
            limit = self.max_tokens
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
        done.copy_(done | (active & ((tok == self.eos_token_id) | (n_gen >= limit))))
        s["it"] += active

    def _spec_body(self) -> None:
        """One draft + verify iteration over every resident row, through the
        live table (JAX `_spec_loop`'s body), the drafter's window seeded
        from the radix tree when the session has one; predicated on
        `~all(done)`; advances `it`."""
        seeds = (dict(seed_rep=self.seed_rep, seed_len=self.seed_len)
                 if self.seed_window else {})
        drafts = _draft_fn(self.prompt_res, self.state, Tp=self.Tp,
                           spec_k=self.spec_k, spec_ngram=self.spec_ngram,
                           pad_token_id=self.pad_token_id, **seeds)
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
        R, V, dev = self.rows, self.config.vocab_size, self.device
        zeros = torch.zeros((R, V), device=dev)
        if self.spec_k:
            if self._sample_kw["greedy"]:
                return
            K1 = self.spec_k + 1
            accept_candidates(torch.zeros((R, K1, V), device=dev),
                              torch.zeros((R, K1 - 1), dtype=torch.int64, device=dev),
                              self.generator, **self._sample_kw)
        elif self.per_row:
            _serving_sample(self.generator, zeros, self.r_temp, self.r_topp,
                            self.r_greedy, top_k=self._sample_kw["top_k"],
                            approx_top_k=self._sample_kw["approx_top_k"])
        elif not self._sample_kw["greedy"]:
            _sample_token(self.generator, zeros, **self._sample_kw)

    def _prefill_tick(self):
        """Advance the OLDEST pending chunked admission by one KV-only
        chunk forward; the final chunk (<= prefill_chunk real tokens) runs
        the suffix + install path, with the same admission generator as an
        unchunked admission. Returns (row, first token or None) when the
        row was installed, else None."""
        p = self._pending[0]
        C = self.prefill_chunk
        if self.Tp - p.next_slot <= C:
            self._pending.pop(0)
            tok0 = self._admit_now(p, full_cold=p.full_cold, start_abs=p.next_slot)
            return (p.row, tok0)
        dev = self.device
        chunk = torch.as_tensor(p.toks[p.next_slot:p.next_slot + C][None, :],
                                device=dev)
        pos = torch.as_tensor((p.next_slot - p.pad_count)
                              + np.arange(C, dtype=np.int64)[None], device=dev)
        km = np.zeros((1, self.T_max), bool)
        km[0, p.pad_count:p.next_slot] = True
        decode_verify(self.params, self.config, chunk, pos,
                      torch.tensor([p.next_slot], device=dev),
                      torch.as_tensor(km, device=dev), self.state["caches"],
                      lora_scale=self.lora_scale,
                      page_table=self.table[p.row][None, :],
                      page_size=self.page_size, want_logits=False)
        p.next_slot += C
        self.launches += 1
        self.dispatch_tokens += C
        return None

    def step(self) -> np.ndarray:
        """One scheduler beat: at most one pending-prefill chunk, then one
        chunk of `sync_every` decode (or draft + verify) iterations, no
        host read inside (graph replay on the card); per step, a host check
        before each iteration. Returns the host done flags [rows];
        `installed` is the (row, first token or None) of an admission whose
        final chunk landed in this beat, else None."""
        self.installed = self._prefill_tick() if self._pending else None
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
        self._done_h = done_h.copy()
        it_now = self._it_h = self.iterations()
        if self._hub is not None:
            if not self.per_row or it_now > self._it_prev:
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

    def release(self, r: int, gen_tokens=None) -> int:
        """Release row `r`'s pages (radix: drop the ROW's refs — tree refs
        survive as cached prefix KV; free stack: push the row's pages); its
        table row becomes sentinel. With the drafter seed on and
        `gen_tokens` (the row's emitted tokens, EOS included) given, the
        generated continuation extends the tree as text-only nodes
        (`RadixCache.extend_text`). Returns the pages freed (0 on a second
        release)."""
        if self._radix is not None:
            if (self.seed_window and gen_tokens is not None
                    and self._kelems[r] is not None):
                ext = self._kelems[r] + tuple(
                    int(t) * 2 + 1 for t in np.asarray(gen_tokens).ravel())
                self._radix.extend_text(ext)
            freed = self._radix.release(self.table_np[r])
            self.table_np[r] = self.num_pages
            self._kelems[r] = None
        else:
            self._pstate, freed = release_row(self._pstate, r)
            self.table_np = self._pstate.table
        self._upload_table()
        return freed

    def cancel_row(self, r: int) -> None:
        """Serving-side reap: drop any pending chunked admission for the
        row, force its done flag (the chunk then skips it), and free its
        pages — the completion path's release, so a disconnect can never
        leak what a completion would have freed."""
        self._pending = [p for p in self._pending if p.row != r]
        self.state["done"][r] = True
        self._done_h[r] = True
        self.release(r)

    def iterations(self) -> int:
        """Decode iterations that ran with a live row so far."""
        return int(self.state["it"]) - 1

    def dispatch_events(self) -> int:
        """Model-forward launches: admission forwards (prefills, suffix
        forwards, prefill chunks) plus decode iterations."""
        return self.launches + self.iterations()

    def is_pending(self, r: int) -> bool:
        return any(p.row == r for p in self._pending)

    def pending_rows(self) -> set:
        return {p.row for p in self._pending}

    def has_pending(self) -> bool:
        return bool(self._pending)

    def _backlog_tokens(self) -> int:
        return int(sum(self.Tp - p.next_slot for p in self._pending))

    def utilization(self) -> float:
        """Allocated / total pages right now."""
        if self._radix is not None:
            return 1.0 - self._radix.pool.free_count / self.num_pages
        return 1.0 - self._pstate.top / self.num_pages

    def shared_pages(self) -> int:
        return self._radix.pool.shared_count() if self._radix is not None else 0

    def status(self) -> dict:
        """The JSON-able /statusz `session` section: resident rows, the
        chunked-prefill backlog, per-row feature flags and counters. Reads
        host copies only (the done flags and the iteration count of the last
        step or admission)."""
        done_h = self._done_h
        pend = self.pending_rows()
        return {
            "rows": self.rows,
            "live_rows": int((~done_h).sum()),
            "mode": "serving" if self.per_row else "rollout",
            "features": {
                "spec_k": self.spec_k,
                "prefix_cache": self._radix is not None,
                "prefill_chunk": self.prefill_chunk,
                "per_row_sampling": self.per_row,
                "drafter_seed_window": self.seed_window,
            },
            "pending_prefill": {"rows": sorted(pend),
                                "backlog_tokens": self._backlog_tokens()},
            "row_flags": [
                {"live": bool(not done_h[r]), "chunk_pending": r in pend,
                 "seeded_draft_len": int(self._seed_len_h[r])}
                for r in range(self.rows)],
            "counters": {
                "launches": self.launches,
                "decode_iterations": self._it_h,
                "dispatch_events": self.launches + self._it_h,
                "dispatch_tokens": self.dispatch_tokens,
                "prefix_hit_tokens": self.hit_tokens,
                "chunked_admissions": self.chunked_admissions,
                "prefill_backlog_peak": self.backlog_peak,
            },
        }
