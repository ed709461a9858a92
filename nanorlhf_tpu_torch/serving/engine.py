"""Serving engine: continuous-batching decode over the radix prefix cache —
the port of `nanorlhf_tpu/serving/engine.py`.

The rollout scheduler (`sampler/paged/scheduler.py`) serves a CLOSED
queue; this module reshapes the same machinery into an OPEN server loop.
The engine owns no decode loop of its own: it drives a
`sampler.paged.session.DecodeSession` in per-row mode, so every request
flows through the same chunk body (a CUDA-graph replay on the card, with
the per-row sampling parameters and budgets in device tensors the
admissions write in place), admission path and release path the rollout
scheduler drives. What remains here is open-loop POLICY, as in JAX:

  * SLO-aware shed-vs-admit: `submit()` rejects when the pending queue
    is full or when the LatencyHub's p95 TTFT is over the `slo_ttft_p95`
    rule's warn threshold (`telemetry/health.SLO_RULES`).
  * Request lifecycle: tokens stream out through per-request queues,
    cancelled rows are reaped with their pages freed.
  * Composition inherited from the session: `prefill_chunk > 0` chunks
    long cold admissions; `spec_k > 0` runs draft + verify chunks
    (greedy requests with the full token budget only).

Admission goes through one `RadixCache` kept for the engine's whole
lifetime (the weights are fixed, so cached K/V never goes stale): a
request's matched prefix installs refcount-shared pages with zero prefill
FLOPs and only the suffix runs through `suffix_logits` (K9 on the card).
Cold admissions take the same path with an empty match.

Threading: one loop thread owns the session and EVERY device call — the
session is built on it, the admissions' forwards, the chunks (the graph
capture and its replays) run on it, on a CUDA stream it owns, under
`torch.no_grad` (grad mode is per thread). `submit()` only appends to the
pending deque under `make_condition("serving.engine")`; `metrics()` and
`snapshot()` read host copies. Where JAX takes two `PRNGKey`s, the port
takes two seeds: the decode generator's (`seed`, on `device`) and the
admissions' (`seed + 1`). An engine whose loop thread dies puts the
exception in front of the next `submit()` / `stream()` instead of hanging.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nanorlhf_tpu_torch.analysis.lockorder import make_condition
from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
from nanorlhf_tpu_torch.serving.radix import RadixCache, prompt_key
from nanorlhf_tpu_torch.telemetry.health import SLO_RULES


@dataclass
class ServingRequest:
    """One in-flight request: the stream side reads `out_q` until the
    `None` sentinel (the emitted stream INCLUDES the EOS token when one
    fired)."""
    request_id: int
    tokens: np.ndarray            # real token ids, un-padded
    temperature: float
    top_p: float
    greedy: bool
    max_tokens: int
    t_submit: float
    out_q: "queue.Queue" = field(default_factory=queue.Queue)
    n_emitted: int = 0
    cancelled: bool = False       # set by cancel(); loop reaps the row
    kelems: Optional[tuple] = None


class ServingEngine:
    """Open-loop continuous batching over the radix prefix cache.

    `prompt_len` / `max_new_tokens` fix the session's shapes (prompts are
    left-padded to `prompt_len`; longer prompts are rejected at submit).
    `slo_warn_ttft_s=None` reads the warn threshold, quantile, and warmup
    from the `slo_ttft_p95` rule in `telemetry.health.SLO_RULES`.
    `prefill_chunk > 0` splits long cold admissions into that many prompt
    tokens per decode chunk; `spec_k > 0` turns on n-gram speculative
    decode (greedy, full-budget requests only). `device` is where the
    engine runs (the card unless the caller asks for the CPU); `params`
    must lie there."""

    def __init__(self, params, config, *, eos_token_id, pad_token_id,
                 page_size=16, prompt_len=32, max_new_tokens=32, rows=2,
                 headroom=1.0, sync_every=4, max_queue=64, latency=None,
                 lora_scale=1.0, top_k=64, approx_top_k=True, seed=0,
                 slo_warn_ttft_s: Optional[float] = None,
                 prefill_chunk=0, spec_k=0, spec_ngram=3, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine: device='cuda' but no CUDA device "
                               "is available (pass device='cpu' to run on the CPU)")
        if params["embed_tokens"].device.type != self.device.type:
            raise ValueError(f"ServingEngine on {self.device}: params lie on "
                             f"{params['embed_tokens'].device}")
        self.params = params
        self.config = config
        self.eos_token_id = int(eos_token_id)
        self.pad_token_id = int(pad_token_id)
        self.page_size = int(page_size)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.rows = int(rows)
        self.sync_every = int(sync_every)
        self.max_queue = int(max_queue)
        self.prefill_chunk = int(prefill_chunk)
        self.spec_k = int(spec_k)
        self.seed = int(seed)

        rule = next(r for r in SLO_RULES if r.name == "slo_ttft_p95")
        self._slo_metric = rule.metric
        self._slo_q = rule.quantile
        self._slo_warmup = rule.warmup
        self._slo_warn = (rule.warn if slo_warn_ttft_s is None
                          else float(slo_warn_ttft_s))

        self._hub = latency if (latency is not None and latency.enabled) else None
        self._radix = RadixCache(headroom=headroom)
        self._session_kw = dict(
            rows=self.rows, prompt_len=self.prompt_len,
            max_tokens=self.max_new_tokens, page_size=self.page_size,
            eos_token_id=self.eos_token_id, pad_token_id=self.pad_token_id,
            admit_seed=self.seed + 1, greedy=(self.spec_k > 0), top_k=int(top_k),
            approx_top_k=bool(approx_top_k), lora_scale=float(lora_scale),
            per_row=True, spec_k=self.spec_k, spec_ngram=int(spec_ngram),
            prefix_cache=self._radix, prefill_chunk=self.prefill_chunk,
            sync_every=self.sync_every, latency=self._hub)
        self._sess: Optional[DecodeSession] = None
        self._owner: list = [None] * self.rows   # row -> ServingRequest

        self._cond = make_condition("serving.engine")
        self._pending: deque = deque()
        self._n_active = 0
        self._running = True
        self._error: Optional[BaseException] = None
        self._ids = itertools.count()
        self._counters = {"requests": 0, "admitted": 0, "shed": 0,
                          "completed": 0, "cancelled": 0}
        # per-cause shed counters (serving/shed_total{reason=...}),
        # pre-seeded so every reason exports a 0 row from the first scrape
        self._shed_reasons = {"queue_full": 0, "slo_ttft_p95": 0,
                              "closed": 0, "pool": 0, "disconnect": 0}
        ready = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(ready,),
                                        name="serving-engine", daemon=True)
        self._thread.start()
        ready.wait()
        if self._sess is None:
            self._thread.join()
            raise RuntimeError("ServingEngine: building the decode session "
                               "failed") from self._error
        self.T_max = self._sess.T_max
        self.nb = self._sess.nb
        self.num_pages = self._sess.num_pages

    # ------------------------------------------------------------- #
    # client side
    # ------------------------------------------------------------- #

    def _raise_if_dead(self) -> None:
        if self._error is not None:
            raise RuntimeError("serving engine loop died: "
                               f"{type(self._error).__name__}: {self._error}"
                               ) from self._error

    def submit(self, tokens, *, temperature=1.0, top_p=1.0, greedy=False,
               max_tokens=None):
        """Admission-controlled enqueue. Returns `(request, None)` or
        `(None, shed_reason)` — `"queue_full"` when the pending bound is
        hit, `"slo_ttft_p95"` when the hub's p95 TTFT is over the SLO
        warn threshold (past its warmup count). Raises the loop thread's
        exception if it died."""
        self._raise_if_dead()
        toks = np.asarray(tokens, np.int64).ravel()
        if toks.size < 1 or toks.size > self.prompt_len:
            raise ValueError(
                f"prompt length {toks.size} outside [1, {self.prompt_len}]"
                " — the engine's prompt shape is fixed")
        mx = self.max_new_tokens if max_tokens is None else int(max_tokens)
        mx = max(1, min(mx, self.max_new_tokens))
        if self.spec_k > 0 and (not greedy or mx != self.max_new_tokens):
            raise ValueError(
                "a spec-decode engine (spec_k > 0) serves greedy requests "
                "with the full token budget only: the verify/accept rule "
                "runs against static sampling params — see "
                "sampler.compose_check")
        with self._cond:
            self._counters["requests"] += 1
            reason = self._shed_reason_locked()
            if reason is not None:
                self._counters["shed"] += 1
                self._shed_reasons[reason] = self._shed_reasons.get(reason, 0) + 1
                return None, reason
            req = ServingRequest(
                request_id=next(self._ids), tokens=toks,
                temperature=float(temperature), top_p=float(top_p),
                greedy=bool(greedy), max_tokens=mx,
                t_submit=time.perf_counter())
            self._pending.append(req)
            self._cond.notify_all()
        return req, None

    def _shed_reason_locked(self) -> Optional[str]:
        if not self._running:
            return "closed"
        if len(self._pending) >= self.max_queue:
            return "queue_full"
        if (self._hub is not None
                and self._hub.count(self._slo_metric) >= self._slo_warmup
                and self._hub.quantile(self._slo_metric, self._slo_q) > self._slo_warn):
            return "slo_ttft_p95"
        return None

    def cancel(self, req: ServingRequest) -> None:
        """The client vanished mid-stream (`gw.disconnect`): stop decoding
        for this request and free its resources. Still-pending requests
        are shed at once (reason "disconnect"); an admitted row is reaped
        by the loop thread on its next iteration, counting into
        `cancelled` (admitted == completed + cancelled at quiescence).
        Idempotent."""
        was_pending = False
        with self._cond:
            if req.cancelled:
                return
            req.cancelled = True
            try:
                self._pending.remove(req)
                was_pending = True
            except ValueError:
                pass
            if was_pending:
                self._counters["shed"] += 1
                self._shed_reasons["disconnect"] = (
                    self._shed_reasons.get("disconnect", 0) + 1)
            self._cond.notify_all()
        if was_pending:
            req.out_q.put(None)

    def stream(self, req: ServingRequest, timeout: float = 120.0):
        """Yield the request's tokens as they land; ends at the `None`
        sentinel (or on `timeout` seconds of silence). Raises the loop
        thread's exception if it died before the stream ended."""
        while True:
            try:
                tok = req.out_q.get(timeout=timeout)
            except queue.Empty:
                self._raise_if_dead()
                return
            if tok is None:
                self._raise_if_dead()
                return
            yield tok

    # ------------------------------------------------------------- #
    # engine loop (one thread owns the session and the device)
    # ------------------------------------------------------------- #

    def _run(self, ready: threading.Event) -> None:
        stream_ctx = contextlib.nullcontext()
        if self.device.type == "cuda":
            if self.device.index is not None:
                torch.cuda.set_device(self.device)
            stream_ctx = torch.cuda.stream(torch.cuda.Stream(self.device))
        try:
            with stream_ctx, torch.no_grad():
                try:
                    generator = torch.Generator(device=self.device).manual_seed(self.seed)
                    self._sess = DecodeSession(self.params, self.config,
                                               generator=generator, **self._session_kw)
                except Exception as e:
                    self._die(e)
                    return
                finally:
                    ready.set()
                self._loop()
        except Exception as e:  # the loop's boundary: handed to the clients
            self._die(e)

    def _die(self, e: BaseException) -> None:
        """The loop thread failed: keep the exception for the clients, stop
        admitting, and end every open stream (pending and admitted)."""
        with self._cond:
            self._error = e
            self._running = False
            pending = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        for req in pending + [o for o in self._owner if o is not None]:
            req.out_q.put(None)

    def _loop(self):
        while True:
            with self._cond:
                while self._running and not self._pending and self._n_active == 0:
                    self._cond.wait(0.05)
                if not self._running and self._n_active == 0 and not self._pending:
                    break
                admits = []
                free_rows = [r for r in range(self.rows) if self._owner[r] is None]
                while free_rows and self._pending:
                    admits.append((free_rows.pop(0), self._pending.popleft()))
                self._n_active += len(admits)
            for r, req in admits:
                self._admit(r, req)
            self._reap_cancelled()
            if all(o is None for o in self._owner):
                continue
            self._sess.step()
            self._deliver()

    def _admit(self, r: int, req: ServingRequest):
        Tp = self.prompt_len
        n = int(req.tokens.size)
        pad_count = Tp - n
        toks_p = np.full(Tp, self.pad_token_id, np.int64)
        toks_p[pad_count:] = req.tokens
        mask = np.zeros(Tp, bool)
        mask[pad_count:] = True
        req.kelems = prompt_key(toks_p, mask)
        try:
            tok0 = self._sess.admit(
                r, toks_p, mask, req.request_id, budget=req.max_tokens,
                temperature=req.temperature, top_p=req.top_p,
                greedy=req.greedy, t_start=req.t_submit)
        except RuntimeError as e:
            if "radix pool exhausted" not in str(e):
                raise
            # pool sizing makes this unreachable (rows*nb live refs max,
            # the rest evictable) — shed rather than crash if it fires
            with self._cond:
                self._counters["shed"] += 1
                self._shed_reasons["pool"] = self._shed_reasons.get("pool", 0) + 1
                self._n_active -= 1
            req.out_q.put(None)
            return
        self._owner[r] = req
        with self._cond:
            self._counters["admitted"] += 1
        if tok0 is None:
            # chunked admission: the first token lands when the final chunk
            # installs the row; _deliver streams it from the carry
            return
        req.out_q.put(int(tok0))
        req.n_emitted = 1

    def _reap_cancelled(self):
        """Loop-thread only: free rows whose owner was cancelled (the
        session forces the done flag and releases the pages exactly as a
        completion would)."""
        for r in range(self.rows):
            req = self._owner[r]
            if req is None or not req.cancelled:
                continue
            self._sess.cancel_row(r)
            self._owner[r] = None
            req.out_q.put(None)
            with self._cond:
                self._counters["cancelled"] += 1
                self._n_active -= 1
                self._cond.notify_all()

    def _deliver(self):
        state = self._sess.state
        done_h = state["done"].cpu().numpy()
        out_h = state["out"].cpu().numpy()
        n_gen_h = state["n_gen"].cpu().numpy()
        pending = self._sess.pending_rows()
        for r in range(self.rows):
            req = self._owner[r]
            if req is None or r in pending:
                continue
            n = int(n_gen_h[r])
            for tok in out_h[r, req.n_emitted:n]:
                req.out_q.put(int(tok))
            req.n_emitted = n
            if done_h[r]:
                req.out_q.put(None)
                self._sess.release(r, gen_tokens=(out_h[r, :n] if self.spec_k > 0
                                                  else None))
                self._owner[r] = None
                with self._cond:
                    self._counters["completed"] += 1
                    self._n_active -= 1
                    self._cond.notify_all()

    # ------------------------------------------------------------- #
    # observability (any thread: host state only)
    # ------------------------------------------------------------- #

    def queue_depth(self) -> int:
        """Live pending-queue length."""
        with self._cond:
            return len(self._pending)

    def metrics(self) -> dict:
        """Flat scalar row for /metrics — the serving/* registry keys plus
        the pool's live shared-page gauge."""
        with self._cond:
            c = dict(self._counters)
            reasons = dict(self._shed_reasons)
            pending = len(self._pending)
            active = self._n_active
        snap = self._radix.snapshot()
        rows = {
            "serving/requests": c["requests"],
            "serving/admitted": c["admitted"],
            "serving/shed": c["shed"],
            "serving/completed": c["completed"],
            "serving/cancelled": c["cancelled"],
            "serving/pending": pending,
            "serving/active": active,
            "serving/prefix_hit_tokens": snap["hit_tokens"],
            "serving/prefix_hit_frac": snap["hit_frac"],
            "serving/cow_splits": snap["cow_splits"],
            "serving/evicted_pages": snap["evicted_pages"],
            "serving/prefill_token_dispatch": self._sess.dispatch_tokens,
            "pages/shared": snap["shared_pages"],
        }
        for reason, n in sorted(reasons.items()):
            rows[f'serving/shed_total{{reason="{reason}"}}'] = n
        return rows

    def snapshot(self) -> dict:
        """JSON-able /statusz section: engine shape + live occupancy + the
        radix tree's snapshot under `prefix_cache` + the decode session's
        row/backlog/feature view under `session`."""
        with self._cond:
            c = dict(self._counters)
            reasons = dict(self._shed_reasons)
            pending = len(self._pending)
            active = self._n_active
        return {
            "rows": self.rows,
            "active": active,
            "pending": pending,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "device": str(self.device),
            "counters": c,
            "shed_reasons": reasons,
            "prefill_token_dispatch": self._sess.dispatch_tokens,
            "slo": {"rule": "slo_ttft_p95", "warn_s": self._slo_warn,
                    "quantile": self._slo_q, "warmup": self._slo_warmup},
            "prefix_cache": self._radix.snapshot(),
            "session": self._sess.status(),
        }

    @property
    def radix(self) -> RadixCache:
        return self._radix

    @property
    def session(self) -> DecodeSession:
        return self._sess

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, drain active rows, shed the pending queue (each
        pending request's stream ends at the sentinel), join the loop
        thread. Idempotent."""
        with self._cond:
            if not self._running and self._thread is None:
                return
            self._running = False
            pending = list(self._pending)
            self._pending.clear()
            self._counters["shed"] += len(pending)
            self._shed_reasons["closed"] = (
                self._shed_reasons.get("closed", 0) + len(pending))
            self._cond.notify_all()
        for req in pending:
            req.out_q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
