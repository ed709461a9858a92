"""Multi-turn rollout driver over the port's paged `DecodeSession` — the
port of `nanorlhf_tpu/envs/rollout.py`, rewritten on torch.

One episode interleaves model turns and environment observations in a
single token stream:

    prompt | turn-1 tokens .. EOS | obs tokens | turn-2 tokens .. EOS | ...

Turn 1 is the existing `generate()` call, bit for bit — the whole batch
prefills and decodes exactly as the non-env pipeline does.

Continuation turns run on one `DecodeSession` in rollout mode with an
empty start (`empty_start=True`: every row done, every page free — JAX's
`ensure_carry`), built at the first continuation. When a row hits
EOS-of-turn its pages go back to the pool at once (`release`) and the turn
text goes to the environment on a tool thread; when the observation
arrives, the extended context — real prompt + prior turns + observation
tokens, left-padded to the fixed episode width — is admitted into a free
row (`admit`: the row's pages are allocated, one single-row paged prefill
writes its K/V through its block table — K1 on the card — and the first
token is drawn from the admission generator of `admit_index = episode ·
max_turns + turn`, so completion order never steers a row's first draw).
A slow tool therefore never holds pages, and `env/stalled_rows` counts the
driver's waits where decode sat fully idle on tool results. An admission
that cannot allocate raises (the session's RuntimeError); nothing drops an
episode.

Threads: the tool threads run only `env.step` (and the fault sites around
it) on the host; every device call — the tokenizer output's upload, the
admissions, the decode chunks, the reads of the carry — stays on the
calling thread.

Loss masking: observation tokens are environment actions, not policy
actions. The driver records every span and returns a per-token
`loss_mask` (False on observation tokens) plus per-turn reward / end
positions; the trainer joins the mask to the pad mask in the update and
attributes advantages per turn (`algos.advantages.per_turn_terminal_rewards`).

Fault sites: `env.hang` (default `action=delay` — the tool call stalls
`delay=S` seconds first) and `env.crash` (default raise — absorbed here as
an error-text observation, never a dead rollout) fire per tool dispatch
with `worker=<episode index>` scoping. A tool failure of any kind becomes
an error observation, as in JAX; no other exception is swallowed.

Not ported: JAX's `weight_refresh` (in-flight weight swaps; the trainer
refuses `rollout_inflight_swaps`).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
from nanorlhf_tpu_torch.sampler.sampler import generate


def _trim_turn(tok_row: np.ndarray, eos_token_id: int,
               pad_token_id: int) -> np.ndarray:
    """Real tokens of one generated turn: through the first EOS inclusive,
    else through the last non-pad token (budget exhausted without EOS)."""
    eos = np.nonzero(tok_row == eos_token_id)[0]
    if eos.size:
        return tok_row[: int(eos[0]) + 1]
    real = np.nonzero(tok_row != pad_token_id)[0]
    return tok_row[: int(real[-1]) + 1] if real.size else tok_row[:0]


@torch.no_grad()
def run_env_episodes(params, config, prompt_ids, prompt_mask,
                     generator: torch.Generator, sampling, env, *,
                     eos_token_id: int, pad_token_id: int, tokenizer,
                     max_turns: int, turn_tokens: int, obs_budget: int,
                     response_length: int, page_size: int, decode_rows: int,
                     lora_scale: float = 1.0, faults=None,
                     tool_threads: int = 4) -> dict:
    """Run one vectorized batch of multi-turn episodes ([B, Tp] left-padded
    `prompt_ids` / `prompt_mask` on the params' device; `sampling` with
    `max_tokens == turn_tokens`; `generator` draws turn 1's tokens, then the
    continuation session's decode, and its initial seed keys the
    admissions). Returns a payload of numpy arrays and host records:

    - `tokens`      [B·n, response_length] int64 — packed episode streams
    - `loss_mask`   [B·n, response_length] bool — False on observation tokens
    - `scores`      [B·n] float32 — per-episode total reward (Σ turns)
    - `turn_rewards` / `turn_ends` [B·n, max_turns] — per-turn credit inputs
      (`turn_ends` = final model-token position of each turn, −1 absent)
    - `turns`       per-turn lineage records (row, turn, tool_wall_s,
      obs_range, obs_tokens, reward, tok_range)
    - `stats`       the `env/*` metric rows
    - `pages_recycled` / `admissions` — the continuation loop's paged
      evidence."""
    if sampling.max_tokens != turn_tokens:
        raise ValueError(
            f"sampling.max_tokens={sampling.max_tokens} != "
            f"turn_tokens={turn_tokens}: the per-turn generation budget and "
            "the first-turn sampling params must agree")
    if sampling.capture_logprobs:
        raise ValueError(
            "multi-turn episodes recompute logprobs in the scoring pass "
            "(observation tokens have no sampler logprob) — capture off")
    B, Tp = prompt_ids.shape
    n = sampling.n
    rows_total = B * n
    P = int(page_size)

    # ---- turn 1: the existing pipeline, bit for bit ---------------------
    toks1 = generate(params, config, prompt_ids, prompt_mask, generator, sampling,
                     eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                     lora_scale=lora_scale).cpu().numpy()

    prompt_np = prompt_ids.cpu().numpy()
    pmask_np = prompt_mask.bool().cpu().numpy()
    prompt_rows = np.repeat(prompt_np, n, axis=0)
    pmask_rows = np.repeat(pmask_np, n, axis=0)
    pad_tok = getattr(tokenizer, "pad_token", "")
    prompt_texts = [t.replace(pad_tok, "") if pad_tok else t
                    for t in tokenizer.batch_decode(prompt_np)]
    prompt_texts = [t for t in prompt_texts for _ in range(n)]

    state = env.reset(prompt_texts)

    # per-episode records
    spans: list[list[tuple[str, np.ndarray]]] = [[] for _ in range(rows_total)]
    turn_walls: list[list[float]] = [[] for _ in range(rows_total)]
    turn_rewards = np.zeros((rows_total, max_turns), np.float32)
    cur_turn = [0] * rows_total
    completed = 0
    tool_wall_total = 0.0
    obs_tokens_total = 0
    stall_events = 0
    decode_chunks = 0
    overlap_chunks = 0
    pages_recycled = 0
    admissions = 0
    tool_errors = 0

    futures: dict = {}
    pending: deque = deque()

    def tool_step(ep: int, text: str):
        """One env.step on a tool thread; injected faults are absorbed —
        env.crash becomes an error observation, env.hang a pre-step stall."""
        t0 = time.perf_counter()
        try:
            if faults is not None:
                act = faults.fire("env.hang", worker=ep)
                if act and act.startswith("delay:"):
                    time.sleep(float(act.split(":", 1)[1]))
                faults.fire("env.crash", worker=ep)
            obs, rew, done = env.step(state, [text], indices=[ep])
            return obs[0], float(rew[0]), bool(done[0]), \
                time.perf_counter() - t0, False
        except Exception as e:  # noqa: BLE001 — a crashed tool, injected or
            # organic, must not kill the rollout: the error text IS the
            # observation and the episode keeps its remaining turns
            state.transcripts[ep] += text
            state.turn[ep] += 1
            obs = f" ```output {type(e).__name__}: {e} ``` "
            state.transcripts[ep] += obs
            return obs, 0.0, False, time.perf_counter() - t0, True

    # ---- continuation machinery (lazy: only when a turn 2 exists) -------
    Tp_ep = Tp + (max_turns - 1) * (turn_tokens + obs_budget)
    R = max(1, min(int(decode_rows) if decode_rows > 0 else rows_total, rows_total))
    sess: DecodeSession | None = None
    owner = [-1] * R

    def session() -> DecodeSession:
        nonlocal sess
        if sess is None:
            sess = DecodeSession(
                params, config, rows=R, prompt_len=Tp_ep, max_tokens=turn_tokens,
                page_size=P, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                generator=generator, temperature=sampling.temperature,
                top_p=sampling.top_p, greedy=sampling.greedy, top_k=sampling.top_k,
                approx_top_k=sampling.approx_top_k, lora_scale=lora_scale,
                sync_every=sampling.sync_every, decode_loop=sampling.decode_loop,
                empty_start=True)
        return sess

    def harvest(fut):
        """A tool result landed: either the episode ended (terminal reward)
        or its extended context joins the admission queue."""
        nonlocal completed, tool_wall_total, obs_tokens_total, tool_errors
        ep = futures.pop(fut)
        obs_text, reward, done, wall, err = fut.result()
        tool_errors += int(err)
        t = cur_turn[ep]
        turn_walls[ep].append(wall)
        tool_wall_total += wall
        turn_rewards[ep, t - 1] = reward
        if done or t >= max_turns:
            completed += 1
            return
        obs_toks = np.asarray(tokenizer.encode(obs_text), np.int64)[:obs_budget]
        spans[ep].append(("obs", obs_toks))
        obs_tokens_total += int(obs_toks.size)
        ctx = np.concatenate([prompt_rows[ep][pmask_rows[ep]]]
                             + [s for _, s in spans[ep]]).astype(np.int64)
        if ctx.size > Tp_ep:
            raise RuntimeError(f"episode {ep}: context of {ctx.size} tokens past "
                               f"the episode width {Tp_ep}")
        ids = np.full(Tp_ep, pad_token_id, np.int64)
        ids[Tp_ep - ctx.size:] = ctx
        mask = np.zeros(Tp_ep, bool)
        mask[Tp_ep - ctx.size:] = True
        pending.append((ep, ids, mask))

    pool = ThreadPoolExecutor(max_workers=max(1, tool_threads),
                              thread_name_prefix="rollout-env-tool")

    def finish_turn(ep: int, toks: np.ndarray):
        """EOS-of-turn: record the model span and hand the turn text to the
        environment on a tool thread (the row's pages are already released
        by the caller — a slow tool holds no pool capacity)."""
        spans[ep].append(("model", toks))
        cur_turn[ep] += 1
        futures[pool.submit(tool_step, ep, tokenizer.decode(toks))] = ep

    try:
        # turn 1 goes through the same EOS-of-turn path as every later turn
        for ep in range(rows_total):
            finish_turn(ep, _trim_turn(toks1[ep], eos_token_id, pad_token_id))

        while completed < rows_total:
            for fut in [f for f in list(futures) if f.done()]:
                harvest(fut)
            while pending and any(o < 0 for o in owner):
                r = owner.index(-1)
                ep, ids, mask = pending.popleft()
                # raises RuntimeError when the pool cannot hold the row
                session().admit(r, ids, mask, ep * max_turns + cur_turn[ep])
                owner[r] = ep
                admissions += 1
            if any(o >= 0 for o in owner):
                decode_chunks += 1
                if futures:
                    overlap_chunks += 1
                done_h = sess.step()
                finished = [r for r in range(R) if owner[r] >= 0 and done_h[r]]
                if finished:
                    # a copy: on the CPU `.numpy()` shares the live buffer,
                    # which the next admission into the row overwrites
                    out_h = sess.state["out"].cpu().numpy().copy()
                    n_gen_h = sess.state["n_gen"].cpu().numpy()
                for r in finished:
                    ep = owner[r]
                    owner[r] = -1
                    # pages back to the pool BEFORE the tool runs: a stalled
                    # episode holds zero KV capacity
                    pages_recycled += sess.release(r)
                    finish_turn(ep, _trim_turn(out_h[r][:int(n_gen_h[r])],
                                               eos_token_id, pad_token_id))
            elif futures:
                # decode fully idle on tool results — the stalled-rows signal
                stall_events += 1
                wait(list(futures), timeout=0.2, return_when=FIRST_COMPLETED)
            elif not pending:
                break
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    # ---- pack episodes + per-token loss mask ----------------------------
    out = np.full((rows_total, response_length), pad_token_id, np.int64)
    loss_mask = np.ones((rows_total, response_length), bool)
    turn_ends = np.full((rows_total, max_turns), -1, np.int64)
    turns_records: list[dict] = []
    for ep in range(rows_total):
        cur, t_idx = 0, 0
        rec_by_turn: list[dict] = []
        for kind, toks in spans[ep]:
            L = min(int(toks.size), response_length - cur)
            out[ep, cur:cur + L] = toks[:L]
            if kind == "model":
                turn_ends[ep, t_idx] = cur + L - 1
                rec_by_turn.append({
                    "row": ep, "turn": t_idx + 1,
                    "tok_range": [cur, cur + L],
                    "reward": round(float(turn_rewards[ep, t_idx]), 6),
                    "tool_wall_s": round(turn_walls[ep][t_idx], 6)
                    if t_idx < len(turn_walls[ep]) else None,
                    "obs_range": None, "obs_tokens": 0,
                })
                t_idx += 1
            else:
                loss_mask[ep, cur:cur + L] = False
                rec_by_turn[-1]["obs_range"] = [cur, cur + L]
                rec_by_turn[-1]["obs_tokens"] = L
            cur += L
        turns_records.extend(rec_by_turn)

    turns_count = np.asarray(cur_turn, np.float32)
    stats = {
        "env/turns_per_episode": float(turns_count.mean()),
        "env/tool_wall_s": round(tool_wall_total, 6),
        "env/obs_tokens": float(obs_tokens_total),
        "env/stalled_rows": float(stall_events),
        "env/tool_stall_overlap": (overlap_chunks / decode_chunks
                                   if decode_chunks else 0.0),
        "env/tool_errors": float(tool_errors),
    }
    return {
        "tokens": out,
        "loss_mask": loss_mask,
        "scores": turn_rewards.sum(axis=1).astype(np.float32),
        "turn_rewards": turn_rewards,
        "turn_ends": turn_ends,
        "turns": turns_records,
        "stats": stats,
        "pages_recycled": pages_recycled,
        "admissions": admissions,
    }
