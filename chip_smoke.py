#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nanorlhf_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py                 # the whole contract
    python3 chip_smoke.py --max-tokens 64 # a shorter end-to-end rollout
    python3 chip_smoke.py --holds K1      # build one source, run only K1's
                                          # (or K4's, K6's, K10's) phase-2 holds
    python3 chip_smoke.py --plant-faults  # each fault of FAULTS in a copy of
                                          # the port must fail its hold
    python3 chip_smoke.py --graph-loops   # build, then only phase 8 and the
                                          # eager-vs-replay decode profile
    python3 chip_smoke.py --algos         # build, then only phase 9 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --io            # build, then only phase 10 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --r1            # build, then only phase 11 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --routes        # build, then only phase 12 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --host          # build, then only phase 13 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --serve         # build, then only phase 14 (and the
                                          # holds at its shapes)
    python3 chip_smoke.py --envs          # build, then only phases 15 and 16
                                          # (and the holds at their shapes)
    python3 chip_smoke.py --learn         # build, then only the learning-curve
                                          # harness (not in the default run)

Phases (any failure exits non-zero):
  1. build — compile the Hopper kernels from nanorlhf_tpu_torch/csrc (one
     nvcc per source, all at once) and load them;
  2. kernel checks — each kernel against its plain PyTorch version on the
     card, in bf16 (int8 for the int8 cache), at the shapes the rollout and
     the update give it, with the stated tolerance; the flash forward (K1)
     at the scoring shape of the full response and the shapes phase 4 gives
     it, also per 64-row query tile; the decode kernel (K4) at 16 and 64 rows
     and T_max = prompt + 1500 and + 512, per element within one bf16 ulp,
     its split count equal to `decode_split_count`; the paged kernels (K7,
     K8, K9) on pages scattered through a pool with spare pages and a
     sentinel block, each equal bit for bit to its contiguous twin (K4, K5,
     K6) on the same logical cache; the verify kernels (K6, K9) at the
     shapes phase 7 gives them (Tq = 5 candidates; K6 at B = 64 rows, K9 at
     32), held per element within one bf16 ulp of the f32 result, with
     candidate blocks straddling tiles and pages, K6 at Tq = 1 against K4,
     their split count equal to `verify_split_count`, and off those shapes
     (64 rows in two row groups, one row, head_dim 64, the key range in one
     split, in three and in eight); the fused hidden→logprob kernel (K10)
     per row within FUSED_TOL of its f32 plain version at the shapes
     phases 4 and 7a give it (D = 1536, V = 151936, tied weight: the
     scoring pass at R = 16 × response, the update's microbatch with
     entropy at R = 4 × response), the [D, V] layout and a ragged edge,
     its split count equal to `fused_logprob_split_count`; the flash backward (K2, K3) at the
     shapes phases 4 and 7a give it (B=4, T = prompt + 512 and prompt +
     1500), held at 1e-2 · max|g| and per 64-row tile relative to the
     tile's norm, two launches equal bit for bit, and off those shapes (head_dim
     64, G 4 and 7, non-causal, ragged T, T under one tile, B=1 at the
     largest dK/dV split, key tiles cut into several parts, held against
     the split's plain version too); then the kernel's time, its plain
     version's time,
     one library call's time as a yardstick (for the paged and int8 cache,
     where no single call exists: SDPA over a pre-gathered / pre-dequantized
     view, "not one call"; for K10 matmul + logsumexp + gather, + Σ
     softmax·z for the update's entropy variant, timed too), and the bound
     (the least time the card could take: bytes / 3.35 TB/s or flops / 989
     TFLOP/s);
  3. rollout and score — the rollout-and-score half of one GRPO update
     through the launcher's own config (`entrypoints/grpo.build_config`) at
     the full Qwen2.5-1.5B width (random weights from the seed), 4 synthetic
     prompts × 4 samples (1 kept per prompt and scored), with the kernels'
     launch counters read around it, then the results checked: finite
     logprobs of the expected shape, policy == ref at the zero-init LoRA,
     and — on a small input (2 layers at full width, teacher-forced
     prefill/decode, then scoring) — the kernel route no less accurate than
     the plain route against the plain route in f32. Last, a profile of one
     chunk of the decode loop's body (device busy vs wall, launches a step),
     run eagerly with a host check a step and as a CUDA-graph replay. Every
     decode loop of phases 3–7 runs as the rollout does by default: CUDA-graph
     replays of `sync_every` iterations after an eager first chunk, so a
     decode kernel's launches are L × graph_steps_run (a chunk's
     predicated-off tail included);
  4. one GRPO update — `entrypoints/common.build_trainer` +
     `RLTrainer.train(num_updates=1)` on the launcher's config with the
     one-card cut (`entrypoints/grpo.one_card_cut`: 16 prompts × 4 samples,
     2 optimizer steps of 2 microbatches of 4 rows), with the launch counts
     of the update half checked, then: finite loss and grad norm > 0, LoRA B
     moved, frozen base and ref unchanged, the first minibatch's approxkl
     (new vs old logprobs from the same kernels) small, the checkpoint
     written and reloading to the same tensors; and, on a small input, the
     LoRA gradients through the kernels no less accurate than the plain
     bf16 route against the plain route in f32; K10's device time in the
     update (each shape it was given, timed on the profiler, times its
     calls). Phases 3 and 4 run
     responses of at most 512 tokens (a cut, printed), so that the whole
     script stays within half its time limit;
  5. one GRPO update over continuous batching — the same, with
     rollout_page_size=128 and rollout_decode_rows=32 (32 of the 64 rows
     resident, the rest admitted mid-loop into recycled pages), at most
     512 tokens (a cut, printed): K7 launched once per layer and iteration
     of the session's chunks, K4 never, one flash forward per layer for the bootstrap
     prefill and each admission; the pool statistics and metrics rows; then, at full
     width on the 2-layer model, a queue whose rows stop at staggered
     lengths: the queued greedy rows against the contiguous ones, in fewer
     decode iterations than the fixed-batch schedule;
  6. the int8 KV cache — `run_rollout` with kv_cache_quant="int8",
     contiguous (K5) and paged + queued (K8), 4 prompts × 4 samples of at
     most 512 tokens (a cut), with their launch counts, decode ms per step
     and cache bytes per row; on the 2-layer input, the int8 routes' decode
     logits against the exact route in f32 beside the exact bf16 route's;
  7. speculative decode (rollout_spec_k=4) — (a) one GRPO update over the
     contiguous cache at the full response length (K6 once per layer and
     verify step, K4 never; the rollout/* speculative rows; ms per verify
     step and emitted tokens/s); (b) a queued paged rollout, page size 128,
     32 resident rows, 16 prompts × 4 samples of at most 512 tokens (K9 once
     per layer and iteration, K7 never); (c) on a 2-layer full-width model
     built to repeat a 4-token cycle, speculative greedy streams (K6 and
     K9) equal to the monolithic ones in at most half the forwards, with
     acceptance above one half, and on the random 2-layer model the first
     difference of any speculative greedy row from its monolithic row with
     the top-2 logit margin there; (d) a short int8 + speculative rollout.
     The verify shapes (a) and (b) gave the kernels, the flash backward
     shapes of phase 4's and (a)'s updates and the flash forward shapes of
     phase 4 are recorded and must be those phase 2 held and timed;
  8. the compiled decode loop — each loop (contiguous, paged, int8, int8
     paged, speculative on both layouts, queued and queued speculative) at
     16 rows on the full-depth model, greedy, run by the per-step body and
     by graph replay: tokens and counters equal row for row, the loop
     kernel's launches L × graph_steps_run with L × sync_every × replays
     from replays; sampled streams from one seed compared (printed);
  9. the other five algorithms — one update each of RLOO, ReMax,
     REINFORCE, RAFT and PPO (with its value init) on its launcher's config;
 10. checkpoints and data in and out, full depth — (a) a random bf16 HF
     directory (two shards, ~3.1 GB) written by the port's safetensors
     writer and loaded onto the card bit for bit (seconds, GB/s); (b) two
     GRPO updates with async saves (each save's blocking seconds, the
     writer's seconds, update 2's decode ms a step with the writer in
     flight) and one synchronous save of the same tree, which every async
     save must block less than; (c) an injected write failure: nothing
     committed, absorbed by the next save, retry_count up; (d) a fresh
     trainer resumed from step 1 trains update 2 to the same tokens and
     leaves bit for bit (and times the decode without a writer); (e) LoRA
     B drawn non-zero, `export_model` in bf16, reloaded: the merged
     model's response logprobs within EXPORT_FACTOR of the unmerged
     policy's error against the f32 plain route; (f) `make_rm_reward` over
     a value tree, finite and deterministic; (g) the decode-step cost of a
     write in flight: one fixed rollout timed with no write, with the
     checkpoint writer, and with plain file writes of the same staged
     tree, in turns. The kernels the two updates
     launched are held at the shapes they gave them that phase 2 did not;
 11. sparse GRPO and the R1-Zero launcher at 8,000-token responses —
     `grpo_r1.build_trainer` at `r1_card_cut`, then `train` (`grpo_r1.
     main`'s two steps with `--r1`; 8 prompts x 4 samples, Qwen2-1.5B
     geometry at full depth, random weights, the synthetic arithmetic
     corpus): the greedy accuracy eval (16 questions, 1,024 tokens) before
     training and after each of two updates. The full script cuts the
     phase to keep inside its time limit: one update of the model's first
     R1_CUT_LAYERS layers, no eval (widths, lengths and the kernels'
     shapes stay the launcher's). (a) each rollout graded by the
     launcher's binary reward (how many correct, whether the sparse filter
     would skip), then trained on a planted, seeded reward that keeps 7 of
     the 8 rows: kept rows, scoring and backward buckets, K2/K3 and K10
     launched by each update, a finite loss, the checkpoints committed, the
     forked grader run from this process while a checkpoint write is in
     flight; rollout, decode ms a step and tokens/s, reward, scoring,
     update and checkpoint seconds, peak memory; (b) 8 rows ending at
     lengths spread over 200-8,000 tokens: the bucketed logprobs and the sum
     of the scaled bucket gradients against one pass over all rows
     (R1_LOGPROB_TOL, R1_GRAD_TOL), a bucket padded with all-pad rows
     against itself unpadded (R1_GRAD_TOL), and the witnesses that bound
     R1_GRAD_TOL: each bucket against its term of one pass, the unpadded
     bucket twice, two planted faults. The shapes phase 11 gave K1,
     K2/K3, K4 and K10 (known only after the run: EOS and the kept rows
     decide them) are then held against the plain versions as in phase 2,
     the plain attention by batch rows where its scores would pass
     PLAIN_SCORE_BYTES, and reported in the kernels line under `r1`;
 12. the update's and the rollout's other routes, on phase 4's config
     (one-card cut, 512 tokens), one GRPO update each through
     `build_trainer` + `train(num_updates=1)` from the same seeded state:
     (a) remat_policy "full" against "dots" — update seconds, peak GB,
     K1/K2/K3/K10 launches (equal), the trained LoRA leaves, and at one
     microbatch the LoRA gradients (bit for bit, else within R1_GRAD_TOL)
     and the peak above resting memory of each policy; (b) the naive
     update branch (fused_logprob=False) — K10 launched neither in scoring
     nor in the update, the fused and the naive logprobs of one microbatch
     against the f32 logprobs of the same hidden states (the fused within
     FUSED_TOL, the naive within its bf16 logits' rounding), then phase
     11's fixed 8k batch on the sparse trainer: the 8,021-token bucket's
     gradients naive against fused (R1_GRAD_TOL), seconds and peak; (c)
     int8 rollout weights — phase 3's rollout (4 prompts x 4 samples) with
     bf16 and with int8 weights in turns (decode ms a step, tokens/s, peak
     GB, the int8 bytes, K4's launches equal), the 2-layer small input's
     decode logits (int8 within INT8_WEIGHT_FACTOR of the exact bf16
     route's error against f32, and within 2x of it against f32 over its
     own dequantized weights), one update with int8 weights whose scoring
     equals the exact weights' bit for bit. The shapes phase 12 gave the
     kernels that no earlier phase held are then held as in phase 2, and
     each kernel's launches in each route's update are reported in the
     kernels line under `routes`;
 13. the host planes on the GRPO main path, on phase 4's config with
     telemetry, lineage, an ephemeral status port, a profile window at
     update 3, a checkpoint every update and `update.step:at=2,action=nan`
     (health, latency, the sentinel, graceful preemption and reward
     retries at their defaults), three updates: (a) one rollback,
     quarantine {1}, checkpoint 3 the latest, `blackbox_2.json` a sentinel
     trip; (b) `trace.json` valid, three `train.update` spans and one
     tagged quarantined, the ckpt, reward and phase spans; (c) the lineage
     chains of rollouts 0, 2, 3 closed by `outcome`, rollout 1's by a
     `sentinel_quarantine` drop; (d) /metrics, /healthz, /statusz over
     loopback while the run is live; (e) the profile window's Chrome trace
     names K1, K2, K3 and K10's device kernels (and whether K4's replayed
     launches show); (f) `perf/mfu` in (0, 1) with the peak known, the
     rows' keys HOST_ROW_KEYS; (g) the traced speculative rollout (16
     rows, greedy, 64 tokens) equal to the graph loop, a draft/verify
     span pair an iteration; (h) one TTFT record per admitted row of a
     queued rollout at phase 5's config; (i) SIGTERM to a child running
     phase 4's trainer (save_steps=0) during update 2's reward: `Preempted`
     and checkpoint 2 committed, which a fresh trainer resumes; then that
     trainer (every plane off) and the phase's (every plane on) train in
     turns (two a side with `--host`, one in the full script, a cut):
     update seconds and decode ms a step, and the phase's wall. The
     shapes phase 13 gave the kernels that no earlier phase held are held
     as in phase 2, and its launches reported under `host`;
 14. serving, on the launcher's model (Qwen2.5-1.5B geometry, 28 layers,
     random weights from SERVE_SEED): the engine's session holds 32 rows,
     prompts left-padded to 512, 256 new tokens, pages of 128. (b) Two
     300-token prompts sharing 200 through a per-row session with the radix
     cache: the second's first logits (a mid-page hit, its page copied on
     write, K9 over the unmatched tail) against the f32 plain full prefill,
     within SUFFIX_FACTOR of the bf16 full prefill's error, and both greedy
     streams against the monolithic paged sampler's. (c) The serving engine
     behind its gateway on 127.0.0.1, driven over HTTP by the traffic driver
     (SERVE_TRAFFIC: 64 Poisson arrivals, 16-480 real tokens, 4 tenants of
     a 384-token prefix, half greedy, the sampled half at the launcher's
     temperature and top-p): every request completes, the cache saves
     prefill tokens and shares pages, /metrics, /healthz and /statusz
     answer; client and engine TTFT, inter-token gaps, tokens/s, prefill
     tokens saved and K7/K9 launches printed; each greedy stream against
     the rollout scheduler's greedy row for its prompt; the same traffic
     with prefill_chunk=128, and the greedy requests through an engine with
     spec_k=4, each greedy stream against the first engine's. A stream may
     differ only from a near tie on (twice (b)'s suffix-vs-full logit
     difference; each difference printed with its top-2 margin). (d) One
     GRPO update with rollout_prefix_cache=True and rollout_prefill_chunk=128
     on phase 5's config: finite rows, the session/* and prefix rows, the
     trainer's /statusz prefix_cache snapshot. (a) K9 held as in phase 2 at
     Tq 16, 128, 512 and every shape phase 14 gave it (one row: a mid-page
     hit and a cold suffix; the spec engine's 32 rows), timed at the
     engine's, and K7 at the engine's decode shape; the launches and times
     reported under `serve`.
 15. multi-turn GRPO over the python-tool environment:
     `one_card_cut(build_config(env_name="python_tool", env_max_turns=2))`
     at 512 tokens (the launcher's rule: turns of 128 tokens, observations
     of at most 256, pages of 128, all 64 episodes resident), 28 layers,
     random weights, no checkpoint. Random weights never write a fenced
     ```python block, so the tool call is planted through PythonToolEnv's
     own `extractor` (ENV_PROGRAM for every turn); the pooled executor runs
     it in its spawned child, and its stdout is the observation. (a) One
     update through `build_trainer` + `train(num_updates=1)`: every
     episode two turns (64 admissions, pages recycled), the loss mask
     False exactly on the observation spans (and in the kept batch), the
     scores the turn rewards' sums, the gradients finite and non-zero, LoRA
     B moved; K1 launched once a layer for each continuation's single-row
     paged prefill; rollout, tool, scoring and update seconds and the peak.
     (b) One more update with ENV_FAULTS injected: the crash one
     env/tool_errors; the hung call's window (its fire to the end of its
     delay) holds session beats and admissions: the other episodes went on
     while it stalled. (c) Two greedy episode runs (the driver called
     directly), tools answered at once and every other one delayed
     (ENV_DELAY): streams, masks and turn ends equal. The near-tie
     allowance is measured on the routes (c) holds, with LoRA at the
     trainer's scale: turn 1's `generate` on one prompt and an empty-start
     session's continuation (K1 single-row paged prefill, then K7 steps)
     on that episode's turn-2 context, eagerly with each step's logits
     kept, against the full forward (K1) and the f32 plain full forward
     (each route within ENV_ROUTE_FACTOR x the bf16 full forward's error
     of f32, and within ENV_ROUTE_SHARE of it from K1, which a continuation
     admitted without its observation must exceed; the allowance
     NEAR_TIE_FACTOR x twice the routes' largest difference from K1). Every turn of every 16th episode (and of any
     episode that parted) is held against the full forward's argmax
     within it. The shapes phase 15 gave K1, K2/K3 and K10 that no
     earlier phase held are held as in phase 2, K7 at the session's decode
     shape (64 rows); launches reported under `envs`;
 16. the chaos harness's serving soak (`chaos.soak_serving`) at JAX's
     sizes — 24 requests at 40/s (time scale 0.02) through an engine of 2
     rows, pages of 4, 12-token prompts, 8 new tokens, under the composed
     seed-3 plan of three gw.disconnect waves — on the launcher's geometry
     (random weights from SOAK_SEED: the kernels take bf16 at head_dim 64
     or 128): every auditor passes, `tools/inspect_run.py --chaos` rebuilds
     the run's verdicts and fires from the port's ledger; K9 held at every
     suffix shape the soak gave it, K7 at the engine's decode shape;
     launches under `envs`.

`--learn` runs `entrypoints/learning_run.main` on the card (LEARN_KNOBS:
Qwen2-1.5B geometry at the toy 512 vocab, 30 shaped updates, then 10
binary ones) and prints its artifact: the reward series, each phase's
stepped and skipped updates and seconds.

Prints the card's name and power limit, a `kernels` JSON line, and as the
last line `{"ok": true, "device": {...}}`. Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import heapq
import json
import math
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s, H100 SXM


_T0 = time.perf_counter()


def log(msg: str) -> None:
    # a phase's first line carries the script's elapsed seconds
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, match: str, tries: int = 3) -> dict[str, float]:
    """Device time per call of `fn`'s kernels whose name holds `match`, by
    kernel (torch.profiler over `iters` calls after a warm-up): the card's
    own time, without the host's launch and wrapper overhead. The profiler
    can come back without some of the kernels' device records. Where each
    kernel was recorded fewer times than `fn` ran (after the GRPO update the
    profiler keeps one or two launches of three), the time per call is the mean of
    the launches it kept: every caller's kernels launch once a call. A
    session with no record, or a count it cannot read so, is run again, up
    to `tries` sessions, and {} means not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == cuda and match in e.key and e.self_device_time_total > 0]
        if found and all(e.count % iters == 0 for e in found):
            return {e.key: e.self_device_time_total / iters / 1e3 for e in found}
        if found and all(e.count < iters for e in found):
            log(f"  the profiler kept {[e.count for e in found]} of {iters} launches of "
                f"{match!r}: device time from the launches it kept")
            return {e.key: e.self_device_time_total / e.count / 1e3 for e in found}
        log(f"  a profiler session recorded {[(e.key, e.count) for e in found]} for "
            f"{match!r} over {iters} calls")
    log(f"  the profiler recorded no device time it could read for {match!r} in {tries} "
        f"sessions: device time not measured")
    return {}


def dev_total(parts: dict[str, float]) -> float | None:
    """The sum of `device_ms`'s kernels, None where it measured nothing."""
    return sum(parts.values()) if parts else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_flops = nbytes / H100_HBM_BYTES, flops / H100_BF16_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def max_abs(torch, a, b, rows=None) -> float:
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
#
# Each kernel takes bf16 inputs and computes in f32 (rounding only where its
# source says so), so it is held against its plain version evaluated in f32
# on the same bf16-valued inputs (f32 matmuls run in full f32: TF32 is off
# by default for them). The plain version run in bf16 rounds scores or
# logits to bf16; its error against the same f32 result is printed beside
# the kernel's for scale.
# --------------------------------------------------------------------------

def hold(torch, what: str, pairs, tol: float) -> float:
    """pairs: (label, kernel out, plain-f32 out, plain-bf16 out, rows or
    None). Fails unless every kernel output is finite and within `tol` of
    the f32 plain output; returns the largest kernel error."""
    worst = 0.0
    parts = []
    for label, got, want, bf16, rows in pairs:
        if not torch.isfinite(got.float()).all():
            fail(f"{what}: non-finite {label}")
        err = max_abs(torch, got, want, rows)
        parts.append(f"{label} {err:.3e} (plain bf16 {max_abs(torch, bf16, want, rows):.3e})")
        worst = max(worst, err)
    log(f"  {what}: max|kernel - plain f32|: {', '.join(parts)}; tol {tol}")
    if worst > tol:
        fail(f"{what}: kernel disagrees with its plain version")
    return worst


# The flash backward per 64-row tile (a dK/dV key tile, the unit the split
# cuts into parts; a dQ query tile): ||kernel − plain f32|| / ||plain f32||
# over the tile. Sound tiles read 2.2e-3 to 3.2e-3 on an H100 (the bf16
# rounding of the outputs, and of P and dS for their products: medians
# 2.3e-3 at every shape and edge); dropping one (g, query tile) step of a
# part or one part in the reduce, or scaling half a tile's rows by
# 1 + 1/128, takes its tile past TILE_TOL (PERF.md §6).
TILE_TOL = 5e-3


def tile_errors(torch, got, want, rows: int = 64):
    """[B, heads, n_tiles] relative errors of [B, heads, T, d] tensors over
    tiles of `rows` along T; a tile whose plain value is all zeros must
    come out all zeros."""
    B, heads, T, _ = want.shape
    n = -(-T // rows)

    def sq(x):
        x = x.float().pow(2).sum(-1)
        return torch.nn.functional.pad(x, (0, n * rows - T)).reshape(B, heads, n, rows).sum(-1)

    return (sq(got.float() - want.float()) / sq(want).clamp(min=1e-30)).sqrt()


def hold_tiles(torch, what: str, pairs, tol: float = TILE_TOL) -> float:
    """pairs: (label, kernel out, plain-f32 out, plain-bf16 out). Fails
    unless every 64-row tile of every kernel output is within `tol` of the
    plain f32 tile, relative to that tile's norm; returns the largest."""
    worst, parts = 0.0, []
    for label, got, want, bf16 in pairs:
        e, eb = tile_errors(torch, got, want), tile_errors(torch, bf16, want)
        at = [int(i) for i in divmod(int(e.argmax()), e.shape[-1])]
        parts.append(f"{label} max {float(e.max()):.3e} (at head row {at[0]}, tile "
                     f"{at[1]}), median {float(e.median()):.3e} (plain bf16 max "
                     f"{float(eb.max()):.3e})")
        worst = max(worst, float(e.max()))
    log(f"  {what}: per 64-row tile, ||kernel - plain f32|| / ||plain f32||: "
        f"{', '.join(parts)}; tol {tol}")
    if worst > tol:
        fail(f"{what}: a tile of the kernel's output disagrees with its plain version")
    return worst


def _f32(*ts):
    return tuple(t.float() for t in ts)


# a plain attention call materialises [rows, H, T, T] scores; at the 8k
# shapes of phase 11 (B=8, T=8021: 25 GB in f32) the plain versions run a
# few batch rows at a time so that their scores stay under this size
PLAIN_SCORE_BYTES = 8e9


def plain_rows(B: int, H: int, T: int) -> int:
    """Batch rows a plain attention call takes at once: all of them unless
    their f32 scores would pass PLAIN_SCORE_BYTES."""
    return max(1, min(B, int(PLAIN_SCORE_BYTES // (4 * H * T * T))))


def by_rows(torch, fn, rows: int, *args):
    """`fn` over chunks of `rows` batch rows of its tensor arguments (dim 0),
    the outputs concatenated (a tuple output piece by piece)."""
    B = args[0].shape[0]
    outs = [fn(*(a[i:i + rows] for a in args)) for i in range(0, B, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def sdpa_ms(torch, F, q, k, v, mask, iters: int) -> tuple[float, str]:
    """SDPA with a boolean mask, timed as one call; where that call runs out
    of device memory (the math backend's [B, H, T, T] scores at 8k), by
    rows as the plain versions are, and said so."""
    try:
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), iters), "SDPA"
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        rows = plain_rows(*q.shape[:3])
        return time_ms(torch, lambda: by_rows(
            torch, lambda a, b, c, m: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m, enable_gqa=True), rows, q, k, v, mask), iters), \
            f"SDPA by {rows} rows (one call ran out of memory)"


def check_flash(torch, F, shapes) -> dict:
    """K1 at each shape in `shapes` (B, H, KV, T, hd): the scoring shape of
    the full response (B=16, T = prompt + 1500, the kernels line) and the
    shapes phase 4 gives it (the prefill at the prompt width, the scoring
    and the update batches at prompt + 512), causal and left-padded. Held
    against the plain version in f32: out within 2e-2 (the kernel rounds P
    to bf16 for P·V and writes bf16, ≤ ~1 bf16 ulp of |out| < 4), lse
    within 1e-3 (f32 throughout), and out per 64-row query tile within
    TILE_TOL of the tile's norm (`hold_tiles`; a padding query row, all
    keys masked, is free and left out); two launches equal bit for bit.
    Timed (events over 10 launches, the wrapper included), device time
    (profiler), the plain version and SDPA with a boolean mask. Returns
    {shape: result}."""
    from nanorlhf_tpu_torch.ops.attention import (
        flash_attention_forward, flash_attention_reference)

    tol_out, tol_lse = 2e-2, 1e-3
    results = {}
    for B, H, KV, T, hd in shapes:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        # left padding as the rollout has it, one row unpadded
        pad = torch.randint(0, max(1, min(T, 10) // 2), (B,), generator=gen, device="cuda")
        pad[0] = 0
        valid = torch.arange(T, device="cuda")[None, :] >= pad[:, None]
        out, lse = flash_attention_forward(q, k, v, valid, causal=True)
        rows_at = plain_rows(B, H, T)

        def plain_fn(*a):
            return flash_attention_reference(*a, causal=True)

        ref_out, ref_lse = by_rows(torch, plain_fn, rows_at, *_f32(q, k, v), valid)
        b_out, b_lse = by_rows(torch, plain_fn, rows_at, q, k, v, valid)
        rows = valid[:, None, :].expand(B, H, T)  # padding query rows are free
        what = f"flash_fwd B={B} H={H} KV={KV} T={T} hd={hd} causal"
        keep = rows[..., None]
        hold_tiles(torch, what, [("out", torch.where(keep, out, ref_out.to(out.dtype)), ref_out,
                                  torch.where(keep, b_out, ref_out.to(b_out.dtype)))])
        worst = max(hold(torch, what, [("out", out, ref_out, b_out, rows)], tol_out),
                    hold(torch, what, [("lse", lse, ref_lse, b_lse, rows)], tol_lse))
        out2, lse2 = flash_attention_forward(q, k, v, valid, causal=True)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            fail(f"{what}: two launches on the same inputs differ")
        ms = time_ms(torch, lambda: flash_attention_forward(q, k, v, valid), 10)
        on_card = dev_total(device_ms(
            torch, lambda: flash_attention_forward(q, k, v, valid), 10, "flash_fwd"))
        plain = time_ms(torch, lambda: by_rows(torch, plain_fn, rows_at, q, k, v, valid), 3)
        mask = (valid[:, None, None, :]
                & torch.ones((T, T), dtype=torch.bool, device="cuda").tril())
        lib, lib_how = sdpa_ms(torch, F, q, k, v, mask, 5)
        del mask
        nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + valid.numel()
                  + 2 * q.numel() + 4 * lse.numel())
        flops = 4.0 * B * H * hd * T * (T + 1) / 2  # causal pairs only
        bms, by = bound_ms(nbytes, flops)
        # the rate and the share of the bound from device time, from events
        # where the profiler measured none
        t, of = (on_card, "device time") if on_card else (ms, "events")
        log(f"  {what}: kernel {ms:.4f} ms, device time (profiler) {fmt_ms(on_card)} "
            f"({flops / t / 1e9:.1f} TFLOP/s, {bms / t:.3f} of the bound {bms:.4f} ms "
            f"{by}, by {of}); plain {plain:.4f} ms{'' if rows_at == B else f' (by {rows_at} rows)'}; "
            f"{lib_how} {lib:.4f} ms (kernel / SDPA {ms / lib:.3f}); two launches equal bit "
            f"for bit")
        results[(B, H, KV, T, hd)] = dict(
            ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib, bound_ms=bms,
            bound_by=by, max_abs_err=worst, shape=f"B={B} H={H} KV={KV} T={T} hd={hd}")
    return results


@contextlib.contextmanager
def recording_forward_shapes(seen):
    """Count, by shape, the calls of the flash forward wrapper (the autograd
    function's forward and the model's no-grad passes go through it; the
    wrapper, and its launch count, run unchanged)."""
    from nanorlhf_tpu_torch.ops import attention

    fwd = attention.flash_attention_forward

    def rec(q, k, v, key_valid, causal=True):
        seen[(*q.shape[:2], k.shape[1], *q.shape[2:])] += 1
        return fwd(q, k, v, key_valid, causal)

    attention.flash_attention_forward = rec
    try:
        yield
    finally:
        attention.flash_attention_forward = fwd


def _makespan(blocks, slots: int) -> int:
    """Steps of the busiest of `slots` resident blocks when the schedule's
    blocks are handed out in order, each to the least loaded slot."""
    load = [0] * slots
    for r in blocks:
        heapq.heapreplace(load, load[0] + r[4] - r[3])
    return max(load)


def check_flash_bwd(torch, F, shapes) -> dict:
    """K2/K3 at each backward shape the update paths give them (phases 4
    and 7a record theirs: B=4 microbatch rows, T = prompt width +
    response, causal, left-padded); held against the plain backward in f32
    on the same bf16 inputs and residuals (out, lse from the forward
    kernel): each gradient within 1e-2 · max|g| (dS and P round to bf16 for
    their products, the outputs to bf16), and each 64-row tile within
    TILE_TOL of its own norm (`hold_tiles`). The plain bf16 route (autograd
    through `reference_attention` in bf16) is printed beside it. Two
    launches on the same inputs must give the same bits. Each kernel is
    timed over 20 launches beside the plain backward and the SDPA backward
    of the same call. Returns the kernels' results by T."""
    from nanorlhf_tpu_torch.ops.attention import (
        DKV_MAX_SPLITS, blocks_per_sm, dkv_balance, dkv_schedule, dkv_split,
        flash_attention_backward_reference, flash_attention_forward,
        flash_bwd_dkv, flash_bwd_dq, reference_attention)

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for B, H, KV, T, hd in sorted(shapes, key=lambda s: s[3]):
        gen = torch.Generator(device="cuda").manual_seed(5)
        q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        pad = torch.randint(0, 5, (B,), generator=gen, device="cuda")
        pad[0] = 0
        valid = torch.arange(T, device="cuda")[None, :] >= pad[:, None]
        out, lse = flash_attention_forward(q, k, v, valid, causal=True)
        # left-pad query rows carry no cotangent on the training path
        do = (torch.randn((B, H, T, hd), generator=gen, device="cuda")
              * valid[:, None, :, None]).to(torch.bfloat16)
        dq, delta = flash_bwd_dq(q, k, v, valid, out, lse, do)
        dk, dv = flash_bwd_dkv(q, k, v, valid, lse, delta, do)
        want = flash_attention_backward_reference(*_f32(q, k, v), valid, out.float(),
                                                  lse, do.float())
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(reference_attention(*leaves, valid), leaves, do)
        hold_tiles(torch, f"flash_bwd B={B} H={H} KV={KV} T={T} hd={hd} causal",
                   list(zip(("dq", "dk", "dv"), (dq, dk, dv), want, plain)))
        worst = {}
        for label, got, w, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want, plain):
            scale = float(w.abs().max())
            worst[label] = hold(torch, f"flash_bwd {label} B={B} H={H} KV={KV} T={T} "
                                f"hd={hd} causal (scale {scale:.3e})",
                                [(label, got, w, b, None)], 1e-2 * scale)
        dq2, delta2 = flash_bwd_dq(q, k, v, valid, out, lse, do)
        dk2, dv2 = flash_bwd_dkv(q, k, v, valid, lse, delta2, do)
        if not all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2),
                                                  (dk, dk2), (dv, dv2))):
            fail(f"flash backward T={T}: two launches on the same inputs differ")
        ms_dq = time_ms(torch, lambda: flash_bwd_dq(q, k, v, valid, out, lse, do), 20)
        ms_dkv = time_ms(torch, lambda: flash_bwd_dkv(q, k, v, valid, lse, delta, do), 20)
        plain_ms = time_ms(torch, lambda: flash_attention_backward_reference(
            q, k, v, valid, out, lse, do), 3)
        mask = valid[:, None, None, :] & torch.ones((T, T), dtype=torch.bool,
                                                    device="cuda").tril()
        sq, sk, sv = (t.detach().requires_grad_() for t in (q, k, v))
        s_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True)
        lib = time_ms(torch, lambda: torch.autograd.grad(s_out, (sq, sk, sv), do,
                                                         retain_graph=True), 20)
        fwd_flops = 4.0 * B * H * hd * T * (T + 1) / 2  # causal pairs only
        e = 2  # bf16 bytes
        qb, kb, rb = e * q.numel(), e * k.numel(), 4 * lse.numel()
        # dq: S, dP, dQ products (1.5x the forward); reads q k v o dO lse, writes
        # dq and delta. dkv: S, dP, dV, dK (2x); reads q k v dO lse delta,
        # writes dk dv. The backward as a whole: 2.5x the forward, q k v o dO
        # lse in, dq dk dv out.
        b_dq = bound_ms(qb * 3 + kb * 2 + rb * 2 + qb, 1.5 * fwd_flops)
        b_dkv = bound_ms(qb * 2 + kb * 2 + rb * 2 + kb * 2, 2.0 * fwd_flops)
        b_all = bound_ms(qb * 3 + kb * 2 + rb + qb + kb * 2, 2.5 * fwd_flops)
        on_card = {}
        for name, fn in (("dq", lambda: flash_bwd_dq(q, k, v, valid, out, lse, do)),
                         ("dkv", lambda: flash_bwd_dkv(q, k, v, valid, lse, delta, do))):
            parts = device_ms(torch, fn, 10, "flash_bwd")
            on_card[name] = dev_total(parts)
            log(f"  flash backward B={B} T={T}: {name} entry, device time per call by "
                f"kernel (profiler): " + ", ".join(
                    f"{re.search(r'flash_bwd_[a-z_]+', key).group(0)} {ms:.4f} ms"
                    for key, ms in parts.items()))
        S = dkv_split(q, KV, True)
        blocks = dkv_schedule(B, KV, H // KV, T, True, S)[0]
        n_blocks, mean, most = dkv_balance(blocks)
        per_wave = {n: sm * blocks_per_sm(n, hd) for n in ("dq", "dkv")}
        dq_blocks = -(-T // 64) * B * H
        # every split against waves of resident blocks (a model: steps only)
        sweep = []
        for s in range(1, DKV_MAX_SPLITS + 1):
            sched, _, n_slots = dkv_schedule(B, KV, H // KV, T, True, s)
            sweep.append(f"{s}{'*' * (s == S)}: {len(sched) / per_wave['dkv']:.2f} / "
                         f"{_makespan(sched, per_wave['dkv'])} / {n_slots}")
        log(f"  flash backward B={B} T={T}: dkv split S (* chosen): waves of "
            f"{per_wave['dkv']} resident blocks / steps of the busiest slot, blocks "
            f"handed out heaviest first (an even share: "
            f"{sum(r[4] - r[3] for r in blocks) / per_wave['dkv']:.2f}) / f32 partial "
            f"tiles: {'; '.join(sweep)}")
        log(f"  flash backward B={B} T={T}: dq {ms_dq:.4f} ms "
            f"({1.5 * fwd_flops / ms_dq / 1e9:.1f} TFLOP/s, bound {b_dq[0]:.4f} ms "
            f"{b_dq[1]}, {dq_blocks} blocks, {per_wave['dq']} per wave); dkv "
            f"{ms_dkv:.4f} ms ({2.0 * fwd_flops / ms_dkv / 1e9:.1f} TFLOP/s, bound "
            f"{b_dkv[0]:.4f} ms {b_dkv[1]}, S={S}: {n_blocks} blocks, {per_wave['dkv']} "
            f"per wave, steps mean {mean:.2f} max {most}); together "
            f"{ms_dq + ms_dkv:.4f} ms ({2.5 * fwd_flops / (ms_dq + ms_dkv) / 1e9:.1f} "
            f"TFLOP/s, bound {b_all[0]:.4f} ms {b_all[1]}); plain {plain_ms:.4f} ms; "
            f"SDPA backward {lib:.4f} ms (kernels / SDPA {(ms_dq + ms_dkv) / lib:.3f}); "
            f"device time (profiler) dq {fmt_ms(on_card['dq'])}, dkv "
            f"{fmt_ms(on_card['dkv'])}; "
            f"two launches equal bit for bit")
        shape = f"B={B} H={H} KV={KV} T={T} hd={hd}, causal"
        results[T] = {
            "flash_bwd_dq": dict(ms=ms_dq, plain_ms=plain_ms, library_ms=lib,
                                 bound_ms=b_dq[0], bound_by=b_dq[1],
                                 max_abs_err=worst["dq"], shape=shape),
            "flash_bwd_dkv": dict(ms=ms_dkv, plain_ms=plain_ms, library_ms=lib,
                                  bound_ms=b_dkv[0], bound_by=b_dkv[1],
                                  max_abs_err=max(worst["dk"], worst["dv"]),
                                  shape=f"{shape}, S={S}"),
        }
    return results


@contextlib.contextmanager
def recording_backward_shapes(seen):
    """Count, by shape, the calls of the flash backward wrappers inside the
    model's backward (the wrappers, and their launch counts, run
    unchanged)."""
    from nanorlhf_tpu_torch.ops import attention

    dq_fn, dkv_fn = attention.flash_bwd_dq, attention.flash_bwd_dkv

    def rec_dq(q, k, v, key_valid, out, lse, do, causal=True):
        seen[("flash_bwd_dq", *q.shape[:2], k.shape[1], *q.shape[2:], bool(causal))] += 1
        return dq_fn(q, k, v, key_valid, out, lse, do, causal)

    def rec_dkv(q, k, v, key_valid, lse, delta, do, causal=True):
        seen[("flash_bwd_dkv", *q.shape[:2], k.shape[1], *q.shape[2:], bool(causal))] += 1
        return dkv_fn(q, k, v, key_valid, lse, delta, do, causal)

    attention.flash_bwd_dq, attention.flash_bwd_dkv = rec_dq, rec_dkv
    try:
        yield
    finally:
        attention.flash_bwd_dq, attention.flash_bwd_dkv = dq_fn, dkv_fn


def check_decode(torch, F, prompt_width: int, shapes) -> dict:
    """K4 at each (B, T_max) in `shapes` (H=12, KV=2, hd=128): the rollout's
    decode rows — phase 3's 16 and phase 4's 64 — at T_max = prompt + 1500
    (B=16: the kernels line) and prompt + 512 (the length phases 3–6 run).
    Held per element within one bf16 ulp of the plain version's f32 result
    + ULP_FLOOR (`hold_ulp`: a dropped tile, range or split shows on the
    long windows' small outputs), with bounds straddling and sitting on
    32-key tile edges, a full row, one key, and an empty window, which must
    come out zeros; the split count the C entry uses must be
    `decode_split_count`'s. Timed over 4 distinct caches (> L2, as 28
    layers are): events (the wrapper included), device time (profiler), the
    plain version and SDPA (query length 1, boolean mask). Returns
    {(B, T_max): result}."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    H, KV, hd = 12, 2, 128
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for B, T in shapes:
        gen = torch.Generator(device="cuda").manual_seed(2)
        S, S_rule = da.decode_split_count_on_card(B, KV), da.decode_split_count(B, KV, sm)
        if S != S_rule:
            fail(f"decode_attention B={B}: the C entry splits {S} ways, decode_split_count "
                 f"says {S_rule}")
        start = torch.randint(0, max(1, prompt_width - 1), (B,), generator=gen, device="cuda")
        filled = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
        filled = torch.maximum(filled, start + 1)
        # bounds straddling and sitting on 32-key tile edges, a full row, one
        # key, and (last row) an empty window
        filled[:7] = torch.tensor([T, 64, 65, min(1024, T), 31, 33, 2], device="cuda")
        start[:7] = torch.tensor([0, 0, 63, 5, 30, 32, 1], device="cuda")
        filled[B - 1] = start[B - 1]
        start, filled = start.int(), filled.int()
        live = torch.arange(B, device="cuda") != B - 1
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
        caches = [(torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16),
                   torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16))
                  for _ in range(4)]  # 4 distinct caches > L2, as 28 layers are
        k, v = caches[0]
        got = da.decode_attention(q, k, v, start, filled)
        what = f"decode_attention B={B} T_max={T} S={S}"
        err = hold_ulp(torch, what, [(
            "out", got, da.reference_decode_attention(*_f32(q, k, v), start, filled),
            da.reference_decode_attention(q, k, v, start, filled), live)])
        if got[B - 1].float().abs().max() != 0:
            fail(f"{what}: a row with an empty window must return zeros")
        it = iter(range(10**9))

        def kern():
            kk, vv = caches[next(it) % 4]
            da.decode_attention(q, kk, vv, start, filled)

        ms = time_ms(torch, kern, 40)
        on_card = dev_total(device_ms(torch, kern, 20, "decode_kernel"))
        plain = time_ms(torch, lambda: da.reference_decode_attention(q, k, v, start, filled), 10)
        pos = torch.arange(T, device="cuda")[None, :]
        mask = ((pos >= start[:, None]) & (pos < filled[:, None]))[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True), 20)
        n_valid = float((filled - start).clamp(min=0).sum())
        nbytes = 2 * (2 * n_valid * KV * hd) + 2 * 2 * q.numel() + 8 * B
        bms, by = bound_ms(nbytes, 4.0 * n_valid * H * hd)
        log(f"  {what}: kernel {ms:.4f} ms, device time (profiler) {fmt_ms(on_card)}; plain "
            f"{plain:.4f} ms; SDPA (q len 1) {lib:.4f} ms (kernel / SDPA {ms / lib:.3f}); bound "
            f"{bms:.4f} ms ({by})")
        results[(B, T)] = dict(ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib,
                               bound_ms=bms, bound_by=by, max_abs_err=err,
                               shape=f"B={B} H={H} KV={KV} T_max={T} hd={hd}, S={S}")
    return results


def _scattered_table(torch, gen, B: int, nb: int, spare: int = 7):
    """A block table [B, nb] int32 of distinct pages scattered through a
    pool of N = B·nb + spare pages; row 0's last block is the sentinel N
    (unallocated) when rows have more than one block. Returns (table, N)."""
    N = B * nb + spare
    table = torch.randperm(N, generator=gen, device="cuda")[:B * nb].reshape(B, nb)
    if nb > 1:
        table[0, -1] = N
    return table.int(), N


def _scatter(torch, logical, table, N: int, P: int):
    """The pool [N, KV, P, ...] holding the logical cache [B, KV, nb·P, ...]
    at the table's pages (sentinel blocks left out)."""
    B, KV, T = logical.shape[:3]
    nb = T // P
    pool = torch.zeros((N, KV, P) + tuple(logical.shape[3:]), dtype=logical.dtype,
                       device="cuda")
    blocks = logical.reshape(B, KV, nb, P, *logical.shape[3:]).transpose(1, 2)
    live = table.long() < N
    pool[table.long()[live]] = blocks[live]
    return pool


def _paged_case(torch, gen, B, H, KV, hd, P, T_need, pad_max):
    """Inputs of one paged decode check: q, the logical K/V [B, KV, nb·P,
    hd] (bf16), their int8 copies, each laid out contiguously and through a
    scattered pool, and mixed [start, filled) bounds below row 0's sentinel
    block, with a row whose window is empty (filled == start)."""
    from nanorlhf_tpu_torch.core.model import quantize_kv

    nb = -(-T_need // P)
    T = nb * P
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
    start = torch.randint(0, max(1, pad_max), (B,), generator=gen, device="cuda")
    filled = torch.randint(1, T_need + 1, (B,), generator=gen, device="cuda")
    filled = torch.maximum(filled, start + 1)
    if nb > 1:  # row 0 stays below its sentinel last block
        filled[0] = min(int(filled[0]), (nb - 1) * P)
        start[0] = min(int(start[0]), int(filled[0]) - 1)
    filled[1] = T_need                    # a full row
    empty = B - 1
    filled[empty] = start[empty]          # an empty window: zeros
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    table, N = _scattered_table(torch, gen, B, nb)
    c = dict(q=q, k=k, v=v, kq=kq, ks=ks, vq=vq, vs=vs, table=table,
             start=start.int(), filled=filled.int(), empty=empty, nb=nb, T=T, N=N)
    _pools(torch, c, P)
    return c


def _pools(torch, c, P: int) -> None:
    """Lay case `c`'s logical caches out through its table."""
    c["kp"], c["vp"] = (_scatter(torch, c[n], c["table"], c["N"], P) for n in "kv")
    c["q8_pools"] = [_scatter(torch, c[n], c["table"], c["N"], P)
                     for n in ("kq", "ks", "vq", "vs")]


def check_paged(torch, F, prompt_width: int, resp: int, rows: int = 32,
                page: int = 128) -> dict:
    """K7 (paged bf16), K5 (int8) and K8 (paged int8) at the rollout's
    decode shape — `rows` resident rows (32), H=12, KV=2, hd=128, T_max =
    prompt width + response, page size `page` (128) — with the pages
    scattered through a
    pool with spare pages and row 0's last block a sentinel. Each is held
    against its plain version evaluated in f32 on the same bf16 / int8
    inputs (tolerance 2e-2: f32 inside, the bf16 output rounds by up to one
    ulp of |out| < 4); K7 must equal K4 bit for bit on the same logical
    cache laid out contiguously, and K8 must equal K5. Then edge shapes:
    page sizes 16 and 48 (not a multiple of 32), hd 64, GQA groups 4 and 7,
    page sizes not dividing T_max; every case has a row with an empty
    window, which must come out zeros."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    tol = 2e-2
    gen = torch.Generator(device="cuda").manual_seed(6)
    T_need = prompt_width + resp

    def run_case(B, H, KV, hd, P, label):
        c = _paged_case(torch, gen, B, H, KV, hd, P, T_need, prompt_width)
        q, start, filled, table = c["q"], c["start"], c["filled"], c["table"]
        rows = torch.ones(B, dtype=torch.bool, device="cuda")
        rows[c["empty"]] = False
        k7 = da.paged_decode_attention(q, c["kp"], c["vp"], table, start, filled)
        k4 = da.decode_attention(q, c["k"], c["v"], start, filled)
        k5 = da.decode_attention_q8(q, c["kq"], c["ks"], c["vq"], c["vs"], start, filled)
        k8 = da.paged_decode_attention_q8(q, *c["q8_pools"], table, start, filled)
        torch.cuda.synchronize()
        want = da.reference_paged_decode_attention(
            q.float(), c["kp"].float(), c["vp"].float(), table, start, filled)
        want8 = da.reference_decode_attention_q8(
            q.float(), c["kq"], c["ks"], c["vq"], c["vs"], start, filled)
        e7 = hold(torch, f"{label} paged_decode_attention P={P}", [(
            "out", k7, want,
            da.reference_paged_decode_attention(q, c["kp"], c["vp"], table, start, filled),
            rows)], tol)
        e5 = hold(torch, f"{label} decode_attention_q8", [(
            "out", k5, want8,
            da.reference_decode_attention_q8(q, c["kq"], c["ks"], c["vq"], c["vs"],
                                             start, filled), rows)], tol)
        e8 = hold(torch, f"{label} paged_decode_attention_q8 P={P}", [(
            "out", k8, want8,
            da.reference_paged_decode_attention_q8(q, *c["q8_pools"], table, start,
                                                   filled), rows)], tol)
        d74 = float((k7.float() - k4.float()).abs().max())
        d85 = float((k8.float() - k5.float()).abs().max())
        log(f"  {label} P={P}: max|K7 - K4| on the same logical cache {d74:.3e}, "
            f"max|K8 - K5| {d85:.3e}")
        if not (torch.equal(k7, k4) and torch.equal(k8, k5)):
            fail(f"{label}: the paged kernels differ from the contiguous ones "
                 "on the same logical cache")
        for name, out in (("K7", k7), ("K5", k5), ("K8", k8)):
            if out[c["empty"]].float().abs().max() != 0:
                fail(f"{label} {name}: a row with an empty window must return zeros")
        return c, (e7, e5, e8)

    B, H, KV, hd, P = rows, 12, 2, 128, page
    c, (e7, e5, e8) = run_case(B, H, KV, hd, P, "rollout shape")
    for (eB, eH, eKV, ehd, eP) in ((4, 12, 2, 128, 16), (4, 12, 2, 128, 48),
                                  (3, 32, 8, 64, 48), (3, 14, 2, 64, 16)):
        run_case(eB, eH, eKV, ehd, eP, f"edge B={eB} H={eH} KV={eKV} hd={ehd}")

    # timings at the rollout shape: 4 distinct pools (> L2, as 28 layers are)
    q, start, filled, table = c["q"], c["start"], c["filled"], c["table"]
    sets = [c] + [_paged_case(torch, gen, B, H, KV, hd, P, T_need, prompt_width)
                  for _ in range(3)]
    for extra in sets[1:]:  # the same bounds and table layout as the first
        extra.update(table=table, start=start, filled=filled, N=c["N"])
        _pools(torch, extra, P)
    it = iter(range(10**9))

    def rot():
        return sets[next(it) % 4]

    calls = {
        "K7": lambda: (lambda s: da.paged_decode_attention(
            q, s["kp"], s["vp"], table, start, filled))(rot()),
        "K4": lambda: (lambda s: da.decode_attention(
            q, s["k"], s["v"], start, filled))(rot()),
        "K5": lambda: (lambda s: da.decode_attention_q8(
            q, s["kq"], s["ks"], s["vq"], s["vs"], start, filled))(rot()),
        "K8": lambda: (lambda s: da.paged_decode_attention_q8(
            q, *s["q8_pools"], table, start, filled))(rot()),
    }
    ms = {name: time_ms(torch, fn, 40) for name, fn in calls.items()}
    dev = {name: dev_total(device_ms(torch, fn, 20, "decode_kernel"))
           for name, fn in calls.items()}
    log(f"  the decode family on the same logical caches (B={B}), events / device time "
        f"(profiler): " + ", ".join(f"{n} {ms[n]:.4f} ms / {fmt_ms(dev[n])}" for n in calls))
    ms7, ms5, ms8 = ms["K7"], ms["K5"], ms["K8"]
    plain7 = time_ms(torch, lambda: da.reference_paged_decode_attention(
        q, c["kp"], c["vp"], table, start, filled), 10)
    plain5 = time_ms(torch, lambda: da.reference_decode_attention_q8(
        q, c["kq"], c["ks"], c["vq"], c["vs"], start, filled), 10)
    plain8 = time_ms(torch, lambda: da.reference_paged_decode_attention_q8(
        q, *c["q8_pools"], table, start, filled), 10)
    # the yardstick: no single PyTorch call reads a paged or an int8 cache;
    # SDPA over a pre-gathered (and for int8 pre-dequantized) contiguous
    # view — "not one call" — with the gather / dequantize timed beside it
    T = c["T"]
    pos = torch.arange(T, device="cuda")[None, :]
    mask = ((pos >= start[:, None]) & (pos < filled[:, None]))[:, None, None, :]
    q4 = q[:, :, None, :]
    kg = da._gather_pool(c["kp"], table)
    vg = da._gather_pool(c["vp"], table)
    kd = da.dequantize_kv(c["kq"], c["ks"], torch.bfloat16)
    vd = da.dequantize_kv(c["vq"], c["vs"], torch.bfloat16)
    sdpa = lambda kk, vv: F.scaled_dot_product_attention(  # noqa: E731
        q4, kk, vv, attn_mask=mask, enable_gqa=True)
    lib7 = time_ms(torch, lambda: sdpa(kg, vg), 20)
    lib5 = time_ms(torch, lambda: sdpa(kd, vd), 20)
    gather_ms = time_ms(torch, lambda: (da._gather_pool(c["kp"], table),
                                        da._gather_pool(c["vp"], table)), 10)
    deq_ms = time_ms(torch, lambda: (da.dequantize_kv(c["kq"], c["ks"], torch.bfloat16),
                                     da.dequantize_kv(c["vq"], c["vs"], torch.bfloat16)), 10)
    gdeq_ms = time_ms(torch, lambda: [da.dequantize_kv(
        da._gather_pool(c["q8_pools"][i], table), da._gather_pool(c["q8_pools"][i + 1], table),
        torch.bfloat16) for i in (0, 2)], 10)
    log(f"  library yardsticks (not one call): SDPA over the pre-gathered view "
        f"{lib7:.4f} ms + gather {gather_ms:.4f} ms; SDPA over the pre-dequantized "
        f"view {lib5:.4f} ms + dequantize {deq_ms:.4f} ms (gather + dequantize "
        f"{gdeq_ms:.4f} ms for the paged int8 cache)")
    live = torch.arange(B, device="cuda") != c["empty"]
    n_valid = float((filled - start)[live].sum())
    io = 2 * 2 * q.numel() + 8 * B        # q in, out back, start/filled
    flops = 4.0 * n_valid * H * hd
    b7 = bound_ms(2 * (2 * n_valid * KV * hd) + 4 * table.numel() + io, flops)
    b5 = bound_ms(2 * (n_valid * KV * hd + 2 * n_valid * KV) + io, flops)
    b8 = bound_ms(2 * (n_valid * KV * hd + 2 * n_valid * KV) + 4 * table.numel() + io,
                  flops)
    shape = f"B={B} H={H} KV={KV} T_max={T_need} hd={hd}"
    return {
        "paged_decode_attention": dict(
            ms=ms7, device_ms=dev["K7"], plain_ms=plain7, library_ms=lib7, bound_ms=b7[0],
            bound_by=b7[1], max_abs_err=e7, shape=f"{shape} P={P}, pool of {c['N']} pages"),
        "decode_attention_q8": dict(
            ms=ms5, device_ms=dev["K5"], plain_ms=plain5, library_ms=lib5, bound_ms=b5[0],
            bound_by=b5[1], max_abs_err=e5, shape=f"{shape}, int8 + bf16 scales"),
        "paged_decode_attention_q8": dict(
            ms=ms8, device_ms=dev["K8"], plain_ms=plain8, library_ms=lib5, bound_ms=b8[0],
            bound_by=b8[1], max_abs_err=e8, shape=f"{shape} P={P}, int8 pools"),
    }


def bf16_ulp(torch, x):
    """The spacing of bf16 values (8 significant bits) at |x|."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


ULP_FLOOR = 1e-5  # f32 summation order and __expf: ~1e-6 on outputs of |v| ~ 1


def hold_ulp(torch, what: str, pairs) -> float:
    """As `hold`, with a bound per element instead of one absolute
    tolerance: one bf16 ulp of |f32 result| + ULP_FLOOR. A kernel that
    computes in f32 and rounds its bf16 output once is within half an ulp
    of it, so a dropped or doubled tile, or a mis-weighted split, shows on
    the long windows' small outputs (|out| ~ 0.05) as well as on the short
    windows' large ones. Returns the largest kernel error."""
    worst, bad = 0.0, False
    parts = []
    for label, got, want, bf16, rows in pairs:
        if not torch.isfinite(got.float()).all():
            fail(f"{what}: non-finite {label}")
        lim = bf16_ulp(torch, want) + ULP_FLOOR
        d = (got.float() - want.float()).abs()
        db = (bf16.float() - want.float()).abs()
        if rows is not None:
            d, db, lim = d[rows], db[rows], lim[rows]
        err, share = float(d.max()), float((d / lim).max())
        parts.append(f"{label} {err:.3e}, {share:.3f} of its bound (plain bf16 "
                     f"{float(db.max()):.3e}, {float((db / lim).max()):.3f})")
        worst, bad = max(worst, err), bad or share > 1.0
    log(f"  {what}: max|kernel - plain f32|, and its largest share of the bound "
        f"1 bf16 ulp of |plain f32| + {ULP_FLOOR}: {', '.join(parts)}")
    if bad:
        fail(f"{what}: kernel disagrees with its plain version")
    return worst


def _verify_case(torch, gen, B, H, KV, Tq, hd, T, pad_max, P=None, copies=1):
    """Inputs of one verify check over T logical slots: q [B, H, Tq, hd] and
    `copies` distinct K/V caches [B, KV, T, hd] (bf16); start/fill [B] with
    random prefixes and fills, then edges where B allows — candidates
    straddling a 32-key tile and a page, the last slot taken, a candidate
    block past the end (clamped to T), and on the last row a prefix that
    starts after the first candidates (their windows are empty: zeros).
    With a page size P (T = nb·P): a scattered table whose row 0 ends in a
    sentinel block (row 0's candidates kept below it) and the caches laid
    out through it. `empty` [B, Tq] marks the empty windows."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(B, H, Tq, hd)
    caches = [(randn(B, KV, T, hd), randn(B, KV, T, hd)) for _ in range(copies)]
    start = torch.randint(0, max(1, pad_max), (B,), generator=gen, device="cuda")
    fill = torch.randint(pad_max, T - Tq + 1, (B,), generator=gen, device="cuda")
    page = P or 128
    edges = [(0, T - Tq), (3, 62), (5, page - 2), (7, 2 * page - 3), (0, T - 2), (9, 31)]
    for i, (s, f) in enumerate(edges[:max(0, B - 2)]):
        start[1 + i], fill[1 + i] = s, min(f, T - 1)
    start[B - 1] = fill[B - 1] + 2
    c = dict(q=q, caches=caches, B=B, H=H, KV=KV, Tq=Tq, hd=hd, T=T, P=P)
    if P is not None:
        nb = T // P
        table, N = _scattered_table(torch, gen, B, nb)
        if nb > 1:
            fill[0] = min(int(fill[0]), (nb - 1) * P - Tq)
            start[0] = min(int(start[0]), int(fill[0]))
        c.update(table=table, N=N, nb=nb, pools=[
            (_scatter(torch, k, table, N, P), _scatter(torch, v, table, N, P))
            for k, v in caches])
    qi = torch.arange(Tq, device="cuda")[None, :]
    c.update(start=start.int(), fill=fill.int(), empty=fill[:, None] + qi + 1 <= start[:, None])
    return c


def _hold_verify(torch, label: str, c) -> tuple[float, float]:
    """K6 (and with pages K9) on case `c` against the plain versions in f32
    (`hold_ulp`), empty windows zeros, K9 == K6 bit for bit on the same
    logical cache, and K6 at Tq = 1 against K4 within one bf16 ulp of K4's
    output + ULP_FLOOR (two kernels that each round an f32 result once
    differ by at most that). Returns (K6 error, K9 error or 0)."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    q, (k, v), start, fill, empty = c["q"], c["caches"][0], c["start"], c["fill"], c["empty"]
    H, Tq = c["H"], c["Tq"]
    S = da.verify_split_count_on_card(c["B"], c["KV"])
    rule = da.verify_split_count(c["B"], c["KV"], torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    if S != rule:
        fail(f"verify {label}: the C entry splits {S} ways, verify_split_count says {rule}")
    label = f"{label} S={S}"
    rows = ~empty[:, None, :].expand(-1, H, -1)

    def held(what, got, plain, kk, vv):
        err = hold_ulp(torch, what, [(
            "out", got, plain(*_f32(q, kk, vv), start, fill), plain(q, kk, vv, start, fill),
            rows)])
        if bool(empty.any()) and got[~rows].float().abs().max() != 0:
            fail(f"{what}: a candidate with an empty window must return zeros")
        return err

    k6 = da.decode_verify_attention(q, k, v, start, fill)
    e6 = held(f"decode_verify_attention {label}", k6, da.reference_decode_verify_attention,
              k, v)
    e9 = 0.0
    if c["P"] is not None:
        kp, vp = c["pools"][0]
        table = c["table"]
        k9 = da.paged_decode_verify_attention(q, kp, vp, table, start, fill)
        e9 = held(f"paged_decode_verify_attention {label} P={c['P']} nb={c['nb']}", k9,
                  lambda qq, kk, vv, s, f: da.reference_paged_decode_verify_attention(
                      qq, kk, vv, table, s, f), kp, vp)
        d96 = float((k9.float() - k6.float()).abs().max())
        log(f"  K9 against K6 on the same logical cache ({label}): max|diff| {d96:.3e}")
        if not torch.equal(k9, k6):
            fail(f"K9 differs from K6 on the same logical cache ({label})")
    k6_1 = k6 if Tq == 1 else da.decode_verify_attention(q[:, :, :1].contiguous(), k, v,
                                                         start, fill)
    k4 = da.decode_attention(q[:, :, 0].contiguous(), k, v, start, fill + 1)
    live = ~empty[:, 0]
    d = (k6_1[:, :, 0].float() - k4.float()).abs()[live]
    share = float((d / (bf16_ulp(torch, k4[live]) + ULP_FLOOR)).max())
    log(f"  K6 at Tq=1 against K4 on the same cache ({label}): max|diff| "
        f"{float(d.max()):.3e}, {share:.3f} of its bound (1 bf16 ulp of |K4| + {ULP_FLOOR})")
    if share > 1.0:
        fail(f"K6 at Tq=1 disagrees with K4 ({label})")
    return e6, e9


def check_verify(torch, F, pad_max: int, k6_shape, k9_shape, timed: bool = True) -> dict:
    """K6 and K9 at the shapes the speculative path gives them — K6
    (B, H, Tq, hd, KV, T) over the contiguous cache, K9 (B, H, Tq, hd, KV,
    P, nb) over pages scattered through a pool with spare pages and a
    sentinel block on row 0 — each held by `_hold_verify` (its split count
    equal to `verify_split_count`'s); then (`timed`) the times (4 distinct
    caches, > L2 as 28 layers are; events and device time), the yardsticks
    (K6: SDPA with a boolean mask over the contiguous cache, query length
    Tq; K9: not one call — SDPA over the pre-gathered view, the gather timed
    beside it) and the bounds. Returns the two kernels-line entries."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(8)

    def mask(c):
        pos = torch.arange(c["T"], device="cuda")[None, None, :]
        qi = torch.arange(c["Tq"], device="cuda")[None, :, None]
        return ((pos >= c["start"][:, None, None])
                & (pos < c["fill"][:, None, None] + qi + 1))[:, None]

    B, H, Tq, hd, KV, T = k6_shape
    c6 = _verify_case(torch, gen, B, H, KV, Tq, hd, T, pad_max, copies=4)
    shape6 = f"B={B} H={H} KV={KV} Tq={Tq} hd={hd} T_max={T}"
    e6, _ = _hold_verify(torch, shape6, c6)
    B9, H, Tq, hd, KV, P, nb = k9_shape
    c9 = _verify_case(torch, gen, B9, H, KV, Tq, hd, nb * P, pad_max, P=P, copies=4)
    shape9 = f"B={B9} H={H} KV={KV} Tq={Tq} hd={hd}"
    _, e9 = _hold_verify(torch, shape9, c9)
    if not timed:
        return {}

    q, (k, v), start, fill = c6["q"], c6["caches"][0], c6["start"], c6["fill"]
    it = iter(range(10**9))

    def k6():
        kk, vv = c6["caches"][next(it) % 4]
        da.decode_verify_attention(q, kk, vv, start, fill)

    ms = time_ms(torch, k6, 40)
    on_card = dev_total(device_ms(torch, k6, 20, "verify_kernel"))
    plain = time_ms(torch, lambda: da.reference_decode_verify_attention(
        q, k, v, start, fill), 10)
    m = mask(c6)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True), 20)
    b = verify_bound(torch, c6)
    t_dev = on_card if on_card is not None else ms
    log(f"  decode_verify_attention {shape6}: kernel {ms:.4f} ms, device time (profiler) "
        f"{fmt_ms(on_card)}; plain {plain:.4f} ms; SDPA (boolean mask, q len {Tq}) "
        f"{lib:.4f} ms (device / SDPA {t_dev / lib:.3f}); bound {b[0]:.4f} ms ({b[1]}, "
        f"{100 * b[0] / t_dev:.1f}% of it)")
    k6_row = dict(
        ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib, bound_ms=b[0],
        bound_by=b[1], max_abs_err=e6,
        shape=f"{shape6} S={da.verify_split_count_on_card(B, KV)}")

    q, start, fill, table = c9["q"], c9["start"], c9["fill"], c9["table"]
    kp, vp = c9["pools"][0]

    def k9():
        kk, vv = c9["pools"][next(it) % 4]
        da.paged_decode_verify_attention(q, kk, vv, table, start, fill)

    def k6_same():
        kk, vv = c9["caches"][next(it) % 4]
        da.decode_verify_attention(q, kk, vv, start, fill)

    ms = time_ms(torch, k9, 40)
    on_card = dev_total(device_ms(torch, k9, 20, "verify_kernel"))
    ms6 = time_ms(torch, k6_same, 40)
    plain = time_ms(torch, lambda: da.reference_paged_decode_verify_attention(
        q, kp, vp, table, start, fill), 10)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    m = mask(c9)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=m, enable_gqa=True), 20)
    gather_ms = time_ms(torch, lambda: (da._gather_pool(kp, table),
                                        da._gather_pool(vp, table)), 10)
    b = verify_bound(torch, c9, 4 * table.numel())
    log(f"  K6 on the same logical caches laid out contiguously ({shape9}): "
        f"{ms6:.4f} ms; K9 through the pages {ms:.4f} ms, device time (profiler) "
        f"{fmt_ms(on_card)}; yardstick (not one call): SDPA over the pre-gathered view "
        f"{lib:.4f} ms + gather {gather_ms:.4f} ms")
    return {"decode_verify_attention": k6_row, "paged_decode_verify_attention": dict(
        ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib, bound_ms=b[0],
        bound_by=b[1], max_abs_err=e9,
        shape=f"{shape9} P={P} nb={nb}, pool of {c9['N']} pages, "
              f"S={da.verify_split_count_on_card(B9, KV)}")}


@contextlib.contextmanager
def recording_verify_shapes(seen):
    """Count, by shape, the model's calls of the verify wrappers (the
    wrappers, and their launch counts, run unchanged)."""
    from nanorlhf_tpu_torch.core import model

    k6, k9 = model.decode_verify_attention, model.paged_decode_verify_attention

    def rec6(q, k, v, start, fill):
        seen[("decode_verify_attention", *q.shape, k.shape[1], k.shape[2])] += 1
        return k6(q, k, v, start, fill)

    def rec9(q, kp, vp, table, start, fill):
        seen[("paged_decode_verify_attention", *q.shape, kp.shape[1], kp.shape[2],
              table.shape[1])] += 1
        return k9(q, kp, vp, table, start, fill)

    model.decode_verify_attention, model.paged_decode_verify_attention = rec6, rec9
    try:
        yield
    finally:
        model.decode_verify_attention, model.paged_decode_verify_attention = k6, k9


def check_verify_edges(torch, pad_max: int) -> None:
    """K6 and K9 off the rollout's shapes, each case paged (so K9 == K6 is
    held too): R = G·Tq = 64 rows (G 8 × Tq 8: two row groups of 32) at
    head_dim 128 and 64, one row per block (G 1, Tq 1; S = 8, the largest
    split), G 7 × Tq 3 at head_dim 64 with pages of 48, and the key-range
    splits S = 1 and S = 3 (B from the SM count; the split count is
    asserted)."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(9)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    #         B                H   KV Tq hd  T_need P    S wanted
    cases = [(4,               16, 2, 8, 128, 300, 128, None),
             (3,               2,  2, 1, 128, 200, 16,  None),
             (5,               14, 2, 3, 64,  257, 48,  None),
             (sm + 1,          64, 8, 8, 64,  160, 48,  1),
             (sm // 6,         12, 2, 5, 128, 400, 128, 3)]
    for B, H, KV, Tq, hd, T_need, P, want_S in cases:
        S = da.verify_split_count(B, KV, sm)
        if want_S is not None and S != want_S:
            fail(f"verify edge B={B} KV={KV}: split count {S}, meant to cover {want_S}")
        T = -(-T_need // P) * P
        c = _verify_case(torch, gen, B, H, KV, Tq, hd, T, min(pad_max, T // 4), P=P)
        _hold_verify(torch, f"edge B={B} H={H} KV={KV} Tq={Tq} hd={hd} T_max={T}", c)


# K10 per row: |kernel - plain f32| of each row's logprob and entropy, the
# plain version run in f32 on the same bf16 inputs. Dropping one 256-column
# vocab tile from a row's sum moves its lse by ~256 / V of it (1.7e-3 at
# V = 151936); FUSED_TOL sits an order under that and over the sound error
# the kernel shows (PERF.md §6).
FUSED_TOL = 1e-4


def check_fused(torch, F, resp: int, shapes, timed: bool = True) -> dict:
    """K10 held per row against its plain version in f32 (FUSED_TOL): at
    each shape (R, D, V, with_entropy, transposed) in `shapes`, the ones the
    main path gives it (the scoring pass, R = 16 x response, and the
    update's microbatch with entropy, R = 4 x response, at the responses of
    phases 4 and 7a); the [D, V] layout with and without entropy; off those
    shapes (R = 300, D = 128, V = 1000: a ragged row tile and vocab tile,
    both layouts, T = 0.7). The split count the C entry uses must be
    `fused_logprob_split_count`'s at each. Then (`timed`) the times of both
    variants at the full response — the scoring pass and the update's
    microbatch: events, device time (profiler), the plain version, one
    library call (matmul + logsumexp + gather, + Σ softmax·z with entropy)
    and the bound. Returns the kernels-line entry."""
    from nanorlhf_tpu_torch.ops.fused_logprob import (
        fused_chunk_rows, fused_logprob_chunked, fused_logprob_kernel,
        fused_logprob_split_count, fused_logprob_split_count_on_card)

    R, D, V, temp = 16 * resp, 1536, 151936, 0.9
    r_up = 4 * resp
    if not {(R, D, V, False, True), (r_up, D, V, True, True)} <= set(shapes):
        fail(f"fused_logprob: the timed shapes R={R}, R={r_up} are not among {shapes}")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, vocab in sorted({(s[0], s[2]) for s in shapes} | {(512, 4096), (300, 1000)}):
        got, rule = (fused_logprob_split_count_on_card(rows, vocab),
                     fused_logprob_split_count(rows, vocab, sm))
        if got != rule:
            fail(f"fused_logprob R={rows} V={vocab}: the C entry splits {got} ways, "
                 f"fused_logprob_split_count says {rule}")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    r_max = max(s[0] for s in shapes)
    h = randn(r_max, D)
    w = randn(V, D, scale=0.02)
    labels = torch.randint(0, V, (r_max,), generator=gen, device="cuda")
    worst = 0.0

    def held(what, hh, ww, lab, t, transposed, ent):
        rows, vocab = hh.shape[0], ww.numel() // hh.shape[1]
        chunk = fused_chunk_rows(vocab, rows)
        got = fused_logprob_kernel(hh, ww, lab, t, with_entropy=ent, transposed=transposed)
        want = fused_logprob_chunked(*_f32(hh, ww), lab, t, chunk, with_entropy=ent,
                                     transposed=transposed)
        bf16 = fused_logprob_chunked(hh, ww, lab, t, chunk, with_entropy=ent,
                                     transposed=transposed)
        pairs = [("logprob", got[0], want[0], bf16[0], None)]
        if ent:
            pairs.append(("entropy", got[1], want[1], bf16[1], None))
        splits = fused_logprob_split_count(rows, vocab, sm)
        return hold(torch, f"{what} splits={splits} with_entropy={ent}", pairs, FUSED_TOL)

    for rows, d, vocab, ent, transposed in sorted(shapes, reverse=True):
        if (d, vocab, transposed) != (D, V, True):
            fail(f"fused_logprob: no hold at D={d} V={vocab} transposed={transposed}")
        worst = max(worst, held(f"fused_logprob R={rows} D={D} V={V} tied", h[:rows], w,
                                labels[:rows], temp, True, ent))
    for ent in (False, True):
        # the [D, V] weight layout on a slice
        worst = max(worst, held("fused_logprob [D, V] layout R=512 V=4096", h[:512],
                                w[:4096].t().contiguous(), labels[:512] % 4096, temp,
                                False, ent))
    for transposed in (True, False):
        Re, De, Ve = 300, 128, 1000
        he = randn(Re, De)
        we = randn(Ve, De, scale=0.1) if transposed else randn(De, Ve, scale=0.1)
        le = torch.randint(0, Ve, (Re,), generator=gen, device="cuda")
        worst = max(worst, held(f"edge fused_logprob R={Re} D={De} V={Ve} "
                                f"transposed={transposed} T=0.7", he, we, le, 0.7,
                                transposed, True))
    if not timed:
        return {}

    h_t = (h.float() / temp).to(torch.bfloat16)  # temperature folded in up front
    results = {}
    for ent, rows in ((False, R), (True, r_up)):
        hh, lab = h[:rows], labels[:rows]
        chunk = fused_chunk_rows(V, rows)

        def kern():
            fused_logprob_kernel(hh, w, lab, temp, with_entropy=ent, transposed=True)

        def library():
            z = torch.matmul(h_t[:rows], w.t())  # the [R, V] logits the kernel never writes
            lse = torch.logsumexp(z, dim=-1)
            lp = torch.gather(z, 1, lab[:, None])[:, 0] - lse
            if ent:
                return lp, lse - (torch.softmax(z, dim=-1) * z).sum(-1)
            return lp

        ms = time_ms(torch, kern, 3)
        on_card = dev_total(device_ms(torch, kern, 3, "fused_"))
        plain = time_ms(torch, lambda: fused_logprob_chunked(
            hh, w, lab, temp, chunk, with_entropy=ent, transposed=True), 1)
        lib = time_ms(torch, library, 1)
        nbytes = 2 * hh.numel() + 2 * w.numel() + 8 * rows + 4 * rows * (2 if ent else 1)
        bms, by = bound_ms(nbytes, 2.0 * rows * D * V)
        t_dev = on_card if on_card is not None else ms
        what = "the scoring pass" if not ent else "the update's microbatch"
        log(f"  fused_logprob [R={rows} D={D} V={V} tied, with_entropy={ent}: {what}]: "
            f"kernel {ms:.4f} ms, device time (profiler) {fmt_ms(on_card)}, plain "
            f"{plain:.4f} ms, library {lib:.4f} ms (matmul + logsumexp + gather"
            f"{' + softmax·z' if ent else ''}; kernel / library {t_dev / lib:.3f}), "
            f"bound {bms:.4f} ms ({by}, {100 * bms / t_dev:.1f}% of it)")
        results[ent] = dict(ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib,
                            bound_ms=bms, bound_by=by, max_abs_err=worst,
                            shape=f"R={rows} D={D} V={V} tied, with_entropy={ent}")
    return results[False]


@contextlib.contextmanager
def recording_fused_shapes(seen):
    """Count, by (R, D, V, with_entropy, transposed), the calls of the K10
    wrapper that `_FusedLogprob` makes (the wrapper, and its launch count,
    run unchanged)."""
    from nanorlhf_tpu_torch.ops import fused_logprob as fl

    kernel = fl.fused_logprob_kernel

    def rec(hidden, unembed, labels, temperature=1.0, with_entropy=False,
            transposed=False):
        V = unembed.shape[0] if transposed else unembed.shape[1]
        seen[(*hidden.shape, V, bool(with_entropy), bool(transposed))] += 1
        return kernel(hidden, unembed, labels, temperature, with_entropy=with_entropy,
                      transposed=transposed)

    fl.fused_logprob_kernel = rec
    try:
        yield
    finally:
        fl.fused_logprob_kernel = kernel


def fused_device_per_update(torch, seen, launches: int) -> float | None:
    """K10's device time in one update: each shape the update gave the
    kernel (`recording_fused_shapes`) timed on the profiler with inputs of
    that shape, times its calls; CUDA events and the bound beside it. Fails
    unless the calls are the launches."""
    from nanorlhf_tpu_torch.ops.fused_logprob import fused_logprob_kernel

    if sum(seen.values()) != launches:
        fail(f"fused_logprob launched {launches} times, {sum(seen.values())} through "
             f"recorded calls")
    gen = torch.Generator(device="cuda").manual_seed(5)
    total, total_ev, total_bound, parts = 0.0, 0.0, 0.0, []
    for (R, D, V, ent, transposed), calls in sorted(seen.items()):
        h = torch.randn((R, D), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((V, D) if transposed else (D, V), generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        labels = torch.randint(0, V, (R,), generator=gen, device="cuda")

        def kern():
            fused_logprob_kernel(h, w, labels, 0.9, with_entropy=ent, transposed=transposed)

        ms = dev_total(device_ms(torch, kern, 3, "fused_"))
        ev = time_ms(torch, kern, 3)
        bms, _ = bound_ms(2 * h.numel() + 2 * w.numel() + 8 * R + 4 * R * (2 if ent else 1),
                          2.0 * R * D * V)
        total = None if ms is None or total is None else total + calls * ms
        total_ev += calls * ev
        total_bound += calls * bms
        parts.append(f"{calls} x R={R} with_entropy={ent}: device {fmt_ms(ms)}, events "
                     f"{ev:.4f} ms, bound {bms:.4f} ms")
    log(f"  fused_logprob time per update (by recorded shape): device (profiler) "
        f"{fmt_ms(total)}, events {total_ev:.4f} ms, bound {total_bound:.4f} ms "
        f"({'; '.join(parts)})")
    return total


def check_edges(torch) -> None:
    """The kernels off the main shapes: head_dim 64, GQA groups of 4 and 7
    (Llama-3.2-1B and Qwen2-0.5B geometry), ragged T, the
    non-causal flash path (forward and backward), fully masked left-pad
    rows in the backward, an empty decode row (zeros, reading nothing).
    The forward also per 64-row tile; the decode kernel per element within
    one bf16 ulp, with a range shorter than its S tiles, one key and a
    window past the cache. The backward also at T under one tile, at B=1
    with the largest split
    S, and with key tiles cut into several parts, its dK/dV held against
    the plain version of the split (`flash_bwd_dkv_split_reference`) too."""
    from nanorlhf_tpu_torch.ops.attention import (
        DKV_MAX_SPLITS, dkv_key_tile_steps, dkv_schedule, dkv_split,
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_forward, flash_attention_reference,
        flash_bwd_dkv_split_reference, reference_attention)
    from nanorlhf_tpu_torch.ops.decode_attention import (
        decode_attention, decode_split_count_on_card, reference_decode_attention)

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    cut_tiles = 0
    for B, H, KV, T, hd, causal in ((2, 32, 8, 77, 64, True), (2, 14, 2, 130, 64, False),
                                    (1, 12, 2, 65, 128, False), (2, 12, 2, 40, 128, True),
                                    (1, 12, 2, 200, 128, True)):
        q, k, v = randn(B, H, T, hd), randn(B, KV, T, hd), randn(B, KV, T, hd)
        valid = torch.arange(T, device="cuda")[None, :] >= torch.tensor(
            [[0], [9]][:B], device="cuda")
        out, lse = flash_attention_forward(q, k, v, valid, causal=causal)
        ref, ref_lse = flash_attention_reference(*_f32(q, k, v), valid, causal=causal)
        b_out, b_lse = flash_attention_reference(q, k, v, valid, causal=causal)
        rows = (valid if causal else torch.ones_like(valid))[:, None, :].expand(B, H, T)
        what = f"edge flash_fwd B={B} H={H} KV={KV} T={T} hd={hd} causal={causal}"
        hold(torch, what, [("out", out, ref, b_out, rows)], 2e-2)
        hold(torch, what, [("lse", lse, ref_lse, b_lse, rows)], 1e-3)
        keep = rows[..., None]
        hold_tiles(torch, what, [("out", torch.where(keep, out, ref.to(out.dtype)), ref,
                                  torch.where(keep, b_out, ref.to(b_out.dtype)))])
        # backward: left-pad rows (all keys masked when causal) get dO = 0
        # as on the training path, and must come out finite
        do = randn(B, H, T, hd) * rows[..., None].to(torch.bfloat16)
        got = flash_attention_backward(q, k, v, valid, out, lse, do, causal)
        want = flash_attention_backward_reference(*_f32(q, k, v), valid, out.float(),
                                                  lse, do.float(), causal)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(reference_attention(*leaves, valid, causal), leaves, do)
        hold_tiles(torch, f"edge flash_bwd B={B} H={H} KV={KV} T={T} hd={hd} "
                   f"causal={causal}", list(zip(("dq", "dk", "dv"), got, want, plain)))
        for label, g, w, b in zip(("dq", "dk", "dv"), got, want, plain):
            hold(torch, f"edge flash_bwd {label} B={B} H={H} KV={KV} T={T} hd={hd} "
                 f"causal={causal}", [(label, g, w, b, None)],
                 1e-2 * float(w.abs().max()))
        S = dkv_split(q, KV, causal)
        _, reduce, _ = dkv_schedule(B, KV, H // KV, T, causal, S)
        parts = max((r[4] for r in reduce), default=1)
        cut_tiles += parts > 1
        top = min(DKV_MAX_SPLITS,
                  H // KV * max(n for _, n in dkv_key_tile_steps(T, causal)))
        if B == 1 and T == 200 and S != top:
            fail(f"edge B=1 T=200: split S={S}, meant to be the largest, {top}")
        delta = (do.float() * out.float()).sum(-1)
        split = flash_bwd_dkv_split_reference(*_f32(q, k, v), valid, lse, delta,
                                              do.float(), causal, S)
        what = (f"edge flash_bwd vs the split's plain version, S={S} (at most {parts} "
                f"parts a key tile) B={B} T={T} hd={hd} causal={causal}")
        hold_tiles(torch, what, [("dk", got[1], split[0], split[0]),
                                 ("dv", got[2], split[1], split[1])])
        for label, g, w in zip(("dk", "dv"), got[1:], split):
            hold(torch, f"{what}: {label}", [(label, g, w, w, None)],
                 1e-2 * float(w.abs().max()))
        if causal:
            # a fully masked row with a NON-zero cotangent: finite, not NaN
            g_any = flash_attention_backward(q, k, v, valid, out, lse,
                                             randn(B, H, T, hd), causal)
            if not all(bool(torch.isfinite(g.float()).all()) for g in g_any):
                fail("flash backward: a fully masked row gave a non-finite gradient")
    if not cut_tiles:
        fail("no backward edge case cut a key tile into several parts")
    # K4 off the rollout's shape, each held per element within one bf16 ulp:
    # head_dim 64 at G 4 and 7, head_dim 128 at G 6; rows: a full window, a
    # range shorter than S tiles (197 keys over S = 8 splits of whole
    # tiles), one key, an empty window (zeros) and one past the cache
    # (filled > T_max: clamped)
    for H, KV, T, hd in ((32, 8, 300, 64), (14, 2, 257, 64), (12, 2, 130, 128)):
        B = 5
        q, k, v = randn(B, H, hd), randn(B, KV, T, hd), randn(B, KV, T, hd)
        start = torch.tensor([0, 3, 31, 100, 7], device="cuda", dtype=torch.int32)
        filled = torch.tensor([T, min(200, T), 32, 0, T + 40], device="cuda", dtype=torch.int32)
        S = decode_split_count_on_card(B, KV)
        out = decode_attention(q, k, v, start, filled)
        live = torch.arange(B, device="cuda") != 3
        hold_ulp(torch, f"edge decode_attention H={H} KV={KV} T={T} hd={hd} S={S}", [(
            "out", out, reference_decode_attention(*_f32(q, k, v), start, filled),
            reference_decode_attention(q, k, v, start, filled), live)])
        if out[3].float().abs().max() != 0:
            fail("decode_attention: a row with no valid slot must return zeros")


# --------------------------------------------------------------------------
# phase 3: the rollout-and-score path
# --------------------------------------------------------------------------

def check_graph_steps(what: str, timings: dict, monolithic: bool = True) -> None:
    """The decode loop ran as graph replays: at least one replay, and on a
    monolithic call fewer than `sync_every` predicated-off iterations
    (graph_steps_run - decode_steps)."""
    from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY

    run, steps = timings["graph_steps_run"], timings["decode_steps"]
    if timings["graph_replays"] <= 0:
        fail(f"{what}: the decode loop replayed no CUDA graph ({timings})")
    if monolithic and not 0 <= run - steps < SYNC_EVERY:
        fail(f"{what}: graph_steps_run {run} - decode_steps {steps} not in "
             f"[0, {SYNC_EVERY})")


def end_to_end(torch, max_tokens: int) -> tuple[dict, dict]:
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import run_rollout
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    cfg = build_config()
    if max_tokens != cfg.response_length:
        log(f"CUT: response_length/max_tokens {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    num_prompts = 4
    log(f"CUT: {num_prompts} prompts x sample_n={cfg.sample_n} "
        f"(the launcher's batch is 512 prompts)")
    timings: dict = {}
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = run_rollout(cfg, device="cuda", num_prompts=num_prompts, timings=timings)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    mcfg = out["mcfg"]
    L = mcfg.num_hidden_layers
    rows, resp = out["responses"].shape   # the kept (scored) rows
    decode_rows = num_prompts * cfg.sample_n
    ctx = out["context_length"]
    if rows != num_prompts:
        fail(f"{rows} scored rows, expected one kept sample per prompt ({num_prompts})")
    log(f"  model: {mcfg.num_hidden_layers} layers D={mcfg.hidden_size} "
        f"F={mcfg.intermediate_size} H={mcfg.num_attention_heads} "
        f"KV={mcfg.num_key_value_heads} V={mcfg.vocab_size} "
        f"attention_impl={mcfg.attention_impl} LoRA r={cfg.lora_r} alpha={cfg.lora_alpha}")
    log(f"  prompt width {ctx}, sampled {decode_rows} x {resp}, kept and scored "
        f"{rows}, decode steps {timings['decode_steps']}, graph steps run "
        f"{timings['graph_steps_run']} ({timings['graph_replays']} replays, capture "
        f"{timings['graph_capture_s'] * 1e3:.1f} ms, graph pool "
        f"{timings['graph_pool_bytes'] / 1e9:.3f} GB)")
    check_graph_steps("phase 3", timings)
    log(f"  launches: {counts}")
    log(f"  prefill_ms={timings['prefill_s'] * 1e3:.3f} "
        f"decode_tokens_per_s={decode_rows * timings['decode_steps'] / timings['decode_s']:.2f} "
        f"decode_s={timings['decode_s']:.3f} reward_ms={timings['reward_s'] * 1e3:.3f} "
        f"scoring_ms={timings['score_s'] * 1e3:.3f} "
        f"rollout_wall_s={timings['total_s']:.3f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # every kernel ran, as often as the path dictates
    chunk_rows = cfg.local_rollout_forward_batch_size or max(
        1, (22 * 2316) // (ctx + cfg.response_length))
    n_chunks = math.ceil(rows / min(rows, chunk_rows))
    expected = {
        "flash_fwd": L * (1 + 2 * n_chunks),        # prefill + policy/ref scoring
        "decode_attention": L * timings["graph_steps_run"],
        "fused_logprob": 2 * n_chunks,              # policy + ref
    }
    for name, want in expected.items():
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
        if counts[name] != want:
            fail(f"kernel {name}: {counts[name]} launches, expected {want}")

    lp, rlp = out["logprobs"], out["ref_logprobs"]
    import numpy as np

    if lp.shape != (rows, resp) or rlp.shape != (rows, resp):
        fail(f"logprob shapes {lp.shape}/{rlp.shape} != {(rows, resp)}")
    if not (np.isfinite(lp).all() and np.isfinite(rlp).all()):
        fail("non-finite logprobs")
    if (lp > 1e-3).any():
        fail("positive logprobs")
    if not np.isfinite(out["advantages"]).all():
        fail("non-finite advantages")
    # LoRA B starts at zero: the policy (with adapters) equals the ref
    d_pr = float(np.abs(lp - rlp).max())
    log(f"  policy vs ref (zero-init LoRA): max|diff|={d_pr:.3e}")
    if d_pr > 1e-3:
        fail("policy and ref logprobs differ at the zero-init LoRA")

    # the demo model's own init (projections N(0, 1/L), as in JAX) gives
    # attention scores of std ~50, so two bf16 routes through its 28 layers
    # diverge chaotically; the routes are compared on a well-scaled input
    small_reference(torch, mcfg, cfg, out["queries"], out["tokenizer"].pad_token_id)
    decode_profile(torch, mcfg, out["params"], out["lora_scale"],
                   dict(temperature=cfg.temperature, top_p=cfg.top_p, greedy=False,
                        top_k=cfg.rollout_top_k, approx_top_k=cfg.rollout_approx_top_k),
                   decode_rows, ctx + resp)
    return counts, timings


def decode_profile(torch, mcfg, params, lora_scale, sampling: dict, rows: int,
                   T: int) -> None:
    """Where a decode step's time goes, eager against graph replay:
    torch.profiler over one chunk of `sync_every` iterations of the
    monolithic loop's body (`sampler._decode_body`, sampling included) at
    `rows` rows with the cache half full, run eagerly with the per-step
    loop's host check after each step, and over one replay of the same
    chunk captured into a CUDA graph — for each, wall and device busy ms a
    step (busy: the sum of kernel times), the idle share, kernel launches a
    step and the largest kernels; then the wall of three chunks of each
    with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.sampler import sampler as ts
    from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY, ChunkedLoop

    S = SYNC_EVERY
    Tp = T // 2
    max_tokens = T - Tp
    dev = "cuda"
    key_mask = torch.zeros((rows, T), dtype=torch.bool, device=dev)
    key_mask[:, :Tp] = True
    state = {"step": torch.ones((), dtype=torch.int64, device=dev),
             "out": torch.zeros((rows, max_tokens), dtype=torch.int64, device=dev),
             "lp_out": torch.zeros((rows, max_tokens), dtype=torch.float32, device=dev),
             "caches": tm.init_kv_cache(mcfg, rows, T, device=dev), "key_mask": key_mask,
             "done": torch.zeros((rows,), dtype=torch.bool, device=dev),
             "cur_tok": torch.full((rows,), 5, dtype=torch.int64, device=dev),
             "prompt_len": torch.full((rows,), Tp, dtype=torch.int64, device=dev),
             "table": None, "page_size": 0}
    gen = torch.Generator(device=dev).manual_seed(0)

    def body():
        ts._decode_body(params, mcfg, state, Tp=Tp, max_tokens=max_tokens,
                        eos_token_id=-1, pad_token_id=0, lora_scale=lora_scale,
                        capture_logprobs=False, generator=gen, **sampling)

    loop = ChunkedLoop(body, sync_every=S, device=dev, generator=gen, what="profiled")

    def chunk(mode):
        if mode == "eager":
            for _ in range(S):
                body()
                bool(ts._loop_active(state, max_tokens))  # the per-step host check
        else:
            loop.run_chunk()
            bool(ts._loop_active(state, max_tokens))      # the chunk's host check

    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    with torch.no_grad():
        loop.run_chunk()        # the warm-up chunk (eager)
        loop.run_chunk()        # the capture and its first replay
        torch.cuda.synchronize()
        for mode in ("eager", "graph"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                chunk(mode)
                wall_us = (time.perf_counter() - t0) * 1e6
            kernels = [e for e in prof.key_averages() if e.device_type == cuda]
            busy_us = sum(e.self_device_time_total for e in kernels)
            r = {"wall_ms": wall_us / S / 1e3,
                 "busy_ms": busy_us / S / 1e3 if busy_us > 0 else None,
                 "idle": 1 - busy_us / wall_us if busy_us > 0 else None,
                 "launches": sum(e.count for e in kernels) / S if busy_us > 0 else None}
            res[mode] = r
            if r["busy_ms"] is None:
                log(f"  decode-step profile, {mode} ({rows} rows, cache {Tp}/{T}, one "
                    f"chunk of {S} steps): wall {r['wall_ms']:.3f} ms/step; the profiler "
                    f"recorded no device time: busy time, idle share and launches not "
                    f"measured")
                continue
            log(f"  decode-step profile, {mode} ({rows} rows, cache {Tp}/{T}, one "
                f"chunk of {S} steps, profiler on): wall {r['wall_ms']:.3f} ms/step, device "
                f"busy {r['busy_ms']:.3f} ms/step, idle share {r['idle']:.3f}, kernel "
                f"launches {r['launches']:.1f}/step")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"    {e.self_device_time_total / S / 1e3:8.3f} ms/step  "
                    f"x{e.count / S:<6.1f} {e.key[:90]}")
            k4 = [e for e in kernels if "decode_kernel" in e.key]
            log(f"    K4 (decode_attention) device time per decode step: "
                f"{sum(e.self_device_time_total for e in k4) / S / 1e3:.4f} ms over "
                f"{sum(e.count for e in k4) / S:.1f} launches")
        # the same chunk timed on the card's clock, profiler off
        for mode in ("eager", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                chunk(mode)
            res[mode]["wall_ms_noprof"] = (time.perf_counter() - t0) / (3 * S) * 1e3
        log(f"  decode step wall, profiler off, 3 chunks of {S}: eager "
            f"{res['eager']['wall_ms_noprof']:.3f} ms/step, graph replay "
            f"{res['graph']['wall_ms_noprof']:.3f} ms/step "
            f"({res['graph']['wall_ms_noprof'] / res['eager']['wall_ms_noprof']:.3f} of eager)")
    if not loop.replays:
        fail("the profiled decode chunk never replayed a graph")


def small_reference(torch, mcfg, cfg, queries, pad_id: int) -> None:
    """The same model code through the kernels and through the plain path
    on a small input — 2 layers at the full Qwen2.5-1.5B width, projections
    N(0, 1/fan_in), LoRA B non-zero — teacher-forced through prefill and
    decode steps, then scored. Both bf16 routes are held against the plain
    path in f32: the kernel route must be no less accurate than the plain
    route (error at most 2x the plain route's)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.lora import LoraConfig, init_lora_params
    from nanorlhf_tpu_torch.trainer.scoring import score_chunk

    small = dataclasses.replace(mcfg, num_hidden_layers=2, attention_impl="auto")
    plain = dataclasses.replace(small, attention_impl="xla")
    plain_cfg = dataclasses.replace(cfg, fused_logprob_impl="lax")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    params = tm.init_params(small, seed=cfg.seed, device="cuda")
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(math.sqrt(2 / entry["kernel"].shape[-1]))
    lora = LoraConfig(r=cfg.lora_r, alpha=cfg.lora_alpha)
    params["lora"] = init_lora_params(small, lora, gen, device="cuda")
    for ab in params["lora"]["layers"].values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    params_f32 = _tree_map(lambda t: t.float(), params)

    q = torch.as_tensor(queries, device="cuda").long()
    mask = q != pad_id
    B, Tp = q.shape
    n_steps = 32
    toks = torch.randint(3, 4096, (B, n_steps), generator=gen, device="cuda")
    qr = torch.cat([q, toks], 1)
    logits, lps = {}, {}
    routes = (("kernel", small, cfg, params), ("plain", plain, plain_cfg, params),
              ("f32", plain, plain_cfg, params_f32))
    with torch.no_grad():
        for name, c, rc, p in routes:
            dtype = p["embed_tokens"].dtype
            caches = tm.init_kv_cache(c, B, Tp + n_steps, dtype=dtype, device="cuda")
            first, caches = tm.prefill(p, c, q, mask, caches, lora.scale)
            steps = [first]
            key_mask = torch.zeros((B, Tp + n_steps), dtype=torch.bool, device="cuda")
            key_mask[:, :Tp] = mask
            plen = mask.sum(1)
            for s in range(1, n_steps):
                key_mask[:, Tp + s - 1] = True
                lg, caches = tm.decode_step(p, c, toks[:, s - 1], plen + s - 1,
                                            Tp + s - 1, key_mask, caches, lora.scale)
                steps.append(lg)
            logits[name] = torch.stack(steps, 1).float()
            lps[name] = score_chunk(p, None, c, rc, qr, Tp, pad_id, lora.scale)[0].float()
    errs = {}
    for what, vals in (("logits", logits), ("logprobs", lps)):
        for route in ("kernel", "plain"):
            errs[what, route] = float((vals[route] - vals["f32"]).abs().max())
    log(f"  small-input reference (2 layers, full width, {B} rows x {n_steps} tokens, "
        f"max|err| vs f32): prefill+decode logits kernel {errs['logits', 'kernel']:.3e} "
        f"plain {errs['logits', 'plain']:.3e}; scoring logprobs kernel "
        f"{errs['logprobs', 'kernel']:.3e} plain {errs['logprobs', 'plain']:.3e}")
    for what in ("logits", "logprobs"):
        k, p = errs[what, "kernel"], errs[what, "plain"]
        if not (math.isfinite(k) and math.isfinite(p)) or k > 2 * p:
            fail(f"kernel route {what} less accurate than the plain route on the small input")


# --------------------------------------------------------------------------
# phase 4: one GRPO update
# --------------------------------------------------------------------------

def train_update(torch, max_tokens: int, bwd_seen, fwd_seen, fused_seen) -> dict:
    import os
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
    from nanorlhf_tpu_torch.trainer.optim import flatten

    cfg = one_card_cut(build_config())
    if max_tokens != cfg.response_length:
        log(f"CUT: response_length {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    # checkpoints go to a git-ignored directory of the checkout, removed after
    cfg.output_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "output", "chip_smoke_grpo")
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    trainer = build_trainer(cfg, device="cuda")
    log(f"CUT: {cfg.batch_size} prompts x sample_n={cfg.sample_n} per update "
        f"(per_device_train_batch_size={cfg.per_device_train_batch_size}, "
        f"gradient_accumulation_steps={cfg.gradient_accumulation_steps}, "
        f"num_mini_batches={cfg.num_mini_batches}; the launcher's batch is 512 prompts)")
    policy = flatten(trainer.params)
    trained = set(flatten(trainer.trainable))
    before = {p: t.detach().clone() for p, t in policy.items()}
    ref_before = {p: t.clone() for p, t in flatten(trainer.ref_params).items()}

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with recording_backward_shapes(bwd_seen), recording_forward_shapes(fwd_seen), \
            recording_fused_shapes(fused_seen):
        state = trainer.train(num_updates=1)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    upd = trainer.last_launches["update"]
    t = trainer.last_timings
    metrics = trainer.logger.latest()
    L = trainer.mcfg.num_hidden_layers
    n_steps = state["opt_steps"]
    n_micro = n_steps * cfg.gradient_accumulation_steps
    log(f"  launches: whole update {counts}; update half {upd}; "
        f"rollout-and-score half {trainer.last_launches['rollout_and_score']}")
    # full remat: each layer's forward runs once in the loss and once more
    # when the backward recomputes it
    expected = {"flash_fwd": 2 * L * n_micro, "flash_bwd_dq": L * n_micro,
                "flash_bwd_dkv": L * n_micro, "fused_logprob": n_micro,
                "decode_attention": 0}
    for name, want in expected.items():
        if upd[name] != want:
            fail(f"update half: kernel {name} launched {upd[name]} times, expected {want}")
    # the contiguous exact cache: every kernel but the paged and int8
    # decode kernels and the verify kernels (phases 5, 6 and 7 run those)
    other_paths = ("paged_decode_attention", "decode_attention_q8",
                   "paged_decode_attention_q8", "decode_verify_attention",
                   "paged_decode_verify_attention")
    for name in _build.KERNELS:
        if name in other_paths:
            if counts[name] != 0:
                fail(f"kernel {name} ran on the contiguous exact path")
        elif counts[name] <= 0:
            fail(f"kernel {name} was never launched in the GRPO update")

    loss, gnorm = metrics["loss/policy_avg_new"], metrics["policy/grad_norm_new"]
    first_kl = trainer.last_stats[0]["approxkl"]
    tokens = metrics["perf/tokens_per_sec_update"]
    log(f"  update: {n_steps} optimizer steps x {cfg.gradient_accumulation_steps} "
        f"microbatches of {cfg.per_device_train_batch_size} rows; loss {loss:.6e}, "
        f"grad_norm {gnorm:.6e}, first-minibatch approxkl {first_kl:.3e}, "
        f"lr {metrics['lr']:.3e}, entropy {metrics['policy/entropy_avg_new']:.4f}")
    log(f"  update_wall_s={t['update_s']:.3f} per_optimizer_step_s="
        f"{t['update_s'] / n_steps:.3f} update_tokens_per_s={tokens:.2f} "
        f"rollout_s={t['generate_s']:.3f} scoring_ms={t['score_s'] * 1e3:.3f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"checkpoint_blocking_s={trainer.last_save_s:.3f} "
        f"checkpoint_writer_s={trainer.ckpt.last_write_s:.3f}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or gnorm <= 0:
        fail("update: loss / grad norm not finite, or a zero gradient")
    # new and old logprobs of the first minibatch come from the same kernels
    # on the same weights: only summation order may differ (|Δlogp| ≲ 1e-2)
    if not first_kl < 1e-4:
        fail(f"first-minibatch approxkl {first_kl:.3e} >= 1e-4: the update's "
             "logprobs disagree with the scoring pass's")
    after = flatten(trainer.params)
    moved_b = [p for p in trained if p[-1] == "b"
               and not torch.equal(after[p].detach(), before[p])]
    if not moved_b:
        fail("no LoRA B leaf moved")
    frozen_moved = [p for p in policy if p not in trained
                    and not torch.equal(after[p].detach(), before[p])]
    ref_moved = [p for p, v in flatten(trainer.ref_params).items()
                 if not torch.equal(v, ref_before[p])]
    if frozen_moved or ref_moved:
        fail(f"frozen leaves moved: base {frozen_moved[:3]} ref {ref_moved[:3]}")
    log(f"  moved: {len(moved_b)} LoRA B leaves; trainable leaves "
        f"{len(trained)}, frozen base and ref unchanged")

    step = trainer.ckpt.latest_step()
    if step != state["global_step"]:
        fail(f"no checkpoint for step {state['global_step']} (latest {step})")
    saved = trainer.ckpt.restore(step, "cuda")
    live = flatten(trainer.trainable)
    same = set(flatten(saved["params"])) == set(live) and all(
        torch.equal(t, live[p].detach()) for p, t in flatten(saved["params"]).items())
    opt, saved_opt = trainer.opt_state["policy"], saved["opt_state"]["policy"]
    same = same and all(
        torch.equal(t, flatten(getattr(opt, m))[p])
        for m in ("mu", "nu") for p, t in flatten(saved_opt[m]).items())
    if not same or int(saved_opt["count"]) != opt.count:
        fail("the checkpoint does not reload to the trained tensors")
    log(f"  checkpoint-{step} reloads to the same tensors "
        f"({len(flatten(saved['params']))} leaves + optimizer state)")
    small_grad_reference(torch, trainer)
    trainer.close()
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    return counts


# --------------------------------------------------------------------------
# phase 5: one GRPO update over continuous batching (the paged KV cache)
# --------------------------------------------------------------------------

def paged_update(torch, max_tokens: int) -> dict:
    """`one_card_cut(build_config())` with rollout_page_size=128 and
    rollout_decode_rows=32 through `build_trainer`/`train(1)`: 16 prompts ×
    4 samples = 64 rows, 32 resident, the other 32 admitted mid-loop as
    rows finish. Checks the launch counts (K7 once per layer and decode
    iteration the session's graph replays ran, K4 never, one flash forward per layer for the batched
    bootstrap and for each single-row admission), the pool statistics, the
    metrics rows, the update (finite loss and grad norm, LoRA moved, ref
    not) and the checkpoint; prints the phase timings and peak memory."""
    import json as _json
    import os
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
    from nanorlhf_tpu_torch.trainer.optim import flatten

    cfg = one_card_cut(build_config())
    cfg.rollout_page_size, cfg.rollout_decode_rows = 128, 32
    if max_tokens != cfg.response_length:
        log(f"CUT: response_length {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    cfg.output_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "output", "chip_smoke_paged")
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    trainer = build_trainer(cfg, device="cuda")
    rows = cfg.batch_size * cfg.sample_n
    log(f"  {cfg.batch_size} prompts x {cfg.sample_n} samples = {rows} rows, "
        f"{cfg.rollout_decode_rows} resident, page size {cfg.rollout_page_size}")
    policy = flatten(trainer.params)
    trained = set(flatten(trainer.trainable))
    before = {p: t.detach().clone() for p, t in policy.items()}
    ref_before = {p: t.clone() for p, t in flatten(trainer.ref_params).items()}

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.train(num_updates=1)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches, t, pages = trainer.last_launches, trainer.last_timings, trainer.pages_status
    L = trainer.mcfg.num_hidden_layers
    iters = int(pages["decode_iterations"])
    admitted = int(pages["admitted_midloop"])
    log(f"  launches: whole update {counts}; generate {launches['generate']}; "
        f"score {launches['score']}; update half {launches['update']}")
    log(f"  pages: {pages}; session counters {trainer.session_status['counters']}")
    check_graph_steps("phase 5", t, monolithic=False)
    gen_expected = {"paged_decode_attention": L * t["graph_steps_run"], "decode_attention": 0,
                    "flash_fwd": L * (1 + admitted), "decode_attention_q8": 0,
                    "paged_decode_attention_q8": 0, "decode_verify_attention": 0,
                    "paged_decode_verify_attention": 0}
    n_micro = state["opt_steps"] * cfg.gradient_accumulation_steps
    upd_expected = {"flash_fwd": 2 * L * n_micro, "flash_bwd_dq": L * n_micro,
                    "flash_bwd_dkv": L * n_micro, "fused_logprob": n_micro}
    for half, expected in (("generate", gen_expected), ("update", upd_expected)):
        for name, want in expected.items():
            if launches[half][name] != want:
                fail(f"paged update, {half}: kernel {name} launched "
                     f"{launches[half][name]} times, expected {want}")
    if counts["decode_attention"] != 0 or counts["paged_decode_attention"] <= 0:
        fail("paged update: K4 ran or K7 did not")
    if admitted != rows - cfg.rollout_decode_rows:
        fail(f"admitted_midloop {admitted}, expected {rows - cfg.rollout_decode_rows}")
    if not pages["pages_recycled"] > 0 or not 0 < pages["page_utilization"] <= 1:
        fail(f"paged stats inconsistent: {pages}")
    metrics = trainer.logger.latest()
    with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as fh:
        row = _json.loads(fh.readlines()[-1])
    missing = [k for k in ("rollout/page_utilization", "rollout/pages_recycled",
                           "rollout/admitted_midloop", "session/dispatch_events")
               if k not in row]
    if missing:
        fail(f"metrics.jsonl lacks {missing}")
    loss, gnorm = metrics["loss/policy_avg_new"], metrics["policy/grad_norm_new"]
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or gnorm <= 0:
        fail("paged update: loss / grad norm not finite, or a zero gradient")
    after = flatten(trainer.params)
    moved_b = [p for p in trained if p[-1] == "b"
               and not torch.equal(after[p].detach(), before[p])]
    ref_moved = [p for p, v in flatten(trainer.ref_params).items()
                 if not torch.equal(v, ref_before[p])]
    if not moved_b or ref_moved:
        fail(f"paged update: LoRA B moved {len(moved_b)}, ref moved {ref_moved[:3]}")
    if trainer.ckpt.latest_step() != state["global_step"]:
        fail("paged update: no checkpoint written")
    n_steps = state["opt_steps"]
    log(f"  rollout_s={t['generate_s']:.3f} (prefill+admissions {t['prefill_s']:.3f} s "
        f"for 1 batched prefill + {t['admissions']} single-row admissions; decode "
        f"{t['decode_s']:.3f} s, {iters} iterations, "
        f"{t['decode_s'] / max(iters, 1) * 1e3:.3f} ms/step, graph pool "
        f"{t['graph_pool_bytes'] / 1e9:.3f} GB) "
        f"scoring_ms={t['score_s'] * 1e3:.3f} update_wall_s={t['update_s']:.3f} "
        f"({t['update_s'] / n_steps:.3f} s/step, "
        f"{metrics['perf/tokens_per_sec_update']:.2f} update tokens/s) "
        f"checkpoint_blocking_s={trainer.last_save_s:.3f} "
        f"checkpoint_writer_s={trainer.ckpt.last_write_s:.3f} peak_mem_gb={peak / 1e9:.2f}")
    log(f"  update: loss {loss:.6e}, grad_norm {gnorm:.6e}, {len(moved_b)} LoRA B "
        f"leaves moved, ref unchanged; page_utilization "
        f"{row['rollout/page_utilization']:.4f}, pages_recycled "
        f"{row['rollout/pages_recycled']:.0f}, admitted_midloop "
        f"{row['rollout/admitted_midloop']:.0f}")
    trainer.close()
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    return counts


def _small_model(torch, mcfg, seed: int, **over):
    """The 2-layer, full-width, well-scaled model of `small_reference`
    (projections N(0, 1/fan_in) instead of the demo init's N(0, 1/L)):
    (config, params)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm

    small = dataclasses.replace(mcfg, num_hidden_layers=2, attention_impl="auto", **over)
    params = tm.init_params(small, seed=seed, device="cuda")
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(math.sqrt(2 / entry["kernel"].shape[-1]))
    return small, params


def _row_lengths(tokens, eos: int, max_tokens: int) -> list[int]:
    """Generated length of each row (its stop token included)."""
    out = []
    for row in tokens:
        hits = (row == eos).nonzero()[0]
        out.append(int(hits[0]) + 1 if hits.size else max_tokens)
    return out


def _fixed_schedule(lengths, rows: int) -> int:
    """Decode iterations of the fixed-batch schedule: waves of `rows`, each
    running until its longest row is done."""
    return sum(max(lengths[i:i + rows]) - 1 for i in range(0, len(lengths), rows))


def _queued_schedule(lengths, rows: int, sync_every: int = 8) -> int:
    """Decode iterations the queued scheduler takes for rows of these
    lengths (queue order): `rows` resident, finished rows replaced at each
    sync (every `sync_every` iterations, or as soon as all are done)."""
    left = [n - 1 for n in lengths[:rows]]
    nxt, it = rows, 0
    while True:
        for _ in range(sync_every):
            if all(n <= 0 for n in left):
                break
            left = [n - 1 for n in left]
            it += 1
        for r in range(len(left)):
            if left[r] <= 0 and nxt < len(lengths):
                left[r], nxt = lengths[nxt] - 1, nxt + 1
            elif left[r] <= 0:
                left[r] = -10**9  # empty
        if nxt >= len(lengths) and all(n <= 0 for n in left):
            return it


def staggered_queue(torch, mcfg, queries, pad_id: int) -> None:
    """Continuous batching with rows of staggered lengths, at full width on
    the 2-layer model (the demo model never samples its EOS, so in phase 5
    every row runs to the end and admissions cannot save anything).

    The queue: one prompt's greedy continuation (no stop token, 96 tokens)
    cut at 16 depths (0, 4, ..., 60 tokens appended to the prompt), so the
    rows continue one text from different points and share its tokens at
    shifted positions (greedy rows of unrelated prompts share almost none).
    A first contiguous greedy pass over the queue without a stop token
    gives each row's tokens; the stop token is the one whose first
    occurrences give the largest gain of the scheduler's own schedule
    (`_queued_schedule`) over the fixed batch (`_fixed_schedule`). Then the
    queued greedy rows (4 resident of 16) are held against the contiguous
    greedy rows token for token, and the scheduler must finish in fewer
    decode iterations than the fixed-batch schedule of its own rows'
    lengths. Where a row differs, the monolithic paged route (the same
    batch as the contiguous one) must equal it token for token, and the
    first differing position of the queued row and the contiguous route's
    top-2 logit margin there are printed."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate

    small, params = _small_model(torch, mcfg, seed=11)
    M, R, P, depth = 96, 4, 16, 4

    timings: dict = {}

    def run(ids, eos, **sp):
        stats = []
        timings.clear()
        out = generate(params, small, ids, ids != pad_id,
                       torch.Generator(device="cuda").manual_seed(0),
                       SamplingParams(greedy=True, max_tokens=M, **sp),
                       eos_token_id=eos, pad_token_id=pad_id, paged_stats_out=stats,
                       timings=timings)
        torch.cuda.synchronize()
        return out, (stats[0] if stats else None)

    base = torch.as_tensor(queries[0], device="cuda").long()
    base = base[base != pad_id]
    text = run(base[None], -1)[0][0]
    rows = [torch.cat([base, text[:depth * i]]) for i in range(16)]
    q = torch.full((16, max(len(r) for r in rows)), pad_id, dtype=torch.long,
                   device="cuda")
    for i, r in enumerate(rows):
        q[i, q.shape[1] - len(r):] = r
    free = run(q, -1)[0].cpu().numpy()

    def gain(t):
        lengths = _row_lengths(free, t, M)
        return _fixed_schedule(lengths, R) - _queued_schedule(lengths, R)

    eos = max(sorted(set(free.ravel().tolist()) - {pad_id}), key=gain)
    contiguous, _ = run(q, eos)
    _build.reset_launch_counts()
    queued, st = run(q, eos, page_size=P, decode_rows=R)
    counts = _build.launch_counts()
    lengths = _row_lengths(queued.cpu().numpy(), eos, M)
    fixed = _fixed_schedule(lengths, R)
    log(f"  staggered queue (2 layers, full width, 16 rows: one prompt's greedy "
        f"text cut at depths 0..{depth * 15}, {R} resident, P={P}, stop token "
        f"{eos}: of the first greedy pass's tokens, the one with the largest "
        f"predicted gain {gain(eos)}): lengths {lengths}; decode "
        f"iterations {st['decode_iterations']} (predicted "
        f"{_queued_schedule(lengths, R)}) vs fixed-batch {fixed}; admitted_midloop "
        f"{st['admitted_midloop']}, pages_recycled {st['pages_recycled']}, "
        f"launches {counts}")
    if not st["decode_iterations"] < fixed:
        fail("continuous batching did not beat the fixed-batch schedule")
    if st["admitted_midloop"] != 16 - R or counts["decode_attention"] != 0 \
            or counts["paged_decode_attention"] != small.num_hidden_layers * timings["graph_steps_run"]:
        fail(f"staggered queue: stats or launch counts off ({st}, {counts})")
    same = (queued == contiguous).all(dim=1)
    log(f"  queued rows equal to the contiguous greedy rows: {int(same.sum())}/16")
    if not bool(same.all()):
        mono, _ = run(q, eos, page_size=P)
        if not torch.equal(mono, contiguous):
            fail("the monolithic paged route differs from the contiguous one")
        log("  monolithic paged route (same batch) equals the contiguous route "
            "token for token")
        for r in (~same).nonzero()[:, 0].tolist():
            pos = int((queued[r] != contiguous[r]).nonzero()[0])
            seq = torch.cat([q[r], contiguous[r, :pos]])[None]
            logits = tm.padded_forward_logits(params, small, seq, pad_id)[0, -1].float()
            top2 = logits.topk(2).values
            log(f"    row {r}: first difference at token {pos}, contiguous top-2 "
                f"logit margin there {float(top2[0] - top2[1]):.4e}")
        # the queued rows still keep the output contract
        for row in queued.cpu().numpy():
            hits = (row == eos).nonzero()[0]
            if hits.size and (row[hits[0] + 1:] != pad_id).any():
                fail("a queued row continues past its stop token")


# --------------------------------------------------------------------------
# phase 6: rollout-and-score with the int8 KV cache
# --------------------------------------------------------------------------

def int8_rollouts(torch, max_tokens: int) -> dict:
    """`run_rollout` with kv_cache_quant="int8", 4 prompts × 4 samples:
    contiguous (K5; K4 never) and paged + queued with 8 resident rows (K8;
    K7 never). Prints the decode ms per step and the cache bytes per row
    against the exact cache's; then, on the 2-layer small input, the int8
    routes' decode-step logits against the exact route in f32 beside the
    exact bf16 route's error."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import run_rollout
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    out_counts = {}
    for label, page, rows_res in (("contiguous", 0, 0), ("paged+queued", 128, 8)):
        cfg = build_config()
        cfg.kv_cache_quant = "int8"
        cfg.rollout_page_size, cfg.rollout_decode_rows = page, rows_res
        cfg.response_length = max_tokens
        timings: dict = {}
        _build.reset_launch_counts()
        out = run_rollout(cfg, device="cuda", num_prompts=4, timings=timings)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        mcfg = out["mcfg"]
        L, hd = mcfg.num_hidden_layers, mcfg.actual_head_dim
        KV = mcfg.num_key_value_heads
        steps, run = timings["decode_steps"], timings["graph_steps_run"]
        check_graph_steps(f"int8 {label}", timings, monolithic=not page)
        want = {"decode_attention": 0, "paged_decode_attention": 0,
                "decode_attention_q8": 0 if page else L * run,
                "paged_decode_attention_q8": L * run if page else 0}
        for name, n in want.items():
            if counts[name] != n:
                fail(f"int8 {label}: kernel {name} launched {counts[name]} times, "
                     f"expected {n}")
        lp = out["logprobs"]
        import numpy as np

        if not np.isfinite(lp).all() or lp.shape != out["responses"].shape:
            fail(f"int8 {label}: logprobs not finite or of the wrong shape")
        T = out["context_length"] + max_tokens
        int8_bytes = 2 * L * KV * T * (hd + 2)
        exact_bytes = 2 * L * KV * T * hd * 2
        log(f"  int8 {label}: {16} rows x {max_tokens} tokens, {steps} decode steps, "
            f"decode {timings['decode_s'] / max(steps, 1) * 1e3:.3f} ms/step, rollout "
            f"{timings['generate_s']:.3f} s; cache bytes per row {int8_bytes} (int8 + "
            f"bf16 scales) vs {exact_bytes} exact ({exact_bytes / int8_bytes:.3f}x); "
            f"launches {counts}")
        out_counts[label] = counts
        queries, pad_id = out["queries"], out["tokenizer"].pad_token_id
    int8_small_reference(torch, mcfg, queries, pad_id)
    return out_counts


def int8_small_reference(torch, mcfg, queries, pad_id: int) -> None:
    """Prefill + 16 teacher-forced decode steps on the 2-layer full-width
    model: the int8 routes (contiguous K5, paged K8) and the exact bf16
    route (K4) against the exact plain route in f32. The two int8 routes
    must agree bit for bit and stay within 8x the exact bf16 route's error
    (the int8 cache rounds K/V to 1/254 of each (slot, head) row's absmax,
    bf16 to 2^-9 relative)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm

    small, params = _small_model(torch, mcfg, seed=3)
    q = torch.as_tensor(queries, device="cuda").long()
    mask = q != pad_id
    B, Tp = q.shape
    n_steps = 16
    toks = torch.randint(3, 4096, (B, n_steps),
                         generator=torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    f32 = _tree_map(lambda t: t.float(), params)
    plain = dataclasses.replace(small, attention_impl="xla")
    q8 = dataclasses.replace(small, kv_cache_quant="int8")
    T = Tp + n_steps
    P = 8
    nb = -(-T // P)
    table = torch.arange(B * nb, device="cuda", dtype=torch.int32).reshape(B, nb)
    routes = {"f32": (plain, f32, None), "exact bf16": (small, params, None),
              "int8 contiguous": (q8, params, None), "int8 paged": (q8, params, table)}
    logits = {}
    with torch.no_grad():
        for name, (c, p, tab) in routes.items():
            kw = {}
            if tab is None:
                caches = tm.init_kv_cache(c, B, T, dtype=p["embed_tokens"].dtype,
                                          device="cuda")
            else:
                caches = tm.init_paged_kv_cache(c, B * nb, P, device="cuda")
                kw = dict(page_table=tab, page_size=P)
            first, caches = tm.prefill(p, c, q, mask, caches,
                                       **(dict(kw, logical_len=T) if kw else {}))
            key_mask = torch.zeros((B, T), dtype=torch.bool, device="cuda")
            key_mask[:, :Tp] = mask
            plen = mask.sum(1)
            steps = []
            for s in range(1, n_steps):
                key_mask[:, Tp + s - 1] = True
                lg, caches = tm.decode_step(p, c, toks[:, s - 1], plen + s - 1,
                                            Tp + s - 1, key_mask, caches, **kw)
                steps.append(lg)
            logits[name] = torch.stack(steps, 1).float()
    errs = {k: float((v - logits["f32"]).abs().max()) for k, v in logits.items()
            if k != "f32"}
    log(f"  int8 small-input reference (2 layers, full width, {B} rows, "
        f"{n_steps - 1} decode steps, max|logits - f32 exact|): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not torch.equal(logits["int8 contiguous"], logits["int8 paged"]):
        fail("int8 contiguous and paged routes differ on the same input")
    if not all(math.isfinite(v) for v in errs.values()) \
            or errs["int8 contiguous"] > 8 * errs["exact bf16"]:
        fail("int8 route error beyond 8x the exact bf16 route's")


# --------------------------------------------------------------------------
# phase 7: speculative decode
# --------------------------------------------------------------------------

def spec_update(torch, max_tokens: int, bwd_seen, fused_seen) -> dict:
    """(a) `one_card_cut(build_config(rollout_spec_k=4))` through
    `build_trainer`/`train(1)` over the contiguous cache: the generation
    half launches K6 once per layer and verify step, K4 never, and the
    flash forward once per layer (the one shared-prompt prefill); the three
    rollout/* speculative rows are logged; the update and the checkpoint
    hold as in phase 4."""
    import os
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
    from nanorlhf_tpu_torch.trainer.optim import flatten

    cfg = one_card_cut(build_config(rollout_spec_k=4))
    if max_tokens != cfg.response_length:
        log(f"CUT: response_length {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    cfg.output_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "output", "chip_smoke_spec")
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    trainer = build_trainer(cfg, device="cuda")
    log(f"  {cfg.batch_size} prompts x {cfg.sample_n} samples, spec_k "
        f"{cfg.rollout_spec_k}, spec_ngram {cfg.rollout_spec_ngram}, contiguous cache")
    trained = set(flatten(trainer.trainable))
    before = {p: t.detach().clone() for p, t in flatten(trainer.params).items()
              if p in trained}
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with recording_backward_shapes(bwd_seen), recording_fused_shapes(fused_seen):
        state = trainer.train(num_updates=1)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches, t = trainer.last_launches, trainer.last_timings
    metrics = trainer.logger.latest()
    L = trainer.mcfg.num_hidden_layers
    steps = t["decode_steps"]
    log(f"  launches: whole update {counts}; generate {launches['generate']}")
    rows = {k: metrics[k] for k in ("rollout/draft_acceptance", "rollout/accepted_per_step",
                                    "rollout/spec_verify_steps")}
    log(f"  metrics rows: {rows}")
    if rows["rollout/spec_verify_steps"] != steps or not all(
            math.isfinite(v) for v in rows.values()):
        fail(f"spec update: metrics rows {rows} disagree with {steps} verify steps")
    check_graph_steps("phase 7a", t)
    gen_expected = {"decode_verify_attention": L * t["graph_steps_run"], "decode_attention": 0,
                    "flash_fwd": L, "paged_decode_verify_attention": 0,
                    "paged_decode_attention": 0, "decode_attention_q8": 0,
                    "paged_decode_attention_q8": 0}
    for name, want in gen_expected.items():
        if launches["generate"][name] != want:
            fail(f"spec update, generate: kernel {name} launched "
                 f"{launches['generate'][name]} times, expected {want}")
    loss, gnorm = metrics["loss/policy_avg_new"], metrics["policy/grad_norm_new"]
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or gnorm <= 0:
        fail("spec update: loss / grad norm not finite, or a zero gradient")
    after = flatten(trainer.params)
    moved_b = [p for p in before if p[-1] == "b" and not torch.equal(after[p].detach(),
                                                                      before[p])]
    if not moved_b or trainer.ckpt.latest_step() != state["global_step"]:
        fail(f"spec update: {len(moved_b)} LoRA B leaves moved, checkpoint "
             f"{trainer.ckpt.latest_step()}")
    n_steps = state["opt_steps"]
    n_micro = n_steps * cfg.gradient_accumulation_steps
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if launches["update"][name] != L * n_micro:
            fail(f"spec update, update half: kernel {name} launched "
                 f"{launches['update'][name]} times, expected {L * n_micro}")
    log(f"  rollout_s={t['generate_s']:.3f} (prefill {t['prefill_s'] * 1e3:.3f} ms; "
        f"{steps} verify steps in {t['decode_s']:.3f} s, "
        f"{t['decode_s'] / max(steps, 1) * 1e3:.3f} ms per verify step, graph pool "
        f"{t['graph_pool_bytes'] / 1e9:.3f} GB, "
        f"{t['emitted_tokens']} tokens emitted, "
        f"{t['emitted_tokens'] / t['decode_s']:.2f} emitted tokens/s) "
        f"scoring_ms={t['score_s'] * 1e3:.3f} update_wall_s={t['update_s']:.3f} "
        f"({t['update_s'] / n_steps:.3f} s/step, "
        f"{metrics['perf/tokens_per_sec_update']:.2f} update tokens/s) "
        f"checkpoint_blocking_s={trainer.last_save_s:.3f} "
        f"checkpoint_writer_s={trainer.ckpt.last_write_s:.3f} peak_mem_gb={peak / 1e9:.2f}; "
        f"loss {loss:.6e}, grad_norm {gnorm:.6e}, {len(moved_b)} LoRA B leaves moved")
    trainer.close()
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    return counts


def spec_queued_rollout(torch, max_tokens: int) -> dict:
    """(b) `run_rollout` with rollout_spec_k=4 through the continuous-batching
    scheduler (page size 128, 32 resident rows, 16 prompts x 4 samples):
    K9 launched once per layer and draft + verify iteration the session's
    graph replays ran, K7, K6 and K4 never."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import run_rollout
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    cfg = build_config(rollout_spec_k=4)
    cfg.rollout_page_size, cfg.rollout_decode_rows = 128, 32
    cfg.response_length = max_tokens
    log(f"CUT: 16 prompts x {cfg.sample_n} samples of {max_tokens} tokens")
    timings: dict = {}
    _build.reset_launch_counts()
    out = run_rollout(cfg, device="cuda", num_prompts=16, timings=timings)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    L = out["mcfg"].num_hidden_layers
    pages, st = out["paged_stats"], out["spec_stats"]
    iters = int(pages["decode_iterations"])
    stats = {k: (v if isinstance(v, int) else int(v)) for k, v in st.items()
             if k != "accepted_rows"}
    log(f"  queued spec rollout: {iters} iterations ({timings['decode_s']:.3f} s, graph "
        f"pool {timings['graph_pool_bytes'] / 1e9:.3f} GB, "
        f"{timings['decode_s'] / max(iters, 1) * 1e3:.3f} ms per iteration, "
        f"{stats['emitted'] / timings['decode_s']:.2f} emitted tokens/s), "
        f"admitted_midloop {pages['admitted_midloop']}, page utilization "
        f"{pages['page_utilization']:.4f}; spec stats {stats}; launches {counts}")
    check_graph_steps("phase 7b", timings, monolithic=False)
    want = {"paged_decode_verify_attention": L * timings["graph_steps_run"],
            "paged_decode_attention": 0, "decode_verify_attention": 0,
            "decode_attention": 0}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"queued spec rollout: kernel {name} launched {counts[name]} times, "
                 f"expected {n}")
    import numpy as np

    if stats["verify_steps"] != iters or pages["admitted_midloop"] != 64 - 32 \
            or not np.isfinite(out["logprobs"]).all():
        fail(f"queued spec rollout: stats {stats} / {pages} inconsistent or "
             "logprobs not finite")
    return counts


def _cycle_model(torch, mcfg, cycle, peak: float = 12.0):
    """A 2-layer model at the full width whose greedy stream repeats `cycle`
    (the idea of the JAX package's "cycle model"): embedding row t is the
    unit vector e_t (t < D), lm_head maps e_t to peak·onehot(sigma(t)) with
    sigma the cycle on its tokens and the identity elsewhere, and the
    projections are random but small (N(0, 0.01/fan_in)), so the attention
    and the kernels run on real numbers while the argmax follows sigma."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm

    cfg = dataclasses.replace(mcfg, num_hidden_layers=2, tie_word_embeddings=False,
                              attention_impl="auto")
    params = tm.init_params(cfg, seed=5, device="cuda")
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(0.1 * math.sqrt(2 / entry["kernel"].shape[-1]))
    D, V = cfg.hidden_size, cfg.vocab_size
    sigma = torch.arange(D, device="cuda")
    sigma[torch.tensor(cycle, device="cuda")] = torch.tensor(cycle[1:] + cycle[:1],
                                                             device="cuda")
    params["embed_tokens"] = torch.zeros((V, D), dtype=torch.bfloat16, device="cuda")
    params["embed_tokens"][torch.arange(D), torch.arange(D)] = 1.0
    params["lm_head"] = torch.zeros((V, D), dtype=torch.bfloat16, device="cuda")
    params["lm_head"][sigma, torch.arange(D, device="cuda")] = peak / math.sqrt(D)
    return cfg, params


def spec_cycle(torch, mcfg, queries, pad_id: int) -> None:
    """(c) Multi-token acceptance on the card: on the 2-layer full-width
    cycle model, 16 rows whose prompts hold one turn of a 4-token cycle,
    greedy, 128 tokens, spec_k 4: the speculative streams (contiguous, K6;
    monolithic paged, K9) must equal the monolithic greedy stream token for
    token, in at most max_tokens / 2 verify steps, with draft acceptance
    above 0.5. Then the random well-scaled 2-layer model: greedy spec rows
    against greedy monolithic rows; where a row differs (the verify GEMM
    runs 5 rows per sequence, the decode GEMM 1, so bf16 rounds
    differently), the first difference and the monolithic route's top-2
    logit margin there are printed."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate

    M, k, B = 128, 4, 16
    cycle = [100, 101, 102, 103]
    cfg, params = _cycle_model(torch, mcfg, cycle)
    eos = cfg.vocab_size - 1                     # never emitted
    q = torch.tensor([[300 + i, 400 + i] + cycle[i % 4:] + cycle[:i % 4] + [cycle[i % 4]]
                      for i in range(B)], device="cuda")

    timings: dict = {}

    def run(model, ids, **sp):
        stats = []
        timings.clear()
        out = generate(model[1], model[0], ids, ids != pad_id,
                       torch.Generator(device="cuda").manual_seed(0),
                       SamplingParams(greedy=True, max_tokens=M, **sp),
                       eos_token_id=eos, pad_token_id=pad_id, spec_stats_out=stats,
                       timings=timings)
        torch.cuda.synchronize()
        return out, (stats[0] if stats else None)

    mono, _ = run((cfg, params), q)
    for label, kernel, sp in (("contiguous", "decode_verify_attention", {}),
                              ("paged P=16", "paged_decode_verify_attention",
                               dict(page_size=16))):
        _build.reset_launch_counts()
        spec, st = run((cfg, params), q, spec_k=k, **sp)
        counts = _build.launch_counts()
        steps = st["verify_steps"]
        acc = int(st["accepted"]) / max(int(st["drafted"]), 1)
        log(f"  cycle model ({label}, {B} rows x {M} tokens, spec_k {k}): {steps} verify "
            f"steps, draft acceptance {acc:.4f}, accepted per step "
            f"{int(st['emitted']) / max(int(st['row_steps']), 1):.3f}, {kernel} launches "
            f"{counts[kernel]}; equal to the monolithic greedy rows: "
            f"{int((spec == mono).all(dim=1).sum())}/{B}")
        if not torch.equal(spec, mono):
            fail(f"cycle model ({label}): speculative greedy tokens differ from the "
                 "monolithic ones")
        if steps * 2 > M or not acc > 0.5:
            fail(f"cycle model ({label}): {steps} verify steps, acceptance {acc:.3f}")
        if counts[kernel] != cfg.num_hidden_layers * timings["graph_steps_run"] \
                or counts["decode_attention"]:
            fail(f"cycle model ({label}): launch counts {counts}")

    small, sparams = _small_model(torch, mcfg, seed=13)
    rq = torch.as_tensor(queries, device="cuda").long()
    mono, _ = run((small, sparams), rq)
    spec, st = run((small, sparams), rq, spec_k=k)
    same = (spec == mono).all(dim=1)
    log(f"  random 2-layer model, greedy, {rq.shape[0]} rows x {M} tokens: spec rows "
        f"equal to the monolithic rows {int(same.sum())}/{rq.shape[0]} "
        f"({st['verify_steps']} verify steps)")
    for r in (~same).nonzero()[:, 0].tolist():
        pos = int((spec[r] != mono[r]).nonzero()[0])
        seq = torch.cat([rq[r], mono[r, :pos]])[None]
        logits = tm.padded_forward_logits(sparams, small, seq, pad_id)[0, -1].float()
        top2 = logits.topk(2).values
        log(f"    row {r}: first difference at token {pos}, monolithic top-2 logit "
            f"margin there {float(top2[0] - top2[1]):.4e}")


def spec_int8_rollout(torch) -> None:
    """(d) A short rollout with the int8 KV cache and spec_k=4, contiguous:
    the verify dequantizes (no K6, as JAX has no q8 k-query kernel), end to
    end with finite logprobs."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import run_rollout
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    cfg = build_config(rollout_spec_k=4)
    cfg.kv_cache_quant = "int8"
    cfg.response_length = 64
    timings: dict = {}
    _build.reset_launch_counts()
    out = run_rollout(cfg, device="cuda", num_prompts=4, timings=timings)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    import numpy as np

    log(f"  int8 + spec rollout (4 prompts x {cfg.sample_n} x 64 tokens): "
        f"{timings['decode_steps']} verify steps, "
        f"{timings['decode_s'] / max(timings['decode_steps'], 1) * 1e3:.3f} ms per step; "
        f"launches {counts}")
    if counts["decode_verify_attention"] or counts["decode_attention_q8"] \
            or counts["decode_attention"] or not np.isfinite(out["logprobs"]).all() \
            or "spec_stats" not in out:
        fail("int8 + spec rollout: a verify kernel ran on the int8 cache, or the "
             "rollout is not finite")


# --------------------------------------------------------------------------
# phase 8: the compiled decode loop, graph replay against the per-step body
# --------------------------------------------------------------------------

# (label, model config changes, SamplingParams fields, the kernel of the loop)
GRAPH_LOOPS = (
    ("contiguous", {}, {}, "decode_attention"),
    ("paged", {}, dict(page_size=128), "paged_decode_attention"),
    ("int8", dict(kv_cache_quant="int8"), {}, "decode_attention_q8"),
    ("int8 paged", dict(kv_cache_quant="int8"), dict(page_size=128),
     "paged_decode_attention_q8"),
    ("spec", {}, dict(spec_k=4), "decode_verify_attention"),
    ("spec paged", {}, dict(spec_k=4, page_size=128), "paged_decode_verify_attention"),
    ("queued", {}, dict(page_size=128, decode_rows=8), "paged_decode_attention"),
    ("spec queued", {}, dict(spec_k=4, page_size=128, decode_rows=8),
     "paged_decode_verify_attention"),
)


def _loop_counters(st_paged, st_spec, timings) -> dict:
    """The loop's counters: decode steps (iterations with a live row), and
    the queued session's iterations and admission schedule, the
    speculative acceptance counters and per-row accepted drafts."""
    c = {"decode_steps": timings["decode_steps"]}
    if st_paged and st_paged.get("decode_iterations") is not None:
        c["decode_iterations"] = st_paged["decode_iterations"]
        c["admissions"] = [(a["row"], a["queue_index"], a["iteration"])
                           for a in st_paged["admissions"]]
    if st_spec:
        for k, v in st_spec.items():
            c[k] = v.tolist() if hasattr(v, "tolist") else v
    return c


def graph_loops(torch, prompts, pad_id: int, max_tokens: int = 96) -> None:
    """Each decode loop — contiguous, paged, int8, int8 paged, speculative
    (spec_k 4) on both layouts, queued and queued speculative (8 of 16 rows
    resident, pages of 128) — at 16 rows on the full-depth Qwen2.5-1.5B
    model (random weights from the seed, no stop token), greedy, through
    `generate` twice: the per-step body (a host check before each step)
    and the chunked loop (graph replays). Holds the tokens and every
    counter equal row for row (the same kernels at the same shapes: a
    difference fails, after printing the first differing token and its
    top-2 logit margin); the graph run's launches of the loop's kernel
    equal L x graph_steps_run, of which L x sync_every x replays came from
    replays, and on a monolithic loop graph_steps_run - decode_steps <
    sync_every. Prints each loop's decode ms a step and peak memory, eager
    and graph (the graph's private pool holds a chunk's temporaries). Then
    sampled streams from one seed: whether graph and eager give equal
    tokens is printed, not required."""
    import dataclasses

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.sampler.graph import SYNC_EVERY
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate

    base = dataclasses.replace(_demo_config(), attention_impl="auto")
    params = tm.init_params(base, seed=8, device="cuda")
    L = base.num_hidden_layers
    ids = torch.as_tensor(prompts, device="cuda").long()
    rows = ids.shape[0]
    log(f"  {rows} rows x {max_tokens} tokens, {L} layers at full width, sync_every "
        f"{SYNC_EVERY}, greedy, no stop token")

    def run(cfg, sp, loop, seed=0, greedy=True):
        paged, spec, timings = [], [], {}
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = generate(params, cfg, ids, ids != pad_id,
                       torch.Generator(device="cuda").manual_seed(seed),
                       SamplingParams(greedy=greedy, max_tokens=max_tokens,
                                      decode_loop=loop, **sp),
                       eos_token_id=-1, pad_token_id=pad_id, timings=timings,
                       paged_stats_out=paged, spec_stats_out=spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timings["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return (out, _loop_counters(paged and paged[0], spec and spec[0], timings),
                timings, _build.launch_counts(), wall)

    for label, mc, sp, kernel in GRAPH_LOOPS:
        cfg = dataclasses.replace(base, **mc)
        eager, c_e, t_e, n_e, w_e = run(cfg, sp, "per_step")
        graph, c_g, t_g, n_g, w_g = run(cfg, sp, "chunked")
        queued = "decode_rows" in sp
        run_steps = t_g["graph_steps_run"]
        from_replays = n_g[kernel] - L * SYNC_EVERY   # the first chunk runs eagerly
        log(f"  {label}: eager {c_e['decode_steps']} steps in {t_e['decode_s']:.3f} s "
            f"({t_e['decode_s'] / max(c_e['decode_steps'], 1) * 1e3:.3f} ms/step), graph "
            f"{c_g['decode_steps']} steps in {t_g['decode_s']:.3f} s "
            f"({t_g['decode_s'] / max(c_g['decode_steps'], 1) * 1e3:.3f} ms/step, capture "
            f"{t_g['graph_capture_s'] * 1e3:.1f} ms, {t_g['graph_replays']} replays, "
            f"graph_steps_run {run_steps}); {kernel} launches eager {n_e[kernel]}, graph "
            f"{n_g[kernel]} ({from_replays} from replays); generate wall eager {w_e:.3f} s, "
            f"graph {w_g:.3f} s; peak memory eager {t_e['peak_gb']:.3f} GB, graph "
            f"{t_g['peak_gb']:.3f} GB (graph pool {t_g['graph_pool_bytes'] / 1e9:.3f} GB)")
        same = (graph == eager).all(dim=1)
        if not bool(same.all()):
            r = int((~same).nonzero()[0, 0])
            pos = int((graph[r] != eager[r]).nonzero()[0, 0])
            seq = torch.cat([ids[r], eager[r, :pos]])[None]
            logits = tm.padded_forward_logits(params, base, seq, pad_id)[0, -1].float()
            top2 = logits.topk(2).values
            fail(f"{label}: graph-replay tokens differ from the per-step body's in "
                 f"{int((~same).sum())}/{rows} rows; row {r} first at token {pos} "
                 f"(graph {int(graph[r, pos])}, eager {int(eager[r, pos])}, top-2 logit "
                 f"margin there {float(top2[0] - top2[1]):.4e})")
        if c_g != c_e:
            fail(f"{label}: counters differ: graph {c_g}, eager {c_e}")
        if n_e[kernel] != L * c_e["decode_steps"]:
            fail(f"{label}: the per-step body launched {kernel} {n_e[kernel]} times, "
                 f"expected L x decode_steps = {L * c_e['decode_steps']}")
        check_graph_steps(f"phase 8 {label}", t_g, monolithic=not queued)
        if n_g[kernel] != L * run_steps or from_replays != L * SYNC_EVERY * t_g["graph_replays"]:
            fail(f"{label}: {kernel} launched {n_g[kernel]} times in the graph run, "
                 f"expected L x graph_steps_run = {L * run_steps}, "
                 f"{L * SYNC_EVERY * t_g['graph_replays']} of them from replays")
    log(f"  every loop: graph-replay tokens and counters equal the per-step body's, "
        f"row for row")
    for label, sp in (("contiguous", {}), ("spec", dict(spec_k=4)),
                      ("queued", dict(page_size=128, decode_rows=8))):
        eager = run(base, sp, "per_step", seed=5, greedy=False)[0]
        graph = run(base, sp, "chunked", seed=5, greedy=False)[0]
        log(f"  sampled {label} (seed 5): graph and eager tokens equal in "
            f"{int((graph == eager).all(dim=1).sum())}/{rows} rows (printed, not required)")


def small_grad_reference(torch, trainer) -> None:
    """The LoRA gradients of one microbatch loss on a small input — 2 layers
    at the full Qwen2.5-1.5B width, projections N(0, 1/fan_in), LoRA B
    non-zero — through the kernels (flash fwd/bwd, fused logprob and its
    backward, full remat), through the plain bf16 route and through the
    plain route in f32. The kernel route must be no less accurate than the
    plain bf16 route against f32 (error at most 2x the plain route's, per
    leaf group, relative to the f32 gradient's scale)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.lora import LoraConfig, init_lora_params
    from nanorlhf_tpu_torch.ops.masking import INVALID_LOGPROB
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.update import microbatch_loss

    cfg = trainer.cfg
    small = dataclasses.replace(trainer.mcfg, num_hidden_layers=2, attention_impl="auto")
    plain = dataclasses.replace(small, attention_impl="xla")
    plain_cfg = dataclasses.replace(cfg, fused_logprob_impl="lax")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 7)
    params = tm.init_params(small, seed=cfg.seed, device="cuda")
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(math.sqrt(2 / entry["kernel"].shape[-1]))
    lora = LoraConfig(r=cfg.lora_r, alpha=cfg.lora_alpha)
    params["lora"] = init_lora_params(small, lora, gen, device="cuda")
    for ab in params["lora"]["layers"].values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    pad = trainer.tokenizer.pad_token_id
    B, Tp, Tr = 4, 24, 200
    q = torch.randint(3, 4096, (B, Tp), generator=gen, device="cuda")
    q[1, :5] = pad  # left padding
    resp = torch.randint(3, 4096, (B, Tr), generator=gen, device="cuda")
    pm = torch.zeros((B, Tr), dtype=torch.bool, device="cuda")
    pm[2, 150:] = True
    old = torch.randn((B, Tr), generator=gen, device="cuda") * 0.1 - 5.0
    mb = {"query_responses": torch.cat([q, resp], 1), "responses": resp,
          "padding_mask": pm, "padding_mask_p1": pm,
          "logprobs": torch.where(pm, INVALID_LOGPROB, old),
          "ref_logprobs": torch.where(pm, INVALID_LOGPROB, old + 0.05),
          "advantages": torch.where(pm, 0.0, torch.randn((B, Tr), generator=gen,
                                                         device="cuda"))}
    grads = {}
    for name, c, rc, dtype in (("kernel", small, cfg, torch.bfloat16),
                               ("plain", plain, plain_cfg, torch.bfloat16),
                               ("f32", plain, plain_cfg, torch.float32)):
        p = _tree_map(lambda t: t.to(dtype), params)
        leaves = flatten(p["lora"])
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = microbatch_loss(p, c, rc, mb, Tp, pad, lora.scale, remat=True)
        grads[name] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    errs = {}
    for route in ("kernel", "plain"):
        errs[route] = max(
            float((grads[route][k].float() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for k, g in grads["f32"].items())
    log(f"  small-input LoRA gradients (2 layers, full width, {B} rows x {Tp}+{Tr} "
        f"tokens, max over leaves of max|err| / max|g_f32|): kernel route "
        f"{errs['kernel']:.3e}, plain bf16 route {errs['plain']:.3e}")
    if not (math.isfinite(errs["kernel"]) and math.isfinite(errs["plain"])) \
            or errs["kernel"] > 2 * errs["plain"]:
        fail("kernel route LoRA gradients less accurate than the plain route")


# --------------------------------------------------------------------------
# phase 9: the other five algorithms
# --------------------------------------------------------------------------

ALGOS = ("rloo", "remax", "reinforce", "raft", "ppo")
# PPO's value-init phase, cut from the launcher's 500 prompts x 8 epochs
VALUE_INIT_CUT = dict(train_data_size=16, num_train_epochs=2, per_device_train_batch_size=4)


def phase9_shapes(prompt_width: int, value_width: int, short: int):
    """The K1 (B, H, KV, T, hd), K2/K3 (B, H, KV, T, hd), K10 (R, D, V,
    with_entropy, transposed) and K4 (B, T_max) shapes phase 9 gives the
    kernels at `short`-token responses: prefill of the 16 prompts;
    scoring of the 64 rows of RLOO and RAFT and the 16 of the others (and
    PPO's value pass); the update's 4-row microbatch (twice for PPO: the
    policy and the value tree); the value init over `value_width`-token
    prompts (the dataset's width, not de-padded, as in JAX): its rollout,
    scoring and 4-row regression."""
    fwd = {(b, 12, 2, t, 128) for t, bs in
           ((prompt_width, (16,)), (prompt_width + short, (64, 16, 4)),
            (value_width, (16,)), (value_width + short, (16, 4))) for b in bs}
    bwd = {(4, 12, 2, w + short, 128) for w in (prompt_width, value_width)}
    fused = {(rows * short, 1536, 151936, rows == 4, True) for rows in (64, 16, 4)}
    decode = {(b, prompt_width + short) for b in (64, 16)} | {(16, value_width + short)}
    return fwd, bwd, fused, decode


def small_value_reference(torch, mcfg, pad_id: int) -> None:
    """PPO's value forward (`score_forward`, sliced as the value pass
    slices it) on a small input — 2 layers at the full Qwen2.5-1.5B width,
    projections N(0, 1/fan_in), value LoRA B non-zero, a score head N(0,
    1/D) — through the kernels, the plain bf16 route and the plain route in
    f32: the kernel route must be no less accurate than the plain bf16
    route against f32 (error at most 2x the plain route's)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.lora import LoraConfig, init_lora_params

    small = dataclasses.replace(mcfg, num_hidden_layers=2, attention_impl="auto")
    plain = dataclasses.replace(small, attention_impl="xla")
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = tm.init_params(small, seed=9, device="cuda")
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(math.sqrt(2 / entry["kernel"].shape[-1]))
    lora = LoraConfig(r=64, alpha=16)
    params["lora"] = init_lora_params(small, lora, gen, device="cuda")
    for ab in params["lora"]["layers"].values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    params["score"] = tm.init_score_head(small, gen)
    B, Tp, Tr = 4, 24, 200
    q = torch.randint(3, 4096, (B, Tp), generator=gen, device="cuda")
    q[1, :5] = pad_id
    resp = torch.randint(3, 4096, (B, Tr), generator=gen, device="cuda")
    resp[2, 150:] = pad_id
    qr = torch.cat([q, resp], 1)
    vals = {}
    with torch.no_grad():
        for name, c, dtype in (("kernel", small, torch.bfloat16),
                               ("plain", plain, torch.bfloat16),
                               ("f32", plain, torch.float32)):
            p = _tree_map(lambda t: t.to(dtype), params)
            vals[name] = tm.score_forward(p, c, qr, pad_id,
                                          lora_scale=lora.scale)[:, Tp - 1:-1, 0]
    errs = {r: float((vals[r] - vals["f32"]).abs().max()) for r in ("kernel", "plain")}
    log(f"  small-input value pass (2 layers, full width, {B} rows x {Tp}+{Tr} tokens, "
        f"max|err| vs f32, values of scale {float(vals['f32'].abs().max()):.3e}): "
        f"kernel route {errs['kernel']:.3e}, plain bf16 route {errs['plain']:.3e}")
    if not (math.isfinite(errs["kernel"]) and math.isfinite(errs["plain"])) \
            or errs["kernel"] > 2 * errs["plain"]:
        fail("kernel route value pass less accurate than the plain route")


def algo_update(torch, algo: str, max_tokens: int, prompt_width: int, fwd_seen,
                bwd_seen, fused_seen, card: str) -> dict:
    """One update of `algo` through its launcher's config with the one-card
    cut (PPO: its value-init phase first, cut to VALUE_INIT_CUT), at the
    full Qwen2.5-1.5B width, then the checks of phase 9. Returns the
    update's launch counts."""
    import gc
    import importlib
    import os
    import shutil

    import numpy as np

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import one_card_cut
    from nanorlhf_tpu_torch.trainer.optim import flatten

    launcher = importlib.import_module(f"nanorlhf_tpu_torch.entrypoints.{algo}")
    cfg = one_card_cut(getattr(launcher, f"build_{algo}_config")())
    if max_tokens != cfg.response_length:
        log(f"  CUT: response_length {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    cfg.output_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "output", f"chip_smoke_{algo}")
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    hooks, value_init = {}, {}
    if algo == "ppo":
        from nanorlhf_tpu_torch.trainer.value_init import ValueInitConfig

        log(f"  CUT: value init {VALUE_INIT_CUT} (the launcher's: 500 prompts x 8 "
            "epochs, 8 rows a step)")
        phase = launcher.value_init_phase(cfg, True, ValueInitConfig(**VALUE_INIT_CUT))

        def timed(trainer, dataset, reward_func):
            t0 = time.perf_counter()
            phase(trainer, dataset, reward_func)
            torch.cuda.synchronize()
            value_init["s"] = time.perf_counter() - t0

        hooks = dict(value_params_fn=launcher.make_value_params, post_build=timed)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with recording_backward_shapes(bwd_seen), recording_forward_shapes(fwd_seen), \
            recording_fused_shapes(fused_seen):
        trainer = build_trainer(cfg, device="cuda", **hooks)
        init_counts = _build.launch_counts()
        L = trainer.mcfg.num_hidden_layers
        if algo == "ppo":
            log(f"  value init: {value_init['s']:.3f} s, launches {init_counts}")
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob",
                         "decode_attention"):
                if init_counts[name] <= 0:
                    fail(f"ppo value init never launched {name}")
        policy, ref = flatten(trainer.params), flatten(trainer.ref_params)
        trained = set(flatten(trainer.trainable))
        before = {p: t.detach().clone() for p, t in policy.items()}
        ref_before = {p: t.clone() for p, t in ref.items()}
        value_before = ({p: t.detach().clone() for p, t in flatten(trainer.value_params).items()}
                        if algo == "ppo" else None)
        _build.reset_launch_counts()
        state = trainer.train(num_updates=1)
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, t = trainer.last_launches, trainer.last_timings
    metrics = trainer.logger.latest()
    n_steps = state["opt_steps"]
    n_micro = n_steps * cfg.gradient_accumulation_steps
    rows = cfg.batch_size * cfg.sample_n
    trees = 2 if algo == "ppo" else 1  # PPO: the policy and the value tree
    log(f"  {algo}: {cfg.batch_size} prompts x sample_n={cfg.sample_n}, "
        f"{n_steps} optimizer steps x {cfg.gradient_accumulation_steps} microbatches; "
        f"launches: generate {launches['generate']}, score {launches['score']}, "
        f"value {launches['value']}, update {launches['update']}")

    # the update half: remat runs each layer's forward twice a microbatch,
    # once per tree; the backward once per tree
    expected = {"flash_fwd": 2 * L * n_micro * trees, "flash_bwd_dq": L * n_micro * trees,
                "flash_bwd_dkv": L * n_micro * trees, "fused_logprob": n_micro,
                "decode_attention": 0}
    for name, want in expected.items():
        if launches["update"][name] != want:
            fail(f"{algo} update: {name} launched {launches['update'][name]} times, "
                 f"expected {want}")
    # the generation: L x graph steps run, per generate (ReMax: two)
    steps = t["graph_steps_run"] + t.get("greedy_graph_steps_run", 0)
    check_graph_steps(f"{algo} rollout", t)
    if algo == "remax":
        check_graph_steps("remax greedy rollout", {k[len("greedy_"):]: v for k, v in t.items()
                                                   if k.startswith("greedy_")})
    if launches["generate"]["decode_attention"] != L * steps:
        fail(f"{algo}: decode_attention launched {launches['generate']['decode_attention']} "
             f"times in generation, expected L x graph steps run = {L * steps}")
    # the scoring pass: policy + ref over every sampled row (RLOO, RAFT: all
    # B·N) or the kept one per prompt
    chunk = max(1, (22 * 2316) // (prompt_width + cfg.response_length))
    n_chunks = math.ceil(rows / min(rows, chunk))
    if launches["score"]["fused_logprob"] != 2 * n_chunks:
        fail(f"{algo}: scoring launched fused_logprob {launches['score']['fused_logprob']} "
             f"times, expected {2 * n_chunks} (policy + ref over {rows} rows)")
    if algo == "ppo" and launches["value"]["flash_fwd"] != L:
        fail(f"ppo value pass: flash_fwd {launches['value']['flash_fwd']}, expected {L}")

    loss, gnorm = metrics["loss/policy_avg_new"], metrics["policy/grad_norm_new"]
    first_kl = trainer.last_stats[0].get("approxkl")
    log(f"  {algo}: loss {loss:.6e}, grad_norm {gnorm:.6e}, first-minibatch approxkl "
        f"{'n/a (SFT loss)' if first_kl is None else f'{first_kl:.3e}'}, kl_rollout "
        f"{metrics['objective/kl_rollout_old']:.3e}, non_score_reward "
        f"{metrics['objective/non_score_reward_old']:.3e}, rlhf_reward "
        f"{metrics['eval_objective/rlhf_reward_old']:.4f}"
        + (f", value loss {metrics['loss/value_avg_new']:.6e}, value clipfrac "
           f"{metrics['val/clipfrac_avg_new']:.4f}" if algo == "ppo" else ""))
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or gnorm <= 0:
        fail(f"{algo}: loss / grad norm not finite, or a zero gradient")
    if first_kl is not None and not first_kl < 1e-4:
        fail(f"{algo}: first-minibatch approxkl {first_kl:.3e} >= 1e-4")
    keys = ("objective/kl_old", "objective/kl_rollout_old", "objective/entropy_old",
            "objective/non_score_reward_old", "eval_objective/scores_old",
            "policy/approxkl_avg_new", "policy/clipfrac_avg_new", "policy/entropy_avg_new",
            "loss/policy_avg_new", "val/ratio_new", "val/ratio_var_new",
            "val/num_eos_tokens_old", "lr", "eps", "episode")
    if algo == "ppo":
        keys += ("loss/value_avg_new", "val/clipfrac_avg_new")
    bad = [k for k in keys if k not in metrics or not math.isfinite(metrics[k])]
    if bad:
        fail(f"{algo}: metrics missing or not finite: {bad}")
    if not math.isclose(metrics["objective/non_score_reward_old"],
                        -cfg.kl_coef * metrics["objective/kl_rollout_old"],
                        rel_tol=1e-5, abs_tol=1e-9):
        fail(f"{algo}: non_score_reward_old != -kl_coef x kl_rollout_old")
    after = flatten(trainer.params)
    if not any(p[-1] == "b" and not torch.equal(after[p].detach(), before[p]) for p in trained):
        fail(f"{algo}: no LoRA B leaf moved")
    if any(not torch.equal(after[p].detach(), before[p]) for p in policy if p not in trained) \
            or any(not torch.equal(v, ref_before[p])
                   for p, v in flatten(trainer.ref_params).items()):
        fail(f"{algo}: the frozen base or the ref moved")
    if algo == "ppo":
        vafter, vtrained = flatten(trainer.value_params), set(flatten(trainer.value_trainable))
        moved = {p for p in vtrained if not torch.equal(vafter[p].detach(), value_before[p])}
        want = {p for p in vtrained if p[0] != "lora" or p[-1] == "b"}
        if not want <= moved:
            fail(f"ppo: value leaves that did not move: {sorted(want - moved)[:4]}")
        if any(not torch.equal(vafter[p].detach(), value_before[p])
               for p in vafter if p not in vtrained):
            fail("ppo: the value backbone moved")
        log(f"  ppo: moved {len(moved)} value leaves (LoRA, score head, embeddings); "
            "value backbone unchanged")

    step = trainer.ckpt.latest_step()
    saved = trainer.ckpt.restore(step, "cuda")
    same = step == state["global_step"]
    for key, live in (("params", trainer.trainable), ("value", trainer.value_trainable)):
        if live is None:
            same = same and key not in saved
            continue
        live = flatten(live)
        same = same and key in saved and set(flatten(saved[key])) == set(live) and all(
            torch.equal(v, live[p].detach()) for p, v in flatten(saved[key]).items())
    for group, st in trainer.opt_state.items():
        got = saved["opt_state"][group]
        same = same and int(got["count"]) == st.count and all(
            torch.equal(v, flatten(getattr(st, m))[p])
            for m in ("mu", "nu") for p, v in flatten(got[m]).items())
    if not same:
        fail(f"{algo}: the checkpoint does not reload to the trained tensors")
    vi = f" value_init_s={value_init['s']:.3f}" if value_init else ""
    log(f"  {algo}: rollout_s={t['generate_s']:.3f} scoring_s={t['score_s']:.3f} "
        f"update_s={t['update_s']:.3f}{vi} checkpoint_blocking_s={trainer.last_save_s:.3f} "
        f"checkpoint_writer_s={trainer.ckpt.last_write_s:.3f} "
        f"peak_gb={peak:.2f} (card: {card}); checkpoint-{step} reloads"
        + (" with the value tree" if algo == "ppo" else ""))
    if algo == "ppo":
        small_value_reference(torch, trainer.mcfg, trainer.tokenizer.pad_token_id)
    trainer.close()
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    del trainer, policy, ref, before, ref_before, value_before, after, saved
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def other_algorithms(torch, max_tokens: int, prompt_width: int, fwd9, bwd9, fused9,
                     card: str) -> None:
    """Phase 9: one update of each of RLOO, ReMax, REINFORCE, RAFT and PPO;
    every K1, K2/K3 and K10 shape they gave must be one phase 2 held."""
    fwd_seen: collections.Counter = collections.Counter()
    bwd_seen: collections.Counter = collections.Counter()
    fused_seen: collections.Counter = collections.Counter()
    for algo in ALGOS:
        log(f" {algo}:")
        algo_update(torch, algo, max_tokens, prompt_width, fwd_seen, bwd_seen,
                    fused_seen, card)
    log(f"  shapes phase 9 gave the kernels: flash forward {dict(fwd_seen)}; "
        f"flash backward {dict(bwd_seen)}; fused_logprob {dict(fused_seen)}")
    bwd_held = {(name, *s, True) for name in ("flash_bwd_dq", "flash_bwd_dkv") for s in bwd9}
    for what, seen, held in (("flash forward", fwd_seen, fwd9),
                             ("flash backward", bwd_seen, bwd_held),
                             ("fused_logprob", fused_seen, fused9)):
        if set(seen) != held:
            fail(f"phase 9 gave the {what} {sorted(set(seen))}; phase 2 held it at "
                 f"{sorted(held)}")


# --------------------------------------------------------------------------
# phase 10: checkpoints and data in and out
# --------------------------------------------------------------------------

IO_SEED = 10
# export check (e): the merged bf16 model's response logprobs may be off the
# f32 plain route by at most EXPORT_FACTOR times the unmerged LoRA policy's
# error on the kernel route (the merge adds one bf16 rounding of each kernel)
EXPORT_FACTOR = 3.0


@contextlib.contextmanager
def recording_decode_shapes(seen):
    """Count, by (B, T_max), the calls of the contiguous decode wrapper (K4)
    the model makes; a decode loop's graph replays call no Python, so these
    are its eager chunk's and its capture's calls."""
    from nanorlhf_tpu_torch.core import model as tm

    fn = tm.decode_attention

    def rec(q, k, v, start, filled):
        seen[(q.shape[0], k.shape[2])] += 1
        return fn(q, k, v, start, filled)

    tm.decode_attention = rec
    try:
        yield
    finally:
        tm.decode_attention = fn


@contextlib.contextmanager
def recording_all_shapes(seen: dict):
    """The four shape recorders at once, into `seen` ({"fwd", "bwd",
    "fused", "decode"} counters)."""
    with recording_forward_shapes(seen["fwd"]), recording_backward_shapes(seen["bwd"]), \
            recording_fused_shapes(seen["fused"]), recording_decode_shapes(seen["decode"]):
        yield


def _io_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_io", *parts)


def _drop_page_cache(path: str) -> bool:
    """Evict a written file's pages, so the next read comes from the disk."""
    import os

    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        return True
    except (AttributeError, OSError):
        return False
    finally:
        os.close(fd)


def write_hf_dir(torch, mcfg, path: str, tok) -> tuple[dict, int, float]:
    """Random bf16 weights from IO_SEED written as an HF directory of two
    shards with `config.json`, through the port's writer. Returns (params
    on the card, bytes, seconds)."""
    import os

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.params import hf_state_dict_from_params, write_hf_config
    from nanorlhf_tpu_torch.core.safetensors_io import write_safetensors

    params = tm.init_params(mcfg, seed=IO_SEED, device="cuda")
    sd = hf_state_dict_from_params(mcfg, params, torch.bfloat16)
    names = list(sd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, part in enumerate((names[:len(names) // 2], names[len(names) // 2:])):
        write_safetensors(os.path.join(path, f"model-{i + 1:05d}-of-00002.safetensors"),
                          {n: sd[n] for n in part})
    write_hf_config(mcfg, path, "bfloat16", eos_token_id=tok.eos_token_id,
                    pad_token_id=tok.pad_token_id)
    secs = time.perf_counter() - t0
    return params, sum(t.numel() * t.element_size() for t in sd.values()), secs


def _instrument(trainer, trainer_mod, saves, writes, rollouts):
    """Record each save's blocking seconds, each write's (start, end) on the
    writer thread, and each rollout's (start, end, output)."""
    ckpt, real_save, real_write = trainer.ckpt, trainer.ckpt.save, trainer.ckpt._write
    real_rollout = trainer_mod.rollout_and_score

    def save(*a, **k):
        t0 = time.perf_counter()
        out = real_save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return out

    def write(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_write(*a, **k)
        finally:
            writes.append((t0, time.perf_counter()))

    def rollout(*a, **k):
        t0 = time.perf_counter()
        ro = real_rollout(*a, **k)
        rollouts.append((t0, time.perf_counter(), ro))
        return ro

    ckpt.save, ckpt._write = save, write
    trainer_mod.rollout_and_score = rollout
    return lambda: setattr(trainer_mod, "rollout_and_score", real_rollout)


def _trainable_copy(trainer) -> dict:
    from nanorlhf_tpu_torch.trainer.optim import flatten

    return {p: t.detach().clone() for p, t in flatten(trainer.trainable).items()}


def _resumed_update(torch, cfg, mcfg, hf_dir, trainer_mod):
    """A fresh trainer over `cfg.output_dir` (weights reloaded from the HF
    directory, a fresh toy tokenizer and dataset, as a new process would
    build them) resumed from step 1, then update 2. Returns (trainer, its
    update-2 rollout, its timings)."""
    from nanorlhf_tpu_torch.core.params import load_hf_checkpoint
    from nanorlhf_tpu_torch.data.tokenizer import load_tokenizer
    from nanorlhf_tpu_torch.entrypoints.common import resolve_dataset, resolve_rm_reward
    from nanorlhf_tpu_torch.trainer.trainer import RLTrainer

    _, params = load_hf_checkpoint(hf_dir, torch.bfloat16, "cuda")
    tok = load_tokenizer("toy:4096")
    trainer = RLTrainer(cfg, mcfg, tok, params, resolve_dataset(cfg, tok),
                        resolve_rm_reward(cfg.reward_model_path))
    state = trainer.resume_from_checkpoint(1)
    if state["global_step"] != 1 or trainer.ckpt.latest_step() != 1:
        fail(f"resume from step 1: global_step {state['global_step']}, latest "
             f"checkpoint {trainer.ckpt.latest_step()} (a newer one survived the resume)")
    rollouts: list = []
    undo = _instrument(trainer, trainer_mod, [], [], rollouts)
    try:
        trainer.train(num_updates=1)
    finally:
        undo()
    return trainer, rollouts[0][2], trainer.last_timings


def _max_diff(torch, a: dict, b: dict) -> float:
    return max(float((a[p].float() - b[p].float()).abs().max()) for p in a)


def write_interference(torch, trainer, queries, tok) -> None:
    """The decode-step cost of a write in flight: one fixed rollout (the
    trainer's policy, 16 prompts, 256 sampled tokens from one seed) timed
    with nothing written, with the checkpoint writer (`torch.save` on its
    thread) writing the trainer's tree, and with the same staged tree
    written by plain file writes on a thread, in turns (none, torch.save,
    plain, plain, torch.save, none)."""
    import os
    import threading

    from nanorlhf_tpu_torch.sampler.sampler import generate_tokens
    from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager

    cfg = trainer.cfg
    mgr = CheckpointManager(_io_dir("interference"), save_total_limit=1)
    opt = {g: {"count": st.count, "mu": st.mu, "nu": st.nu}
           for g, st in trainer.opt_state.items()}
    q = torch.as_tensor(queries, device="cuda").long()
    mask = q != tok.pad_token_id
    raw_path = _io_dir("interference", "plain.bin")

    plain_s: list = []

    def plain_write(staged):
        t0 = time.perf_counter()
        with open(raw_path, "wb") as f:
            for t in (v for v in _tree_leaves(staged) if isinstance(v, torch.Tensor)):
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
        plain_s.append(time.perf_counter() - t0)

    rows = {}
    for i, how in enumerate(("none", "torch.save", "plain", "plain", "torch.save", "none")):
        tree = {"params": trainer.trainable, "opt_state": opt}
        writer, t_write = None, None
        t0 = time.perf_counter()
        if how == "torch.save":
            mgr.save(i, trainer.trainable, opt_state=opt)
        elif how == "plain":
            staged, events = mgr._stage(tree)
            for ev in events:
                ev.synchronize()
            writer = threading.Thread(target=plain_write, args=(staged,))
            writer.start()
        t: dict = {}
        generate_tokens(trainer.params, trainer.mcfg, q, mask,
                        torch.Generator(device="cuda").manual_seed(IO_SEED),
                        max_tokens=256, eos_token_id=tok.eos_token_id,
                        pad_token_id=tok.pad_token_id, temperature=cfg.temperature,
                        top_p=cfg.top_p, top_k=cfg.rollout_top_k,
                        approx_top_k=cfg.rollout_approx_top_k,
                        lora_scale=trainer.lora_scale, timings=t)
        t_gen = time.perf_counter() - t0
        if how == "torch.save":
            mgr.wait()
            t_write = mgr.last_write_s
        elif how == "plain":
            writer.join()
            t_write = plain_s[-1]
        ms = t["decode_s"] / t["decode_steps"] * 1e3
        rows.setdefault(how, []).append(ms)
        log(f"  (g) {how:10s}: decode {ms:.3f} ms/step over {t['decode_steps']} steps "
            f"(prefill + decode {t_gen:.3f} s, writer "
            f"{'-' if t_write is None else f'{t_write:.3f} s'})")
    mgr.close()
    os.remove(raw_path)
    base = sum(rows["none"]) / 2
    log(f"  (g) decode ms/step, mean of two: none {base:.3f}, torch.save writer "
        f"{sum(rows['torch.save']) / 2:.3f} ({sum(rows['torch.save']) / 2 / base:.3f}x), "
        f"plain-write writer {sum(rows['plain']) / 2:.3f} "
        f"({sum(rows['plain']) / 2 / base:.3f}x)")


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def checkpoints_in_and_out(torch, F, max_tokens: int, held: dict) -> None:
    """Phase 10 at Qwen2.5-1.5B geometry, full depth: (a) write a random
    bf16 HF directory (two shards) and load it onto the card bit for bit;
    (b) two GRPO updates with async saves — blocking and writer seconds,
    update 2's decode ms a step with the writer in flight — and one
    synchronous save of the same tree; (c) a failed write absorbed; (d) a
    fresh trainer resumed from step 1 trains update 2 to the same tokens and
    leaves (and is the decode control without a writer); (e) LoRA merged
    into a bf16 export, reloaded, its response logprobs against the
    unmerged policy's, both against the f32 plain route; (f) the decoder
    RM over a value tree; (g) the decode-step cost of a write in flight
    (`write_interference`). The kernels the training path launched are held
    against their plain versions at the shapes it gave them (those phase 2
    did not hold already: `held`)."""
    import dataclasses
    import gc
    import importlib
    import os
    import shutil

    import numpy as np

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core.params import load_hf_checkpoint
    from nanorlhf_tpu_torch.data.tokenizer import load_tokenizer
    from nanorlhf_tpu_torch.entrypoints.common import resolve_dataset, resolve_rm_reward
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
    from nanorlhf_tpu_torch.entrypoints.ppo import make_value_params
    from nanorlhf_tpu_torch.rewards.builders import make_rm_reward
    from nanorlhf_tpu_torch.trainer import checkpoint as tck
    from nanorlhf_tpu_torch.trainer import trainer as trainer_mod
    from nanorlhf_tpu_torch.trainer.bucketing import depad_queries, shape_menu
    from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.scoring import score_chunk

    shutil.rmtree(_io_dir(), ignore_errors=True)
    hf_dir = _io_dir("hf")
    os.makedirs(hf_dir)
    mcfg = _demo_config()
    tok = load_tokenizer("toy:4096")

    # (a) write and load
    params, nbytes, write_s = write_hf_dir(torch, mcfg, hf_dir, tok)
    shards = sorted(f for f in os.listdir(hf_dir) if f.endswith(".safetensors"))
    cold = all(_drop_page_cache(os.path.join(hf_dir, f)) for f in shards)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcfg2, loaded = load_hf_checkpoint(hf_dir, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    geometry = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "tie_word_embeddings",
                "attention_bias", "rope_theta", "rms_norm_eps", "max_position_embeddings")
    bad = [f for f in geometry if getattr(mcfg2, f) != getattr(mcfg, f)]
    a, b = flatten(params), flatten(loaded)
    if bad or a.keys() != b.keys() or not all(
            b[p].dtype == t.dtype and torch.equal(b[p], t) for p, t in a.items()):
        fail(f"(a) the HF directory does not load to the written weights (config {bad})")
    log(f"  (a) wrote {nbytes / 1e9:.3f} GB of bf16 weights as {len(shards)} shards + "
        f"config.json in {write_s:.3f} s ({nbytes / write_s / 1e9:.3f} GB/s); "
        f"load_hf_checkpoint onto the card in {load_s:.3f} s "
        f"({nbytes / load_s / 1e9:.3f} GB/s, page cache "
        f"{'dropped first' if cold else 'NOT dropped: a warm read'}); "
        f"{len(b)} leaves equal bit for bit, geometry {mcfg2.model_type} "
        f"D={mcfg2.hidden_size} L={mcfg2.num_hidden_layers} V={mcfg2.vocab_size}")
    del params, a, b
    torch.cuda.empty_cache()

    # (b) two GRPO updates with async saves
    have = {}
    for m in ("transformers", "datasets", "safetensors", "tokenizers"):
        try:
            importlib.import_module(m)
            have[m] = "imports"
        except Exception as e:  # a missing or broken library is the record
            have[m] = type(e).__name__
    log(f"  (b) HF libraries here: {have}; the trainer takes the toy tokenizer "
        "(an HF tokenizer needs transformers and the tokenizer's files)")
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = hf_dir
    if max_tokens != cfg.response_length:
        log(f"CUT: response_length {cfg.response_length} -> {max_tokens}")
        cfg.response_length = max_tokens
    cfg.save_steps = 1
    cfg.output_dir = _io_dir("run")
    dataset = resolve_dataset(cfg, tok)
    from nanorlhf_tpu_torch.trainer.trainer import RLTrainer

    trainer = RLTrainer(cfg, mcfg2, tok, loaded, dataset,
                        resolve_rm_reward(cfg.reward_model_path))
    saves, writes, rollouts = [], [], []
    fwd_seen, bwd_seen, fused_seen, dec_seen = (collections.Counter() for _ in range(4))
    undo = _instrument(trainer, trainer_mod, saves, writes, rollouts)
    _build.reset_launch_counts()
    try:
        with recording_forward_shapes(fwd_seen), recording_backward_shapes(bwd_seen), \
                recording_fused_shapes(fused_seen), recording_decode_shapes(dec_seen):
            state = trainer.train(num_updates=2)
    finally:
        undo()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"  launches over the two updates: {counts}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
                 "fused_logprob"):
        if counts[name] <= 0:
            fail(f"(b) kernel {name} was never launched by the two updates")
    if state["global_step"] != 2 or len(saves) != 2 or len(writes) != 2:
        fail(f"(b) {state}, {len(saves)} saves, {len(writes)} writes")
    t2 = trainer.last_timings
    w0, w1 = writes[0]
    r0, r1, ro_a = rollouts[1]
    overlap = max(0.0, min(w1, r1) - max(w0, r0))
    log(f"  save blocking s (update 1, 2): {saves[0]:.3f}, {saves[1]:.3f}; writer s: "
        f"{writes[0][1] - writes[0][0]:.3f}, {writes[1][1] - writes[1][0]:.3f}")
    log(f"  update 2's rollout: decode {t2['decode_s']:.3f} s over {t2['decode_steps']} "
        f"steps with save 1's writer in flight for {overlap:.3f} s of the rollout's "
        f"{r1 - r0:.3f} s")
    a_leaves = _trainable_copy(trainer)
    # one synchronous save of the same tree
    sync_mgr = CheckpointManager(_io_dir("sync"), async_save=False)
    real_ckpt, trainer.ckpt = trainer.ckpt, sync_mgr
    t0 = time.perf_counter()
    trainer.save_checkpoint()
    sync_s = time.perf_counter() - t0
    trainer.ckpt = real_ckpt
    got, want = real_ckpt.restore(2, "cuda"), sync_mgr.restore(2, "cuda")
    if not _trees_equal(torch, got, want):
        fail("(b) the async checkpoint differs from the synchronous one of the same tree")
    log(f"  synchronous save of the same tree: {sync_s:.3f} s (writer {sync_mgr.last_write_s:.3f}); "
        f"async blocking {max(saves):.3f} s at most; the two checkpoints equal")
    if not max(saves) < sync_s:
        fail(f"(b) an async save blocked {max(saves):.3f} s, the synchronous one {sync_s:.3f} s")
    sync_mgr.close()
    del got, want
    shutil.rmtree(_io_dir("sync"), ignore_errors=True)

    # (c) a failed write
    fail_mgr = CheckpointManager(_io_dir("failed"), io_retries=1, retry_backoff=0.1)
    real_write = tck.write_tree

    def dies(tree, path):
        raise OSError("injected write failure")

    trainer.ckpt, tck.write_tree = fail_mgr, dies
    try:
        trainer.save_checkpoint()
        fail_mgr._writer.join()
    finally:
        tck.write_tree = real_write
    committed = os.path.isfile(os.path.join(fail_mgr.path(2), "tree.pt"))
    before = fail_mgr.retry_count
    trainer.save_checkpoint()
    fail_mgr.wait()
    if committed or fail_mgr.retry_count <= before or fail_mgr.latest_step() != 2:
        fail(f"(c) failed write: committed={committed}, retry_count {before} -> "
             f"{fail_mgr.retry_count}, latest {fail_mgr.latest_step()}")
    log(f"  (c) an injected write failure (every attempt): checkpoint-2 not committed; "
        f"the next save absorbed it, retry_count {before} -> {fail_mgr.retry_count}, "
        f"checkpoint-2 then committed")
    fail_mgr.close()
    trainer.ckpt = real_ckpt
    shutil.rmtree(_io_dir("failed"), ignore_errors=True)
    trainer.close()
    a_opt = {(g, m, p): t.clone() for g, st in trainer.opt_state.items()
             for m in ("mu", "nu") for p, t in flatten(getattr(st, m)).items()}
    del trainer, loaded, real_ckpt
    gc.collect()
    torch.cuda.empty_cache()

    # (d) resume from step 1 in a fresh trainer, then update 2
    tb, ro_b, tb_t = _resumed_update(torch, cfg, mcfg2, hf_dir, trainer_mod)
    same_tokens = all(np.array_equal(ro_a[k], ro_b[k])
                      for k in ("responses", "scores", "logprobs", "keep"))
    b_leaves = _trainable_copy(tb)
    b_opt = {(g, m, p): t for g, st in tb.opt_state.items()
             for m in ("mu", "nu") for p, t in flatten(getattr(st, m)).items()}
    d_leaves = _max_diff(torch, a_leaves, b_leaves)
    d_opt = _max_diff(torch, a_opt, b_opt)
    log(f"  (d) resumed from step 1 (newer checkpoints truncated), update 2: sampled "
        f"tokens, rewards and logprobs {'equal' if same_tokens else 'DIFFER'}; trainable "
        f"leaves max|diff| {d_leaves:.3e}, Adam moments {d_opt:.3e}")
    for what, t in (("with save 1's writer in flight", t2), ("the resumed run, no writer", tb_t)):
        steps, cap = t["decode_steps"], t["graph_capture_s"]
        log(f"  update 2's decode, {what}: {t['decode_s'] / steps * 1e3:.3f} ms/step, "
            f"{(t['decode_s'] - cap) / steps * 1e3:.3f} without the capture ({cap:.3f} s)")
    if not same_tokens:
        fail("(d) the resumed update 2 sampled other tokens than the uninterrupted run")
    if d_leaves or d_opt:
        # the card is not deterministic here: the criterion becomes the
        # spread of two runs of update 2 from the same restored state
        tb.close()
        del tb
        torch.cuda.empty_cache()
        import warnings

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tc, _, _ = _resumed_update(torch, cfg, mcfg2, hf_dir, trainer_mod)
        finally:
            torch.use_deterministic_algorithms(False)
        spread = _max_diff(torch, b_leaves, _trainable_copy(tc))
        calls = sorted({str(w.message).split(".")[0] for w in caught})
        log(f"  (d) run-to-run spread of update 2 from the same state: {spread:.3e}; "
            f"nondeterministic calls torch names: {calls}")
        if not (spread > 0 and d_leaves <= 4 * spread):
            fail(f"(d) resumed leaves differ by {d_leaves:.3e}, spread {spread:.3e}")
        tb = tc

    from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset

    ds = load_prompt_dataset("synthetic:64", tok)
    write_interference(torch, tb, depad_queries(next(ds.loader(16, IO_SEED)), tok.pad_token_id,
                                                shape_menu(ds.input_ids.shape[1], 16)), tok)

    # (e) export and reload

    gen = torch.Generator(device="cuda").manual_seed(IO_SEED + 5)
    with torch.no_grad():
        for ab in tb.params["lora"]["layers"].values():
            ab["b"].normal_(0.0, 0.02, generator=gen)
    exp_dir = _io_dir("export")
    t0 = time.perf_counter()
    tb.export_model(exp_dir)
    export_s = time.perf_counter() - t0
    gen_cfg = json.load(open(os.path.join(exp_dir, "generation_config.json")))
    if gen_cfg.get("eos_token_id") != tok.eos_token_id or \
            gen_cfg.get("pad_token_id") != tok.pad_token_id:
        fail(f"(e) generation_config.json {gen_cfg}")
    _, merged = load_hf_checkpoint(exp_dir, torch.bfloat16, "cuda")
    pad = tok.pad_token_id
    q = depad_queries(next(ds.loader(4, IO_SEED)), pad, shape_menu(ds.input_ids.shape[1], 16))
    q = torch.as_tensor(q, device="cuda").long()
    resp = torch.randint(3, 4096, (q.shape[0], 64), generator=gen, device="cuda")
    qr, Tp = torch.cat([q, resp], 1), q.shape[1]
    auto = dataclasses.replace(tb.mcfg, attention_impl="auto")
    plain = dataclasses.replace(tb.mcfg, attention_impl="xla")
    plain_cfg = dataclasses.replace(cfg, fused_logprob_impl="lax")
    policy_f32 = _tree_map(lambda t: t.detach().float(), tb.params)
    _build.reset_launch_counts()
    with torch.no_grad():
        lp_merged = score_chunk(merged, None, auto, cfg, qr, Tp, pad, 1.0)[0].float()
        lp_lora = score_chunk(tb.params, None, auto, cfg, qr, Tp, pad, tb.lora_scale)[0].float()
        e_counts = _build.launch_counts()
        lp_f32 = score_chunk(policy_f32, None, plain, plain_cfg, qr, Tp, pad,
                             tb.lora_scale)[0].float()
    del policy_f32
    err_m = float((lp_merged - lp_f32).abs().max())
    err_l = float((lp_lora - lp_f32).abs().max())
    d_ml = float((lp_merged - lp_lora).abs().max())
    log(f"  (e) export_model (bf16, LoRA merged at scale {tb.lora_scale}) in {export_s:.3f} s, "
        f"reloaded; response logprobs on the kernel route ({q.shape[0]} rows x 64 tokens; "
        f"K1 {e_counts['flash_fwd']}, K10 {e_counts['fused_logprob']} launches), max|err| "
        f"vs the f32 plain route: merged {err_m:.3e}, unmerged LoRA {err_l:.3e}; merged vs "
        f"unmerged {d_ml:.3e} (tolerance: merged <= {EXPORT_FACTOR} x unmerged)")
    if not (math.isfinite(err_m) and math.isfinite(err_l)) or err_m > EXPORT_FACTOR * err_l \
            or e_counts["flash_fwd"] <= 0 or e_counts["fused_logprob"] <= 0:
        fail("(e) the merged export's logprobs are off the unmerged policy's")

    # (f) the decoder RM over a value-shaped tree
    value = make_value_params(tb.mcfg, merged)
    del merged
    rm = make_rm_reward(value, auto, tok, batch_size=4)
    texts = tok.batch_decode(qr.cpu().numpy()[:, Tp - 8:]) + ["a short one", "</s>"]
    _build.reset_launch_counts()
    s1 = rm(texts, tok.eos_token)
    k1 = _build.launch_counts()["flash_fwd"]
    s2 = rm(texts, tok.eos_token)
    if s1.shape != (len(texts),) or not np.isfinite(s1).all() or not np.array_equal(s1, s2) \
            or k1 <= 0:
        fail(f"(f) RM scores {s1} / {s2}, K1 launches {k1}")
    log(f"  (f) make_rm_reward over the value tree: {len(texts)} strings scored "
        f"{np.round(s1, 4).tolist()}, equal on a second call, K1 {k1} launches")
    tb.close()
    del tb, value
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(_io_dir(), ignore_errors=True)

    # the kernels of the training path at the shapes it gave them
    fwd_new = sorted(set(fwd_seen) - held["fwd"])
    bwd_new = {s[1:6] for s in bwd_seen} - held["bwd"]
    fused_new = set(fused_seen) - held["fused"]
    dec_new = sorted(set(dec_seen) - held["decode"], key=lambda s: (-s[1], s[0]))
    log(f"  shapes the two updates gave the kernels: K1 {dict(fwd_seen)}; K2/K3 "
        f"{dict(bwd_seen)}; K10 {dict(fused_seen)}; K4 {dict(dec_seen)}; not held in "
        f"phase 2: K1 {fwd_new}, K2/K3 {sorted(bwd_new)}, K10 {sorted(fused_new)}, "
        f"K4 {dec_new}")
    if fwd_new:
        check_flash(torch, F, fwd_new)
    if bwd_new:
        check_flash_bwd(torch, F, bwd_new)
    if fused_new:
        check_fused(torch, F, max_tokens, set(fused_seen), timed=False)
    if dec_new:
        check_decode(torch, F, min(T for _, T in dec_new) - max_tokens, dec_new)


# --------------------------------------------------------------------------
# phase 11: sparse GRPO and the R1-Zero launcher at 8,000-token responses
# --------------------------------------------------------------------------

R1_SEED = 11
# phase 11 (b) holds the bucketed passes against one pass over all rows,
# and a bucket padded with all-pad rows against itself unpadded. A row's
# logprobs do not depend on the other rows of its batch: only the GEMMs'
# shapes differ, and with them at most cuBLAS's choice of kernel (1.9e-6
# on an H100 80GB HBM3). The gradients are bf16 through 28 layers of remat
# and backward. On that card, at one shape they repeat bit for bit; the
# same rows at another shape with no pad row (a single-row bucket, or the
# unpadded bucket, against its term of one pass over all 8 rows) move
# every leaf by 2.19e-2 to 2.26e-2, and padding adds nothing beyond that
# (2.29e-2 to 2.33e-2). The planted faults that (b) runs read 0.33 (loss
# scaled by the padded rows) and 0.097 to 0.10 (a bucket's shortest row
# dropped) on every leaf: R1_GRAD_TOL sits between.
R1_LOGPROB_TOL = 1e-2  # max |bucketed - one pass| logprob over the real tokens
R1_GRAD_TOL = 5e-2     # per leaf ||diff|| / ||reference||: the sum of the scaled
                       # bucket gradients against one pass, a padded bucket against
                       # the same bucket unpadded, and each sound witness


def _r1_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_r1", *parts)


def check_fused_at(torch, shapes) -> dict:
    """K10 at each shape (R, D, V, with_entropy, transposed) phase 11 gave
    it: held per row against its f32 plain version (FUSED_TOL; the plain
    version runs [chunk, V] logits blocks, so its memory stays bounded at
    R = 64,000), its split count the C entry's and `fused_logprob_split_
    count`'s; timed: events, device time (profiler), the plain version in
    bf16, the library yardstick (matmul + logsumexp + gather, + Σ
    softmax·z with entropy; in calls of at most 8,000 rows, since one call's
    [R, V] logits at R = 64,000 take 19 GB in bf16 before its f32
    temporaries) and the bound. Returns {shape: result}."""
    from nanorlhf_tpu_torch.ops.fused_logprob import (
        fused_chunk_rows, fused_logprob_chunked, fused_logprob_kernel,
        fused_logprob_split_count, fused_logprob_split_count_on_card)

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    temp, lib_rows = 0.9, 8000
    results = {}
    for R, D, V, ent, transposed in sorted(shapes, reverse=True):
        if not transposed:
            fail(f"fused_logprob: phase 11 gave an untied head (R={R}); no hold for it")
        S, S_rule = (fused_logprob_split_count_on_card(R, V),
                     fused_logprob_split_count(R, V, sm))
        if S != S_rule:
            fail(f"fused_logprob R={R} V={V}: the C entry splits {S} ways, the rule {S_rule}")
        h = torch.randn((R, D), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        lab = torch.randint(0, V, (R,), generator=gen, device="cuda")
        chunk = fused_chunk_rows(V, R)
        got = fused_logprob_kernel(h, w, lab, temp, with_entropy=ent, transposed=True)
        want = fused_logprob_chunked(*_f32(h, w), lab, temp, chunk, with_entropy=ent,
                                     transposed=True)
        bf16 = fused_logprob_chunked(h, w, lab, temp, chunk, with_entropy=ent,
                                     transposed=True)
        pairs = [("logprob", got[0], want[0], bf16[0], None)]
        if ent:
            pairs.append(("entropy", got[1], want[1], bf16[1], None))
        what = f"fused_logprob R={R} D={D} V={V} tied splits={S} with_entropy={ent}"
        err = hold(torch, what, pairs, FUSED_TOL)
        del got, want, bf16

        def kern():
            fused_logprob_kernel(h, w, lab, temp, with_entropy=ent, transposed=True)

        h_t = (h.float() / temp).to(torch.bfloat16)

        def library():
            for i in range(0, R, lib_rows):
                z = torch.matmul(h_t[i:i + lib_rows], w.t())
                lse = torch.logsumexp(z, dim=-1)
                torch.gather(z, 1, lab[i:i + lib_rows, None])
                if ent:
                    (torch.softmax(z, dim=-1) * z).sum(-1)
                del z, lse

        ms = time_ms(torch, kern, 3)
        on_card = dev_total(device_ms(torch, kern, 3, "fused_"))
        plain = time_ms(torch, lambda: fused_logprob_chunked(
            h, w, lab, temp, chunk, with_entropy=ent, transposed=True), 1)
        lib = time_ms(torch, library, 1)
        bms, by = bound_ms(2 * h.numel() + 2 * w.numel() + 8 * R + 4 * R * (2 if ent else 1),
                           2.0 * R * D * V)
        t_dev = on_card if on_card is not None else ms
        log(f"  {what}: kernel {ms:.4f} ms, device time (profiler) {fmt_ms(on_card)}, "
            f"plain {plain:.4f} ms, library {lib:.4f} ms ({-(-R // lib_rows)} calls of "
            f"<= {lib_rows} rows; kernel / library {t_dev / lib:.3f}), bound {bms:.4f} ms "
            f"({by}, {100 * bms / t_dev:.1f}% of it)")
        results[(R, D, V, ent, transposed)] = dict(
            ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib, bound_ms=bms,
            bound_by=by, max_abs_err=err, shape=f"R={R} D={D} V={V} tied, with_entropy={ent}")
        del h, w, lab, h_t
        torch.cuda.empty_cache()
    return results


def _leaf_errors(torch, got: dict, want: dict) -> dict[str, float]:
    """{leaf: ||got - want|| / ||want||} (0 for a leaf that is all zeros on
    both sides); fails on a non-finite leaf or one zero on one side only."""
    out = {}
    for p, w in want.items():
        g, name = got[p].float(), "/".join(map(str, p))
        if not torch.isfinite(g).all():
            fail(f"a non-finite gradient in leaf {name}")
        norm = float(w.float().norm())
        if norm == 0.0:
            if float(g.abs().max()) != 0.0:
                fail(f"leaf {name}: zero on one side only")
            out[name] = 0.0
            continue
        out[name] = float((g - w.float()).norm()) / norm
    return out


def _hold_leaves(what: str, errors: dict[str, float], tol: float) -> None:
    """One line of every leaf's relative error; fails above `tol`."""
    worst = max(errors, key=errors.get)
    log(f"  {what}: per leaf ||diff|| / ||reference||: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(errors.items()))
        + f"; worst {worst} {errors[worst]:.3e}; tol {tol}")
    if errors[worst] > tol or not any(errors.values()):
        fail(f"{what}: a leaf disagrees (or every leaf is zero)")


def r1_buckets(torch, tr) -> None:
    """Phase 11 (b): 8 kept rows whose responses end (EOS planted) at
    lengths spread over 200-8000 tokens, on the trained policy at full
    depth and width. The trainer's bucketed scoring (`kept_batch`) against
    one scoring pass over all rows at the minibatch's width; the sum of the
    scaled bucket gradients (`minibatch_grads`) against the gradient of the
    same objective from one pass over all rows; the bucket the rows menu
    padded with all-pad rows against the same bucket unpadded. What bounds
    R1_GRAD_TOL is measured here too: each backward bucket, padded or not,
    against its own term of the one pass (the same rows and objective at
    other shapes), the unpadded bucket twice (run to run), and two planted
    faults on the padded bucket (its loss scaled by the padded rows; its
    shortest row dropped), which must read above the tolerance."""
    import numpy as np

    from nanorlhf_tpu_torch.algos.losses import grpo_loss
    from nanorlhf_tpu_torch.ops.masking import INVALID_LOGPROB
    from nanorlhf_tpu_torch.trainer.bucketing import create_batches
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.scoring import fused_response_logprobs, score_chunk

    cfg, tok = tr.cfg, tr.tokenizer
    pad, eos = tok.pad_token_id, tok.eos_token_id
    rng = np.random.default_rng(R1_SEED + 1)
    rows, R = 8, cfg.response_length
    lengths = rng.permutation(np.linspace(200, R, rows).astype(int))
    responses = rng.integers(3, tok.vocab_size, (rows, R)).astype(np.int32)
    responses[np.arange(rows), lengths - 1] = eos
    queries = tr.dataset.input_ids[:rows]
    scores = rng.normal(size=rows).astype(np.float32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_buckets: list = []
    batch = tr.kept_batch(queries, responses, scores, score_buckets)
    t_score = time.perf_counter() - t0
    t0 = time.perf_counter()
    upd_buckets: list = []
    grads_b = tr.minibatch_grads(batch, np.arange(rows), None, upd_buckets)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    ctx, qr_len = batch["context_length"], batch["qr_len"]
    log(f"  (b) response lengths {sorted(lengths.tolist())} (EOS planted), context {ctx}: "
        f"scoring buckets (real rows, rows_b, width) {score_buckets} in {t_score:.3f} s; "
        f"backward buckets {upd_buckets} in {t_grad:.3f} s")

    # one pass over all rows at the minibatch's width
    dev = tr.device
    qr = torch.as_tensor(batch["qr"], device=dev)
    t0 = time.perf_counter()
    lp_all = score_chunk(tr.params, None, tr.mcfg, cfg, qr, ctx, pad, tr.lora_scale)[0]
    lp_all = lp_all.float().cpu().numpy()
    t_one = time.perf_counter() - t0
    real = ~batch["padding_mask"]
    d = np.abs(batch["logprobs"] - lp_all)[real]
    log(f"  (b) logprobs, bucketed against one pass over {rows} x {qr.shape[1]} tokens "
        f"({t_one:.3f} s): max |diff| {d.max():.3e}, mean {d.mean():.3e} over {d.size} "
        f"real tokens; tol {R1_LOGPROB_TOL}")
    if not np.isfinite(batch["logprobs"][real]).all() or d.max() > R1_LOGPROB_TOL:
        fail("(b) the bucketed logprobs disagree with one pass over all rows")

    # the gradient of each bucket's term (its rows' loss x real rows / rows)
    # from one pass over all rows; their sum is the one pass's objective
    leaves = flatten(tr._groups())
    paths, tensors = list(leaves), list(leaves.values())

    def as_f32(grads):
        return {p: torch.zeros_like(leaves[p], dtype=torch.float32) if g is None
                else g.float() for p, g in zip(paths, grads)}

    t = {k: torch.as_tensor(batch[k], device=dev)
         for k in ("responses", "logprobs", "ref_logprobs", "advantages", "padding_mask")}
    buckets = [np.asarray(b) for b in create_batches(qr_len, tr.backward_budget())]
    pi = next((i for i, (n, rb, _) in enumerate(upd_buckets) if rb > n), None)
    if pi is None:
        fail(f"(b) no backward bucket was padded with all-pad rows: {upd_buckets}")
    t0 = time.perf_counter()
    new_lp, _ = fused_response_logprobs(tr.params, tr.mcfg, qr, t["responses"], pad, ctx,
                                        cfg, lora_scale=tr.lora_scale, with_entropy=True,
                                        remat=cfg.gradient_checkpointing)
    new_lp = torch.where(t["padding_mask"], torch.full_like(new_lp, INVALID_LOGPROB), new_lp)
    sound: dict[str, dict] = {}
    grads_u = ref_pad = None
    for i, sel in enumerate(buckets):
        s_ = torch.as_tensor(sel, device=dev)
        part, _ = grpo_loss(new_lp[s_], t["logprobs"][s_], t["ref_logprobs"][s_],
                            t["advantages"][s_], ~t["padding_mask"][s_], cfg.cliprange,
                            cfg.kl_coef)
        ref = as_f32(torch.autograd.grad(part * (len(sel) / rows), tensors,
                                         allow_unused=True,
                                         retain_graph=i + 1 < len(buckets)))
        mb, _ = tr.bucket_batch(batch, sel)
        g, _ = tr.bucket_grads(mb, ctx, len(sel) / rows)
        sound[f"bucket {i} ({len(sel)} rows as {mb['responses'].shape[0]}) against its "
              f"term of one pass"] = _leaf_errors(torch, g, ref)
        if i == pi:
            ref_pad = ref
        if grads_u is None:
            grads_u = {p: r.clone() for p, r in ref.items()}
        else:
            for p, r in ref.items():
                grads_u[p].add_(r)
        del g, mb, ref
    del new_lp
    torch.cuda.synchronize()
    t_one_grad = time.perf_counter() - t0
    _hold_leaves(f"(b) gradients, the sum of the scaled bucket gradients against one "
                 f"pass over all rows ({t_one_grad:.3f} s, each bucket's term its own "
                 f"backward)", _leaf_errors(torch, grads_b, grads_u), R1_GRAD_TOL)
    del grads_u, grads_b

    sel = buckets[pi]
    scale = len(sel) / rows
    mb_pad, _ = tr.bucket_batch(batch, sel)
    g_pad, _ = tr.bucket_grads(mb_pad, ctx, scale)
    menu = tr._rows_menu
    tr._rows_menu = sorted(set(menu) | {len(sel)})
    try:
        mb, _ = tr.bucket_batch(batch, sel)
    finally:
        tr._rows_menu = menu
    g, _ = tr.bucket_grads(mb, ctx, scale)
    rb, n = mb_pad["responses"].shape[0], mb["responses"].shape[0]
    _hold_leaves(f"(b) a bucket of {n} rows padded to {rb} with all-pad rows against the "
                 f"same {n} rows unpadded", _leaf_errors(torch, g_pad, g), R1_GRAD_TOL)
    sound["the padded bucket against its term of one pass"] = _leaf_errors(
        torch, g_pad, ref_pad)
    sound["the unpadded bucket against its term of one pass"] = _leaf_errors(
        torch, g, ref_pad)
    sound["the unpadded bucket twice (run to run)"] = _leaf_errors(
        torch, tr.bucket_grads(mb, ctx, scale)[0], g)
    del g_pad, ref_pad
    planted = {
        f"its loss scaled by the padded rows ({rb} / {rows} for {n} / {rows})":
            _leaf_errors(torch, tr.bucket_grads(mb_pad, ctx, rb / rows)[0], g),
        f"its shortest row dropped ({n - 1} rows at the same scale)":
            _leaf_errors(torch, tr.bucket_grads(tr.bucket_batch(batch, sel[1:])[0], ctx,
                                                scale)[0], g),
    }
    worst = {k: max(e.values()) for k, e in sound.items()}
    least = {k: (max(e.values()), min(e.values())) for k, e in planted.items()}
    log("  (b) the witnesses of R1_GRAD_TOL, the worst leaf of each: sound: "
        + "; ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + "; planted faults against the unpadded bucket (worst, least leaf): "
        + "; ".join(f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in least.items())
        + f"; tol {R1_GRAD_TOL}")
    if max(worst.values()) > R1_GRAD_TOL:
        fail("(b) a sound witness reads above R1_GRAD_TOL")
    if min(a for a, _ in least.values()) <= R1_GRAD_TOL:
        fail("(b) a planted fault reads inside R1_GRAD_TOL: the hold would not catch it")


@contextlib.contextmanager
def cut_depth(module, layers: int | None):
    """`module.resolve_model` builds the launcher's model with only its
    first `layers` layers (None: every layer): the full script's depth cut
    of a phase whose widths and lengths stay the launcher's."""
    import dataclasses

    real = module.resolve_model

    def cut(*args, **kwargs):
        mcfg, params, tok = real(*args, **kwargs)
        params["layers"] = _tree_map(lambda t: t[:layers].clone(), params["layers"])
        return dataclasses.replace(mcfg, num_hidden_layers=layers), params, tok

    if layers is not None:
        module.resolve_model = cut
    try:
        yield
    finally:
        module.resolve_model = real


def r1_zero(torch, seen: dict, updates: int = 2, evals: bool = True,
            layers: int | None = None) -> dict:
    """Phase 11: `grpo_r1.build_trainer` at `r1_card_cut` on the card, then
    `train` (`grpo_r1.main`'s two steps; the full script cuts them to
    `updates` = 1 to stay inside its time limit, `--r1` runs both) — 8 prompts x
    4 samples of 8,000 tokens, random weights in the Qwen2-1.5B geometry at
    full depth, the synthetic arithmetic corpus, the greedy accuracy eval
    (16 questions, 1,024 tokens) before training and after each update,
    two updates with a checkpoint each (`evals` False: no eval, and
    `layers`: the model's first layers only, the full script's cuts). (a)
    Each rollout is graded by the
    launcher's binary reward (how many correct; whether the sparse filter
    would skip), then trained on a planted, seeded reward (prompt 0's group
    scores alike, the rest at random, so the filter drops one row and keeps
    the others); the forked grader runs from this process while the
    checkpoint writer is alive. (b) `r1_buckets`. Records the kernels'
    shapes in `seen` ({"fwd", "bwd", "fused", "decode"} counters) and
    returns the phase's launch counts."""
    import shutil

    from nanorlhf_tpu_torch.entrypoints import grpo_r1

    shutil.rmtree(_r1_dir(), ignore_errors=True)
    cfg = grpo_r1.r1_card_cut(grpo_r1.build_config())
    cfg.output_dir = _r1_dir("run")
    cfg.dataset_cache_dir = _r1_dir("token_cache")
    cfg.finalize(1)
    log(f"CUT: {cfg.batch_size} prompts x sample_n={cfg.sample_n} an update "
        f"(per_device_train_batch_size={cfg.per_device_train_batch_size}, "
        f"num_mini_batches={cfg.num_mini_batches}, gradient_accumulation_steps="
        f"{cfg.gradient_accumulation_steps}; the launcher's batch is 512 prompts), "
        f"{updates} updates, eval_steps={cfg.eval_steps} on 16 questions; response_length "
        f"{cfg.response_length}, widths and budgets the launcher's")
    t0 = time.perf_counter()
    with cut_depth(grpo_r1, layers):
        tr = grpo_r1.build_trainer(cfg, device="cuda")
    log(f"  grpo_r1.build_trainer: {time.perf_counter() - t0:.3f} s, "
        f"{tr.mcfg.num_hidden_layers} layers")
    try:
        counts = r1_train(torch, tr, seen, updates, evals)
        log("  (b) buckets at spread lengths, full depth and width")
        r1_buckets(torch, tr)
    finally:
        tr.close()
    shutil.rmtree(_r1_dir(), ignore_errors=True)
    return counts


# the full script's phase 11 depth (its 8,000-token rollout is a tenth of
# the script at 28 layers; `--r1` runs them all)
R1_CUT_LAYERS = 4


def r1_train(torch, tr, seen: dict, updates: int = 2, evals: bool = True) -> dict:
    """Phase 11 (a): the launcher's trainer `tr` with its reward wrapped
    (graded, then replaced by the planted one) and its accuracy eval on
    the first 16 questions, trained `updates` updates with the kernel
    counts reset just before; then the forked grader probed while a
    checkpoint write is in flight. Fails unless each update kept rows,
    launched K2/K3 and K10 and gave a finite loss, and the checkpoints
    committed. Returns the launch counts of the updates."""
    import math

    import numpy as np

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints import grpo_r1

    cfg, r1_reward = tr.cfg, tr.reward_func
    rng = np.random.default_rng(R1_SEED)

    def planted(texts, ids, tok):
        t0 = time.perf_counter()
        binary = r1_reward(texts, ids, tok)
        alike = bool((binary.reshape(-1, cfg.sample_n).std(1) == 0).all())
        log(f"  the launcher's binary reward: {int(binary.sum())} of {len(texts)} "
            f"correct in {time.perf_counter() - t0:.3f} s; every group alike, so the "
            f"sparse filter would skip this update: {alike}")
        out = rng.random(len(texts)).astype(np.float32)
        out[:cfg.sample_n] = 0.0  # prompt 0's group scores alike: filtered out
        return out

    tr.reward_func = planted
    train_qa, eval_qa = grpo_r1.load_math_datasets("meta-math/MetaMathQA",
                                                   "HuggingFaceH4/MATH-500")
    tr.accuracy_func = grpo_r1.make_accuracy_func(eval_qa[:16]) if evals else None

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording_all_shapes(seen):
        state = tr.train(updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    latest, writer_s = tr.ckpt.latest_step(), tr.ckpt.last_write_s
    log(f"  (a) SparseGRPOTrainer.train: {wall:.3f} s for {updates} updates and "
        f"{updates + 1 if evals else 0} evals; state "
        f"{state}; launches {counts}; peak {peak:.2f} GB")
    rows = cfg.batch_size * cfg.sample_n
    for rec in tr.update_log:
        t = rec["timings"]
        if rec["skipped"]:
            fail(f"rollout {rec['index']}: skipped; the planted reward keeps rows")
        steps = t["decode_steps"]
        dec = t["decode_s"]
        cap = t.get("graph_capture_s", 0.0)
        m = rec["metrics"]
        log(f"  update {rec['index'] + 1}: rollout {t['generate_s']:.3f} s (prefill "
            f"{t['prefill_s']:.3f} s, decode {dec:.3f} s: {steps} steps of "
            f"{1e3 * dec / max(steps, 1):.3f} ms, {1e3 * (dec - cap) / max(steps, 1):.3f} ms "
            f"without the {cap:.3f} s capture, {rows * steps / dec:.1f} tokens/s at {rows} "
            f"rows; graph pool {t.get('graph_pool_bytes', 0) / 1e9:.2f} GB); reward "
            f"{t['reward_s']:.3f} s; kept {rec['kept']} of {cfg.batch_size}; context "
            f"{rec['context_length']}, response cut {rec['max_resp']}; scoring buckets "
            f"(real rows, rows_b, width) {rec['score_buckets']} in {t['score_s']:.3f} s; "
            f"backward buckets {rec['update_buckets']} in {t['update_s']:.3f} s; "
            f"checkpoint blocking {rec.get('save_s', float('nan')):.3f} s; loss "
            f"{m['loss/policy_avg_new']:.6e}, approxkl {m['policy/approxkl_avg_new']:.3e}, "
            f"entropy {m['policy/entropy_avg_new']:.4f}, eval accuracy "
            f"{m.get('eval_accuracy_new')}")
        upd = rec["launches"]["update"]
        log(f"    launches: generate {rec['launches']['generate']}; score "
            f"{rec['launches']['score']}; update {upd}")
        if rec["kept"] <= 0 or not math.isfinite(m["loss/policy_avg_new"]):
            fail(f"update {rec['index'] + 1}: kept {rec['kept']}, loss "
                 f"{m['loss/policy_avg_new']}")
        # the first backward bucket's new and old logprobs come from the same
        # weights (its scoring bucket ran 8 rows, it runs 1): |dlogp| small
        first_kl = rec["stats"][0]["approxkl"]
        log(f"    first backward bucket's approxkl {first_kl:.3e}")
        if not first_kl < 1e-4:
            fail(f"update {rec['index'] + 1}: first-bucket approxkl {first_kl:.3e} >= "
                 f"1e-4: the update's logprobs disagree with the scoring pass's")
        for name in ("flash_bwd_dq", "flash_bwd_dkv", "fused_logprob", "flash_fwd"):
            if upd[name] <= 0:
                fail(f"update {rec['index'] + 1}: {name} never launched by the update")
    if len(tr.update_log) != updates or latest != updates:
        fail(f"{len(tr.update_log)} updates, latest checkpoint {latest}")
    log(f"  checkpoint-{updates} committed; the last write took {writer_s:.3f} s on the "
        f"writer")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob",
                 "decode_attention"):
        if counts[name] <= 0:
            fail(f"phase 11 never launched {name}")

    # the grader forked from this CUDA process while a checkpoint write runs
    texts, want = [], []
    for q, a in train_qa[:2]:
        for sol, ok in ((f"\\boxed{{{a} + 0}}", 1.0), (f"\\boxed{{{a} + 1}}", 0.0),
                        (f"\\boxed{{{a}}}", 1.0)):
            texts.append(grpo_r1.TEMPLATE.replace("QUESTION", q) + sol
                         + tr.tokenizer.eos_token)
            want.append(ok)
    step = tr.state["global_step"] + 1
    tr.ckpt.save(step, tr.trainable)
    alive = tr.ckpt._writer is not None and tr.ckpt._writer.is_alive()
    t0 = time.perf_counter()
    got = r1_reward(texts, None, tr.tokenizer)
    t_grade = time.perf_counter() - t0
    tr.ckpt.wait()
    log(f"  forked grader: {len(texts)} probes ({4} through the subprocess) graded "
        f"{got.tolist()} in {t_grade:.3f} s with the checkpoint writer "
        f"{'alive' if alive else 'already done'} at the fork; checkpoint-{step} "
        f"committed: {tr.ckpt.latest_step() == step}")
    if got.tolist() != want or tr.ckpt.latest_step() != step:
        fail(f"forked grader: {got.tolist()} against {want}, or the save did not commit")
    return counts


def r1_entries(results: dict, counts: dict) -> dict:
    """The kernels line's `r1` entry of each kernel phase 11 ran: its
    launches in phase 11 (counts reset just before the trainer's `train`, read just
    after) and its numbers at the 8k shape (`hold_r1_shapes`)."""
    keys = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {name: {"launches": counts[name], **{k: r.get(k) for k in keys}}
            for name, r in results.items()}


def hold_r1_shapes(torch, F, seen: dict) -> dict:
    """Phase 2's holds at every shape phase 11 gave K1, K2/K3, K4 and K10
    (the plain versions by rows where their scores would pass
    PLAIN_SCORE_BYTES). Returns the results at the 8k shapes the kernels
    line reports: K1 and K10 at the scoring bucket, K2/K3 at the update's
    row, K4 at the rollout's decode."""
    log(f"  shapes phase 11 gave the kernels: K1 (B, H, KV, T, hd) {dict(seen['fwd'])}; "
        f"K2/K3 {dict(seen['bwd'])}; K10 (R, D, V, with_entropy, tied) "
        f"{dict(seen['fused'])}; K4 (B, T_max) {dict(seen['decode'])}")
    fwd = check_flash(torch, F, sorted(seen["fwd"], key=lambda s: (-s[3], -s[0])))
    bwd = check_flash_bwd(torch, F, {s[1:6] for s in seen["bwd"]})
    fused = check_fused_at(torch, seen["fused"])
    dec_shapes = sorted(seen["decode"], key=lambda s: (-s[1], s[0]))
    prompt = min(T for _, T in dec_shapes) - 1024
    decode = check_decode(torch, F, max(prompt, 2), dec_shapes)
    longest = max(s[3] for s in seen["fwd"])
    fwd_at = max((s for s in seen["fwd"] if s[3] == longest), key=lambda s: s[0])
    return {"flash_fwd": fwd[fwd_at], **bwd[max(bwd)],
            "fused_logprob": fused[max(fused)],
            "decode_attention": decode[dec_shapes[0]]}


def _trees_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# --------------------------------------------------------------------------
# phase 12: the update's and the rollout's other routes
# --------------------------------------------------------------------------

# the routes, each an RLConfig change to phase 4's config (the launcher's,
# one-card cut, responses of at most 512 tokens): the default ("full":
# full remat, the fused logprob op, bf16 rollout weights), remat_policy
# "dots", the naive update branch, int8 rollout weights
ROUTES = {"full": {}, "dots": {"remat_policy": "dots"},
          "naive": {"fused_logprob": False}, "int8": {"rollout_quant": "int8"}}
# the kernels each route's update must launch (the naive branch never K10)
ROUTE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
                 "fused_logprob")
# int8 weights round each weight to within 1/254 of its output channel's
# absmax (at fan-in 1,536 about 0.0077 sigma rms, against bf16's 2^-9
# relative, about 0.0011 sigma): the int8 route's decode logits may sit
# this many times further from the exact f32 ones than the exact bf16
# route's (the activations round alike on both)
INT8_WEIGHT_FACTOR = 16.0


def _routes_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_routes", *parts)


@contextlib.contextmanager
def recording_rollouts(out: dict):
    """Keep the rollout (`rollout_and_score`'s result, "ro") and the update
    batch (`assemble_batch`'s, "batch") the trainer passes on."""
    from nanorlhf_tpu_torch.trainer import trainer as trainer_mod

    ro_fn, asm_fn = trainer_mod.rollout_and_score, trainer_mod.assemble_batch

    def ro(*a, **k):
        out["ro"] = ro_fn(*a, **k)
        return out["ro"]

    def asm(*a, **k):
        out["batch"], info = asm_fn(*a, **k)
        return out["batch"], info

    trainer_mod.rollout_and_score, trainer_mod.assemble_batch = ro, asm
    try:
        yield
    finally:
        trainer_mod.rollout_and_score, trainer_mod.assemble_batch = ro_fn, asm_fn


def _free(torch, trainer) -> None:
    import gc

    trainer.close()
    gc.collect()
    torch.cuda.empty_cache()


def route_update(torch, name: str, max_tokens: int, seen: dict, card: str) -> dict:
    """One GRPO update through `build_trainer` + `train(num_updates=1)` on
    phase 4's config with the route's knobs (no checkpoint), the kernel
    counts reset just before `train` and read just after. Fails unless the
    update half launched what its route dictates (K1 twice a layer and
    microbatch, K2/K3 once, K10 once a microbatch except on the naive
    branch, which never launches it, in scoring either) and gave a finite
    loss and a non-zero gradient. Returns the open trainer, its launch
    counts, timings, peak GB, metric row, rollout and update batch."""
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
    from nanorlhf_tpu_torch.trainer.optim import flatten

    cfg = one_card_cut(build_config())
    cfg.response_length = max_tokens
    cfg.save_steps = 0
    cfg.output_dir = _routes_dir(name)
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    for k, v in ROUTES[name].items():
        setattr(cfg, k, v)
    tr = build_trainer(cfg, device="cuda")
    got: dict = {"trainer": tr}
    if name == "int8":
        got["before"] = {p: t.detach().clone() for p, t in flatten(tr.trainable).items()}
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording_rollouts(got), recording_all_shapes(seen):
        tr.train(num_updates=1)
    torch.cuda.synchronize()
    got.update(counts=_build.launch_counts(), peak=torch.cuda.max_memory_allocated() / 1e9,
               timings=tr.last_timings, metrics=tr.logger.latest())
    t, m, launches = got["timings"], got["metrics"], tr.last_launches
    L, micro = tr.mcfg.num_hidden_layers, tr.state["opt_steps"] * cfg.gradient_accumulation_steps
    short = {k: v for k, v in got["counts"].items() if v}
    log(f"  {name} {ROUTES[name] or '(the defaults)'}: rollout_s={t['generate_s']:.3f} "
        f"(decode {t['decode_s'] / t['decode_steps'] * 1e3:.3f} ms/step) "
        f"scoring_s={t['score_s']:.3f} update_s={t['update_s']:.3f} "
        f"peak_mem_gb={got['peak']:.2f} (card: {card}); loss "
        f"{m['loss/policy_avg_new']:.6e}, grad_norm {m['policy/grad_norm_new']:.6e}, "
        f"entropy {m['policy/entropy_avg_new']:.4f}; launches {short}; scoring "
        f"{_nonzero(launches['score'])}; update {_nonzero(launches['update'])}")
    fused = 0 if name == "naive" else micro
    want = {"flash_fwd": 2 * L * micro, "flash_bwd_dq": L * micro, "flash_bwd_dkv": L * micro,
            "fused_logprob": fused, "decode_attention": 0}
    for kname, n in want.items():
        if launches["update"][kname] != n:
            fail(f"{name}: the update launched {kname} {launches['update'][kname]} times, "
                 f"expected {n}")
    if name == "naive" and launches["score"]["fused_logprob"]:
        fail("naive: the scoring pass launched fused_logprob")
    if got["counts"]["decode_attention"] != L * t["graph_steps_run"]:
        fail(f"{name}: decode_attention {got['counts']['decode_attention']} launches, "
             f"expected {L} x {t['graph_steps_run']}")
    for kname in ROUTE_KERNELS:
        if got["counts"][kname] <= 0 and not (name == "naive" and kname == "fused_logprob"):
            fail(f"{name}: kernel {kname} was never launched on the route")
    if not (math.isfinite(m["loss/policy_avg_new"]) and m["policy/grad_norm_new"] > 0):
        fail(f"{name}: loss not finite or a zero gradient")
    check_graph_steps(name, t)
    return got


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _lora_grads(torch, tr, mb, ctx: int, policy: str):
    """The LoRA gradients of one microbatch's loss under `policy` (full
    remat otherwise as the trainer runs it), its seconds and the peak GB
    above what was allocated before."""
    import dataclasses

    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.update import microbatch_loss

    lora = flatten(tr.params["lora"])
    mcfg = dataclasses.replace(tr.mcfg, remat_policy=policy)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = microbatch_loss(tr.params, mcfg, tr.cfg, mb, ctx, tr.tokenizer.pad_token_id,
                              tr.lora_scale, remat=True)
    grads = torch.autograd.grad(loss, list(lora.values()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    extra = (torch.cuda.max_memory_allocated() - base) / 1e9
    return dict(zip(lora, grads)), secs, extra


def _grads_agree(torch, what: str, got: dict, want: dict, tol: float) -> None:
    """Bit for bit, or every leaf within `tol` (per leaf ||diff|| / ||want||)."""
    if all(torch.equal(got[p], w) for p, w in want.items()):
        log(f"  {what}: equal bit for bit ({len(want)} leaves)")
        return
    _hold_leaves(what, _leaf_errors(torch, got, want), tol)


def dots_and_naive_at_one_microbatch(torch, tr, batch: dict, card: str) -> None:
    """On the "full" trainer after its update, one microbatch of its batch
    (rows 0-3, the update's microbatch shape): the LoRA gradients, seconds
    and peak above the resting memory under remat_policy "full" and
    "dots" (equal bit for bit expected: the same cuBLAS GEMMs at the same
    shapes; else each leaf within R1_GRAD_TOL); then the response logprobs
    of the fused branch (K10) and of the naive one (bf16 logits) against
    the f32 logprobs of the same final hidden states: the fused within
    FUSED_TOL, the naive within its logits' bf16 rounding (2 * 2^-9 of the
    row's largest |logit|, over the temperature) + FUSED_TOL."""
    import dataclasses

    from nanorlhf_tpu_torch.core.model import (padded_forward_hidden, padded_forward_logits,
                                               unembedding)
    from nanorlhf_tpu_torch.ops.masking import guard_temperature, logprobs_from_logits
    from nanorlhf_tpu_torch.trainer.scoring import fused_response_logprobs

    cfg = tr.cfg
    rows = cfg.per_device_train_batch_size
    mb = {k: torch.as_tensor(v[:rows], device="cuda") for k, v in batch.items()}
    ctx = mb["query_responses"].shape[1] - mb["responses"].shape[1]
    pad = tr.tokenizer.pad_token_id
    # in turns (full, dots, dots, full): the seconds of each policy, the
    # mean of its two turns
    turns = [(p, *_lora_grads(torch, tr, mb, ctx, p)) for p in ("full", "dots", "dots", "full")]
    secs = {p: [s_ for q, _, s_, _ in turns if q == p] for p in ("full", "dots")}
    peak = {p: max(x for q, _, _, x in turns if q == p) for p in ("full", "dots")}
    mean = {p: sum(v) / len(v) for p, v in secs.items()}
    log(f"  one microbatch ({rows} x {mb['query_responses'].shape[1]} tokens, "
        f"{tr.mcfg.num_hidden_layers} layers), loss + LoRA gradients in turns full, dots, "
        f"dots, full: full remat {secs['full'][0]:.3f} / {secs['full'][1]:.3f} s, dots "
        f"{secs['dots'][0]:.3f} / {secs['dots'][1]:.3f} s (dots - full "
        f"{mean['dots'] - mean['full']:+.3f} s, x{mean['dots'] / mean['full']:.3f}); peak "
        f"above resting full {peak['full']:.2f} GB, dots {peak['dots']:.2f} GB (dots - full "
        f"{peak['dots'] - peak['full']:+.2f} GB) (card: {card})")
    g_full, g_dots, g_again = turns[0][1], turns[1][1], turns[3][1]
    _grads_agree(torch, "LoRA gradients, full remat run to run", g_again, g_full,
                 R1_GRAD_TOL)
    _grads_agree(torch, "LoRA gradients, dots against full remat", g_dots, g_full,
                 R1_GRAD_TOL)
    del turns, g_full, g_dots, g_again

    naive_cfg = dataclasses.replace(cfg, fused_logprob=False)
    qr, resp = mb["query_responses"], mb["responses"]
    with torch.no_grad():
        fused = fused_response_logprobs(tr.params, tr.mcfg, qr, resp, pad, ctx, cfg,
                                        lora_scale=tr.lora_scale, with_entropy=True)[0]
        logits = padded_forward_logits(tr.params, tr.mcfg, qr, pad, lora_scale=tr.lora_scale,
                                       response_context_length=ctx)
        naive = logprobs_from_logits(logits, resp, naive_cfg.temperature)
        del logits
        hidden = padded_forward_hidden(tr.params, tr.mcfg, qr, pad, lora_scale=tr.lora_scale,
                                       response_context_length=ctx)
        z = hidden.float() @ unembedding(tr.mcfg, tr.params)[0].float().t()
        want = logprobs_from_logits(z, resp, cfg.temperature)
        bound = 2.0 ** -8 * z.abs().amax(-1) / guard_temperature(cfg.temperature) + FUSED_TOL
        del z, hidden
    real = ~mb["padding_mask"]
    e_fused = float((fused - want).abs()[real].max())
    e_naive = (naive - want).abs()
    d = float((naive - fused).abs()[real].max())
    log(f"  response logprobs of that microbatch: max|naive - fused| {d:.3e}; against the "
        f"f32 logprobs of the same hidden states: fused {e_fused:.3e} (tol {FUSED_TOL}), "
        f"naive {float(e_naive[real].max()):.3e} (bf16 logits: tol up to "
        f"{float(bound.max()):.3e} a row) (card: {card})")
    if e_fused > FUSED_TOL:
        fail("the fused branch's logprobs are off the f32 ones beyond FUSED_TOL")
    if bool((e_naive > bound)[real].any()):
        fail("the naive branch's logprobs are off the f32 ones beyond the bf16 rounding "
             "of their logits")


def r1_bucket_naive(torch, seen: dict, card: str) -> None:
    """The sparse trainer at `r1_card_cut` (Qwen2-1.5B, full depth), phase
    11 (b)'s fixed batch (8 rows ending at 200-8,000 tokens), its
    bucketed scoring, then the backward bucket of the 8,000-token row
    (8,021 tokens: a bucket of its own under both branches' budgets)
    through `bucket_grads` on the fused branch and on the naive one: each
    one's seconds and peak above the resting memory; the gradients held
    within R1_GRAD_TOL per leaf."""
    import shutil

    import numpy as np

    from nanorlhf_tpu_torch.entrypoints import grpo_r1
    from nanorlhf_tpu_torch.trainer.bucketing import create_batches

    shutil.rmtree(_routes_dir("r1"), ignore_errors=True)
    cfg = grpo_r1.r1_card_cut(grpo_r1.build_config())
    cfg.output_dir = _routes_dir("r1", "run")
    cfg.dataset_cache_dir = _routes_dir("r1", "token_cache")
    cfg.finalize(1)
    tr = grpo_r1.build_trainer(cfg, device="cuda")
    try:
        tok = tr.tokenizer
        rng = np.random.default_rng(R1_SEED + 1)
        rows, R = 8, cfg.response_length
        lengths = rng.permutation(np.linspace(200, R, rows).astype(int))
        responses = rng.integers(3, tok.vocab_size, (rows, R)).astype(np.int32)
        responses[np.arange(rows), lengths - 1] = tok.eos_token_id
        scores = rng.normal(size=rows).astype(np.float32)
        with recording_all_shapes(seen):
            batch = tr.kept_batch(tr.dataset.input_ids[:rows], responses, scores)
            ctx, qr_len = batch["context_length"], batch["qr_len"]
            sel = np.array([int(np.argmax(qr_len))])
            budgets = {}
            out = {}
            for fused in (True, False):
                cfg.fused_logprob = fused
                budgets[fused] = tr.backward_budget()
                if [list(b) for b in create_batches(qr_len, budgets[fused])
                        if sel[0] in b] != [[int(sel[0])]]:
                    fail(f"the {qr_len[sel[0]]}-token row is not a bucket of its own "
                         f"under the budget {budgets[fused]}")
                mb, blen = tr.bucket_batch(batch, sel)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                grads, aux = tr.bucket_grads(mb, ctx, 1 / rows)
                torch.cuda.synchronize()
                out[fused] = (grads, time.perf_counter() - t0,
                              (torch.cuda.max_memory_allocated() - base) / 1e9, aux)
        (gf, sf, xf, af), (gn, sn, xn, an) = out[True], out[False]
        log(f"  the {blen}-token bucket (1 row, context {ctx}; backward budgets fused "
            f"{budgets[True]}, naive {budgets[False]}): fused {sf:.3f} s, peak {xf:.2f} GB "
            f"above resting, entropy {af['entropy']:.4f}; naive {sn:.3f} s, peak "
            f"{xn:.2f} GB above resting, entropy {an['entropy']:.4f} (card: {card})")
        if not all(math.isfinite(a["pg_loss"]) for a in (af, an)):
            fail("the 8k bucket's loss is not finite")
        _hold_leaves("the 8k bucket's gradients, naive against fused",
                     _leaf_errors(torch, gn, gf), R1_GRAD_TOL)
    finally:
        cfg.fused_logprob = True
        _free(torch, tr)
        shutil.rmtree(_routes_dir("r1"), ignore_errors=True)


def int8_weight_rollouts(torch, max_tokens: int, seen: dict, card: str) -> None:
    """`run_rollout` at phase 3's size (4 prompts x 4 samples, at most 512
    tokens) with bf16 and with int8 rollout weights, in turns (bf16, int8,
    int8, bf16): decode ms a step, tokens/s, peak GB, the int8 view's bytes;
    K4's launches equal in all four, the decode loop replayed as a CUDA
    graph with the int8 leaves in the tree; then the small-input logits."""
    import gc

    import numpy as np

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core.quant import QUANT_PROJS
    from nanorlhf_tpu_torch.entrypoints.common import run_rollout
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    k4 = set()
    steps_ms: dict = {"bf16": [], "int8": []}
    for label in ("bf16", "int8", "int8", "bf16"):
        cfg = build_config()
        cfg.response_length = max_tokens
        cfg.rollout_quant = "int8" if label == "int8" else "none"
        timings: dict = {}
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recording_all_shapes(seen):
            out = run_rollout(cfg, device="cuda", num_prompts=4, timings=timings)
        torch.cuda.synchronize()
        counts, peak = _build.launch_counts(), torch.cuda.max_memory_allocated() / 1e9
        check_graph_steps(f"rollout, {label} weights", timings)
        mcfg, steps = out["mcfg"], timings["decode_steps"]
        L, rows = mcfg.num_hidden_layers, out["responses"].shape[0] * cfg.sample_n
        if counts["decode_attention"] != L * timings["graph_steps_run"]:
            fail(f"{label} rollout: decode_attention {counts['decode_attention']} launches")
        k4.add(counts["decode_attention"])
        ms = timings["decode_s"] / steps * 1e3
        steps_ms[label].append(ms)
        view = out["rollout_params"]
        extra = ""
        if view is not None:
            q_bytes = sum(view["layers"][n]["kernel_q"].numel() for n in QUANT_PROJS)
            s_bytes = sum(4 * view["layers"][n]["kernel_scale"].numel() for n in QUANT_PROJS)
            extra = (f"; int8 projections {q_bytes / 1e9:.3f} GB + f32 scales "
                     f"{s_bytes / 1e6:.3f} MB (bf16 {2 * q_bytes / 1e9:.3f} GB)")
        if not np.isfinite(out["logprobs"]).all():
            fail(f"{label} rollout: non-finite logprobs")
        log(f"  rollout, {label} weights: {rows} rows x {max_tokens} tokens, {steps} decode "
            f"steps, {ms:.3f} ms/step, {rows * steps / timings['decode_s']:.2f} tokens/s, "
            f"capture {timings['graph_capture_s']:.3f} s, peak_mem_gb={peak:.2f}, K4 "
            f"{counts['decode_attention']} launches{extra} (card: {card})")
        queries, pad_id = out["queries"], out["tokenizer"].pad_token_id
        # the next run's peak must not hold this one's model
        del out, view
        gc.collect()
        torch.cuda.empty_cache()
    if len(k4) != 1:
        fail(f"K4 launches differ between the bf16 and int8 rollouts: {sorted(k4)}")
    b, q = (sum(v) / len(v) for v in (steps_ms["bf16"], steps_ms["int8"]))
    log(f"  decode step, mean of two turns: bf16 {b:.3f} ms, int8 weights {q:.3f} ms "
        f"({q - b:+.3f} ms, x{q / b:.3f}) (card: {card})")
    int8_weight_small_reference(torch, mcfg, queries, pad_id, card)


def int8_weight_small_reference(torch, mcfg, queries, pad_id: int, card: str) -> None:
    """Prefill + 15 teacher-forced decode steps on the 2-layer full-width
    model through the kernels: the exact bf16 weights, the int8 weights,
    against the exact f32 plain route, and the int8 route against the f32
    plain route over its own dequantized weights. The int8 route must stay
    within INT8_WEIGHT_FACTOR x the exact bf16 route's error against exact
    f32, and within 2x that error against its own dequantized weights (what
    is left there is the activations' bf16 rounding, as for exact bf16)."""
    import dataclasses

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.quant import (QUANT_PROJS, dequantize_kernel,
                                               quantize_layers, rollout_view)

    small, params = _small_model(torch, mcfg, seed=5)
    qlayers = quantize_layers(params["layers"])
    qview = rollout_view(params, qlayers)
    f32 = _tree_map(lambda t: t.float(), params)
    deq = _tree_map(lambda t: t.float(), params)
    for n in QUANT_PROJS:
        deq["layers"][n]["kernel"] = dequantize_kernel(qlayers[n]["kernel_q"],
                                                       qlayers[n]["kernel_scale"],
                                                       torch.float32)
    plain = dataclasses.replace(small, attention_impl="xla")
    q = torch.as_tensor(queries, device="cuda").long()
    mask = q != pad_id
    B, Tp = q.shape
    n_steps = 16
    toks = torch.randint(3, 4096, (B, n_steps),
                         generator=torch.Generator(device="cuda").manual_seed(4),
                         device="cuda")
    T = Tp + n_steps
    routes = {"f32": (plain, f32), "f32 dequantized": (plain, deq),
              "exact bf16": (small, params), "int8 weights": (small, qview)}
    logits = {}
    with torch.no_grad():
        for name, (c, p) in routes.items():
            caches = tm.init_kv_cache(c, B, T, dtype=p["embed_tokens"].dtype, device="cuda")
            first, caches = tm.prefill(p, c, q, mask, caches)
            key_mask = torch.zeros((B, T), dtype=torch.bool, device="cuda")
            key_mask[:, :Tp] = mask
            plen = mask.sum(1)
            steps = [first]
            for s in range(1, n_steps):
                key_mask[:, Tp + s - 1] = True
                lg, caches = tm.decode_step(p, c, toks[:, s - 1], plen + s - 1, Tp + s - 1,
                                            key_mask, caches)
                steps.append(lg)
            logits[name] = torch.stack(steps, 1).float()
    err = {k: float((logits[k] - logits["f32"]).abs().max())
           for k in ("exact bf16", "int8 weights", "f32 dequantized")}
    own = float((logits["int8 weights"] - logits["f32 dequantized"]).abs().max())
    log(f"  int8 weights, small input (2 layers, full width, {B} rows, prefill + "
        f"{n_steps - 1} decode steps), max|logits - exact f32|: exact bf16 "
        f"{err['exact bf16']:.3e}, int8 weights {err['int8 weights']:.3e} "
        f"(x{err['int8 weights'] / err['exact bf16']:.2f}; tol x{INT8_WEIGHT_FACTOR}), "
        f"f32 over the dequantized weights {err['f32 dequantized']:.3e}; int8 weights "
        f"against f32 over their own dequantized weights {own:.3e} (tol 2 x "
        f"{err['exact bf16']:.3e}) (card: {card})")
    if not all(math.isfinite(v) for v in (*err.values(), own)) \
            or err["int8 weights"] > INT8_WEIGHT_FACTOR * err["exact bf16"] \
            or own > 2 * err["exact bf16"]:
        fail("the int8-weight route is off its references")


def int8_update_scoring(torch, got: dict, card: str) -> None:
    """The int8 route's update: its rollout's logprobs equal, bit for bit,
    the exact weights' scoring of the same rows (scoring never sees int8),
    and policy == ref at the zero-init LoRA."""
    import numpy as np

    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.scoring import score_chunk

    tr, ro = got["trainer"], got["ro"]
    live = flatten(tr.trainable)
    with torch.no_grad():
        for p, t in got["before"].items():  # the weights the rollout was scored with
            live[p].copy_(t)
        ctx = ro["context_length"]
        qr = torch.as_tensor(np.concatenate([ro["queries"], ro["responses"]], 1),
                             device="cuda")
        lp, rlp = score_chunk(tr.params, tr.ref_params, tr.mcfg, tr.cfg, qr, ctx,
                              tr.tokenizer.pad_token_id, tr.lora_scale)
    same = (np.array_equal(lp.float().cpu().numpy(), ro["logprobs"])
            and np.array_equal(rlp.float().cpu().numpy(), ro["ref_logprobs"]))
    d_pr = float(np.abs(ro["logprobs"] - ro["ref_logprobs"]).max())
    log(f"  int8: the rollout's logprobs against the exact weights' scoring of its "
        f"{qr.shape[0]} rows: {'equal bit for bit' if same else 'DIFFERENT'}; policy vs ref "
        f"(zero-init LoRA) max|diff| {d_pr:.3e} (card: {card})")
    if not same:
        fail("int8: scoring did not run the exact weights")
    if d_pr > 1e-3:
        fail("int8: policy and ref logprobs differ at the zero-init LoRA")


def other_routes(torch, max_tokens: int, seen: dict, card: str, cold: bool = False) -> dict:
    """Phase 12. (a) dots: one GRPO update under remat_policy "full" and
    one under "dots" from the same initial state (and rollout: the same
    seeds), their update seconds, peaks, K1/K2/K3/K10 launches (equal), the
    trained LoRA leaves (equal bit for bit, else within R1_GRAD_TOL), and
    at one microbatch the gradients and peak of each policy; (b) naive:
    one update with fused_logprob=False (no K10 in scoring or update), its
    logprobs against the fused branch's, and the 8k bucket of phase 11's
    fixed batch on both branches; (c) int8: rollouts with bf16 and int8
    weights, the small-input logits, one update with int8 weights. Returns
    each route's launch counts. `cold`: this process has run no update
    before (phase 12 alone), so the first route's update seconds include
    the process's warm-up."""
    import numpy as np

    from nanorlhf_tpu_torch.trainer.optim import flatten

    t0 = time.perf_counter()
    counts = {}
    if cold:
        log("  (the full route's update is this process's first: its seconds include "
            "the warm-up; the dots / full comparison in turns below is not)")
    full = route_update(torch, "full", max_tokens, seen, card)
    counts["full"] = full["counts"]
    tr = full["trainer"]
    lora_full = {p: t.detach().clone() for p, t in flatten(tr.params["lora"]).items()}
    responses, upd_full = full["ro"]["responses"], tr.last_launches["update"]
    log("  (a)/(b) at one microbatch of the full route's batch, on its trained weights")
    dots_and_naive_at_one_microbatch(torch, tr, full["batch"], card)
    _free(torch, tr)
    del full, tr

    log("  (a) remat_policy='dots'")
    dots = route_update(torch, "dots", max_tokens, seen, card)
    counts["dots"] = dots["counts"]
    tr = dots["trainer"]
    same_ro = np.array_equal(dots["ro"]["responses"], responses)
    upd = tr.last_launches["update"]
    log(f"  dots vs full: the same rollout: {same_ro}; update launches equal: "
        f"{upd == upd_full}")
    if {k: upd[k] for k in ROUTE_KERNELS} != {k: upd_full[k] for k in ROUTE_KERNELS}:
        fail(f"dots launched {upd} in the update, full {upd_full}")
    if same_ro:
        _grads_agree(torch, "trained LoRA leaves, dots against full",
                     flatten(tr.params["lora"]), lora_full, R1_GRAD_TOL)
    _free(torch, tr)
    del dots, tr, lora_full

    log("  (b) the naive update branch, fused_logprob=False")
    naive = route_update(torch, "naive", max_tokens, seen, card)
    counts["naive"] = naive["counts"]
    log(f"  naive vs full: the same rollout: "
        f"{np.array_equal(naive['ro']['responses'], responses)}")
    _free(torch, naive["trainer"])
    del naive
    r1_bucket_naive(torch, seen, card)

    log("  (c) int8 rollout weights, rollout_quant='int8'")
    int8_weight_rollouts(torch, max_tokens, seen, card)
    q8 = route_update(torch, "int8", max_tokens, seen, card)
    counts["int8"] = q8["counts"]
    int8_update_scoring(torch, q8, card)
    _free(torch, q8["trainer"])
    del q8
    log(f"  phase 12's routes: {time.perf_counter() - t0:.1f} s")
    return counts


def hold_new_shapes(torch, F, seen: dict, held: dict, max_tokens: int,
                    phase: int = 12) -> None:
    """Phase 2's holds at the shapes `phase` gave K1, K2/K3, K10 and K4
    that no earlier phase held (`held`)."""
    fwd_new = sorted(set(seen["fwd"]) - held["fwd"], key=lambda s: (-s[3], -s[0]))
    bwd_new = {s[1:6] for s in seen["bwd"]} - held["bwd"]
    fused_new = set(seen["fused"]) - held["fused"]
    dec_new = sorted(set(seen["decode"]) - held["decode"], key=lambda s: (-s[1], s[0]))
    log(f"  shapes phase {phase} gave the kernels: K1 {dict(seen['fwd'])}; K2/K3 "
        f"{dict(seen['bwd'])}; K10 {dict(seen['fused'])}; K4 {dict(seen['decode'])}; not "
        f"held before: K1 {fwd_new}, K2/K3 {sorted(bwd_new)}, K10 {sorted(fused_new)}, "
        f"K4 {dec_new}")
    if fwd_new:
        check_flash(torch, F, fwd_new)
    if bwd_new:
        check_flash_bwd(torch, F, bwd_new)
    if fused_new:
        check_fused_at(torch, fused_new)
    if dec_new:
        check_decode(torch, F, min(T for _, T in dec_new) - max_tokens, dec_new)


def routes_entries(counts: dict) -> dict:
    """The kernels line's `routes` entry of each kernel phase 12 ran: its
    launches in each route's update (counts reset just before its `train`,
    read just after)."""
    return {name: {route: c[name] for route, c in counts.items()}
            for name in ROUTE_KERNELS}


# --------------------------------------------------------------------------
# phase 13: the host planes on the GRPO main path
# --------------------------------------------------------------------------

# phase 13's knobs on top of phase 4's config (health, latency, the
# sentinel, graceful preemption and reward_retries at their defaults)
HOST_KNOBS = dict(telemetry=True, lineage=True, status_port=-1, profile_at_step=3,
                  save_steps=1, fault_spec="update.step:at=2,action=nan")
HOST_UPDATES = 3
# every plane off: the other side of the overhead reading
PLANES_OFF = dict(telemetry=False, lineage=False, status_port=0, health=False,
                  latency=False, sentinel=False, graceful_preemption=False,
                  reward_retries=0, save_steps=1)
# the metric row's keys at phase 13's config, the set
# tests/test_torch_observability.py pins on the CPU for the same config
HOST_ROW_KEYS = frozenset(
    ["step", "episode", "time", "t_mono", "eps", "lr", "sec_per_episode",
     "eval_objective/rlhf_reward_old", "eval_objective/scores_old",
     "objective/entropy_old", "objective/kl_old", "objective/kl_rollout_old",
     "objective/non_score_reward_old", "loss/policy_avg_new",
     "policy/approxkl_avg_new", "policy/clipfrac_avg_new", "policy/entropy_avg_new",
     "policy/grad_norm_new", "val/num_eos_tokens_old", "val/ratio_new",
     "val/ratio_var_new", "mem/logits_bytes_saved", "mem/peak_bytes_in_use",
     "time/rollout_s", "time/reward_s", "time/logprob_s", "time/update_s",
     "time/rollout_overlap_frac", "telemetry/spans_dropped"]
    + [f"perf/{k}" for k in ("mfu", "model_flops_per_step", "peak_flops_known",
                             "recompile_seconds", "recompiles", "tokens_per_sec_rollout",
                             "tokens_per_sec_step", "tokens_per_sec_update")]
    + [f"resilience/{k}" for k in ("ckpt_fallbacks", "ckpt_retries", "degraded_mode",
                                   "producer_restarts", "rollbacks")]
    + [f"health/{k}" for k in ("rules_crit", "rules_warn", "trips", "verdict")]
    + [f"health/rule_{k}" for k in (
        "draft_acceptance_degradation", "entropy_collapse", "fleet_quarantine_rate",
        "fleet_reassignment_rate", "heartbeat_miss_rate", "kl_blowup",
        "queue_starvation", "recompile_storm", "reward_collapse", "reward_drift",
        "rpc_error_rate", "slo_queue_wait_p99", "slo_rpc_rtt_p95", "slo_ttft_p95")])
# the device kernels of K1, K2, K3, K10 and K4 as torch.profiler names them
PROFILED_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                    "fused_logprob": "fused_partial_kernel",
                    "decode_attention": "decode_kernel"}
HOST_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob",
                "decode_attention", "decode_verify_attention", "paged_decode_attention")


def _host_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_host", *parts)


def _host_cfg(max_tokens: int, out: str, **knobs):
    """Phase 4's config (the one-card cut, `max_tokens` responses) writing
    to `out`, with `knobs` on top."""
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut

    cfg = one_card_cut(build_config())
    cfg.response_length = max_tokens
    cfg.output_dir = out
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg


def _scrape(port: int) -> dict:
    import urllib.request

    out = {}
    for ep in ("/metrics", "/healthz", "/statusz"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{ep}", timeout=30) as r:
            out[ep] = (r.status, r.read().decode())
    return out


def _decode_ms(t: dict) -> float:
    return t["decode_s"] / max(t["decode_steps"], 1) * 1e3


def _trace_kernel_counts(path: str) -> tuple[collections.Counter, int]:
    """(device kernel events by PROFILED_KERNELS name, all events) of a
    torch.profiler Chrome trace, read in blocks: a profiled update's trace
    runs to GBs, too large to load as one JSON document."""
    pat = re.compile(rb'"cat":\s*"kernel",\s*"name":\s*"([^"\n]*)"')
    counts: collections.Counter = collections.Counter()
    events, tail = 0, b""
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 26)
            buf = tail + block
            # a match starts at a "cat" key: keep the last one for the next
            # block, it may be cut
            cut = buf.rfind(b'"cat"') if block else len(buf)
            cut = len(buf) if cut < 0 else cut
            for m in pat.finditer(buf, 0, cut):
                name = m.group(1).decode(errors="replace")
                for kname, fn in PROFILED_KERNELS.items():
                    if fn in name:
                        counts[kname] += 1
            events += buf.count(b'"ph"', 0, cut)
            tail = buf[cut:]
            if not block:
                return counts, events


def host_main_train(torch, max_tokens: int, seen: dict) -> dict:
    """Phase 4's config with HOST_KNOBS for HOST_UPDATES updates, the kernel
    counts reset just before `train` and read just after; the exporter
    scraped while the run is live (during update 2's replay). Returns the
    open trainer and what (a)-(f) check."""
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer

    out = _host_dir("planes")
    shutil.rmtree(_host_dir(), ignore_errors=True)
    tr = build_trainer(_host_cfg(max_tokens, out, **HOST_KNOBS), device="cuda")
    log(f"  planes: {HOST_KNOBS}; health={tr.cfg.health} latency={tr.cfg.latency} "
        f"sentinel={tr.cfg.sentinel} graceful_preemption={tr.cfg.graceful_preemption} "
        f"reward_retries={tr.cfg.reward_retries}; status port {tr.exporter.port}")
    real_reward, calls, scraped = tr.reward_func, [0], {}

    def reward(texts, eos):
        calls[0] += 1
        if calls[0] == 3:   # the replayed update 2: rows exist, the run is live
            scraped.update(_scrape(tr.exporter.port))
        return real_reward(texts, eos)

    tr.reward_func = reward
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_all_shapes(seen):
        state = tr.train(num_updates=HOST_UPDATES)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"  {HOST_UPDATES} updates (and the rolled-back one) in "
        f"{time.perf_counter() - t0:.1f} s, the profiled update's trace export "
        f"included; launches {_nonzero(counts)}")
    return dict(trainer=tr, out=out, state=state, counts=counts, scraped=scraped,
                k4_profiled=tr.last_launches["generate"]["decode_attention"])


def host_main_checks(run: dict) -> None:
    """(a)-(f) on the main run's files, rows and scrape (host work only: the
    SIGTERM child starts its trainer meanwhile)."""
    import json
    import os

    from nanorlhf_tpu_torch.telemetry import (
        read_ledger,
        validate_prometheus_text,
        validate_trace_file,
    )

    tr, out, state, counts, scraped = (run[k] for k in ("trainer", "out", "state",
                                                        "counts", "scraped"))
    # (a) the rollback
    bb_path = os.path.join(out, "blackbox_2.json")
    bb = json.load(open(bb_path)) if os.path.isfile(bb_path) else {}
    log(f"  (a) state {state}; rollbacks {tr.sentinel.rollbacks}, quarantined "
        f"{sorted(tr.sentinel.quarantined)}, latest checkpoint {tr.ckpt.latest_step()}, "
        f"blackbox_2 {bb.get('reason')} {bb.get('extra')}")
    if (state["global_step"] != HOST_UPDATES or tr.sentinel.rollbacks != 1
            or tr.sentinel.quarantined != {1} or tr.ckpt.latest_step() != HOST_UPDATES
            or bb.get("reason") != "sentinel_trip"):
        fail("(a) the sentinel's rollback did not go as planned")
    # (b) the trace
    trace_path = os.path.join(out, "trace.json")
    errors = validate_trace_file(trace_path)
    events = json.load(open(trace_path))["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e["ph"] != "M")
    updates = [e["args"] for e in events if e["name"] == "train.update"]
    tagged = [u for u in updates if u.get("quarantined")]
    log(f"  (b) trace.json: {len(events)} events, schema errors {errors[:3]}; spans "
        f"{dict(sorted(names.items()))}")
    if errors or len(updates) - len(tagged) != HOST_UPDATES or len(tagged) != 1:
        fail(f"(b) trace.json: errors {errors[:3]}, train.update {len(updates)} spans, "
             f"{len(tagged)} tagged quarantined")
    want = {"ckpt.save", "ckpt.write", "ckpt.restore", "reward.dispatch",
            "trainer.rollout", "trainer.reward", "trainer.logprob", "trainer.update"}
    if not want <= set(names):
        fail(f"(b) trace.json lacks the spans {sorted(want - set(names))}")
    # (c) the lineage ledger
    chains: dict = {}
    for e in read_ledger(out):
        if e.get("rollout_index") is not None and e["type"] != "sample":
            kind = e["type"] + (":" + e["reason"] if e["type"] == "drop" else "")
            chains.setdefault(e["rollout_index"], []).append(kind)
    log(f"  (c) lineage chains: { {i: c for i, c in sorted(chains.items())} }")
    if any(chains.get(i, [""])[-1] != "outcome" for i in (0, 2, 3)) or \
            chains.get(1, [""])[-1] != "drop:sentinel_quarantine":
        fail("(c) the lineage chains do not end as planned")
    # (d) the exporter, scraped during update 3
    if not scraped:
        fail("(d) the exporter was not scraped during the run")
    problems = validate_prometheus_text(scraped["/metrics"][1])
    statusz = json.loads(scraped["/statusz"][1])
    log(f"  (d) /metrics {scraped['/metrics'][0]} ({len(scraped['/metrics'][1])} bytes, "
        f"problems {problems[:3]}); /healthz {scraped['/healthz']}; /statusz "
        f"{scraped['/statusz'][0]} keys {sorted(statusz)}")
    if scraped["/metrics"][0] != 200 or problems or scraped["/healthz"][0] != 200 \
            or scraped["/statusz"][0] != 200:
        fail("(d) the status endpoints did not answer as they should")
    # (e) the profile window's Chrome trace of update 3
    prof_paths = tr.profile_window.paths
    if len(prof_paths) != 1 or not os.path.isfile(prof_paths[0]):
        fail(f"(e) the profile window wrote {prof_paths}")
    t0 = time.perf_counter()
    kernel_events, n_events = _trace_kernel_counts(prof_paths[0])
    log(f"  (e) {os.path.basename(prof_paths[0])}: {os.path.getsize(prof_paths[0]) / 1e6:.1f} "
        f"MB, {n_events} events (read in {time.perf_counter() - t0:.1f} s); device kernel "
        f"events {dict(kernel_events)}; K4's graph-replayed launches in that update "
        f"{run['k4_profiled']}, shown: {kernel_events['decode_attention'] > 0}")
    missing = [k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob")
               if kernel_events[k] == 0]
    if missing:
        fail(f"(e) the profile window's trace names no device kernel of {missing}")
    # (f) the metric rows
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    steps = [r for r in rows if "episode" in r]
    m = steps[-1]
    log(f"  (f) perf/mfu {[round(r['perf/mfu'], 6) for r in steps]} (peak known "
        f"{m['perf/peak_flops_known']}), perf/recompiles {m['perf/recompiles']}, "
        f"time/rollout_overlap_frac {m['time/rollout_overlap_frac']:.4f}, health/verdict "
        f"{m['health/verdict']}, resilience/rollbacks {m['resilience/rollbacks']}")
    if len(steps) != HOST_UPDATES or any(set(r) != HOST_ROW_KEYS for r in steps):
        fail(f"(f) the rows' keys differ from HOST_ROW_KEYS: "
             f"{sorted(set(m) ^ HOST_ROW_KEYS)}")
    if not all(0 < r["perf/mfu"] < 1 for r in steps) or m["perf/peak_flops_known"] != 1.0:
        fail("(f) perf/mfu outside (0, 1) or the peak not known")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob",
                 "decode_attention"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on phase 13's main run")


def host_traced_spec(torch, tr, prompts, pad_id: int, seen_verify) -> dict:
    """(g): the traced speculative rollout (spec_k 4, greedy, 64 tokens, 16
    prompts) against the compiled loop's tokens, on the trainer's policy;
    the counts reset just before the traced run and read just after."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate
    from nanorlhf_tpu_torch.telemetry import SpanTracer

    q = torch.as_tensor(prompts, device="cuda").long()
    sp = SamplingParams(greedy=True, max_tokens=64, spec_k=4, n=1)
    kw = dict(eos_token_id=tr.tokenizer.eos_token_id, pad_token_id=pad_id,
              lora_scale=tr.lora_scale)
    t_graph, st_graph = {}, []
    graph_out = generate(tr.params, tr.mcfg, q, q != pad_id, torch.Generator(device="cuda"),
                         sp, timings=t_graph, spec_stats_out=st_graph, **kw)
    tracer, t_traced, st_traced = SpanTracer(enabled=True), {}, []
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with recording_verify_shapes(seen_verify):
        traced_out = generate(tr.params, tr.mcfg, q, q != pad_id,
                              torch.Generator(device="cuda"), sp, timings=t_traced,
                              spec_stats_out=st_traced, tracer=tracer, **kw)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    spans = [e for e in tracer.trace_events() if e["ph"] == "X"]
    steps = int(st_traced[0]["verify_steps"])
    verify_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "rollout.verify"]
    draft_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "rollout.draft"]
    pairs = [(e["name"], e["args"]["iteration"]) for e in spans]
    same = torch.equal(traced_out, graph_out)
    log(f"  (g) traced speculative rollout, 16 rows greedy 64 tokens: tokens equal to the "
        f"graph loop's: {same}; verify steps {steps} (graph loop "
        f"{int(st_graph[0]['verify_steps'])}); verify step {sum(verify_ms) / len(verify_ms):.3f} "
        f"ms mean (min {min(verify_ms):.3f}, max {max(verify_ms):.3f}), draft "
        f"{sum(draft_ms) / len(draft_ms):.3f} ms; graph loop "
        f"{_decode_ms(t_graph):.3f} ms a verify step (its capture included); launches "
        f"{_nonzero(counts)}")
    if not same or pairs != [(n, i) for i in range(steps)
                             for n in ("rollout.draft", "rollout.verify")]:
        fail("(g) the traced speculative loop: tokens differ from the graph loop's, or "
             "not one draft/verify span pair an iteration")
    if counts["decode_verify_attention"] <= 0:
        fail("kernel decode_verify_attention was never launched in phase 13 (g)")
    return counts


def host_queued_ttft(torch, tr, queries, pad_id: int, max_tokens: int) -> dict:
    """(h): a queued-session rollout at phase 5's config (page size 128, 32
    resident rows, 16 prompts x 4 samples, sampled) with a latency hub: one
    `latency/ttft_s` per admitted row; the counts reset just before it and
    read just after."""
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.sampler.sampler import generate
    from nanorlhf_tpu_torch.telemetry import LatencyHub
    from nanorlhf_tpu_torch.trainer.rollout import rollout_generator, sampling_params

    cfg = _host_cfg(max_tokens, _host_dir("queued"), rollout_page_size=128,
                    rollout_decode_rows=32)
    hub = LatencyHub()
    q = torch.as_tensor(queries, device="cuda").long()
    stats, t = [], {}
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    generate(tr.params, tr.mcfg, q, q != pad_id, rollout_generator(cfg.seed, 0, "cuda"),
             sampling_params(cfg), eos_token_id=tr.tokenizer.eos_token_id,
             pad_token_id=pad_id, lora_scale=tr.lora_scale, timings=t,
             paged_stats_out=stats, latency=hub)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    snap = hub.snapshot()
    ttft, gap = snap["latency/ttft_s"], snap.get("latency/intertoken_s", {})
    rows = q.shape[0] * cfg.sample_n
    log(f"  (h) queued session, {q.shape[0]} prompts x {cfg.sample_n}, 32 resident rows: "
        f"latency/ttft_s count {ttft['count']} (rows {rows}, admitted mid-loop "
        f"{stats[0]['admitted_midloop']}), p50 {ttft['p50_s'] * 1e3:.2f} ms, p95 "
        f"{ttft['p95_s'] * 1e3:.2f} ms; latency/intertoken_s count {gap.get('count')}, "
        f"p50 {gap.get('p50_s', 0) * 1e3:.3f} ms, p95 {gap.get('p95_s', 0) * 1e3:.3f} ms; "
        f"decode {_decode_ms(t):.3f} ms a step; launches {_nonzero(counts)}")
    if ttft["count"] != rows:
        fail(f"(h) {ttft['count']} TTFT records for {rows} admitted rows")
    if counts["paged_decode_attention"] <= 0:
        fail("kernel paged_decode_attention was never launched in phase 13 (h)")
    return counts


def sigterm_child(out: str, max_tokens: int) -> None:
    """The child of (i): phase 4's trainer with save_steps=0; on update 2's
    reward it leaves a marker beside `out` and waits for the SIGTERM (the
    guard's flag) before scoring. Prints one JSON line: the `Preempted`
    message, the step and the latest committed checkpoint."""
    import json
    import os

    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.resilience import Preempted

    tr = build_trainer(_host_cfg(max_tokens, out, save_steps=0), device="cuda")
    try:
        real, calls = tr.reward_func, [0]

        def reward(texts, eos):
            calls[0] += 1
            if calls[0] == 2:
                open(out + ".reward2", "w").close()
                deadline = time.monotonic() + 300
                while not tr._preemption.triggered:
                    if time.monotonic() > deadline:
                        fail("child: no SIGTERM arrived during update 2's reward")
                    time.sleep(0.05)
            return real(texts, eos)

        tr.reward_func = reward
        try:
            tr.train(num_updates=3)
        except Preempted as e:
            print(json.dumps({"preempted": str(e), "global_step": tr.state["global_step"],
                              "latest": tr.ckpt.latest_step(),
                              "files": sorted(os.listdir(out))}), flush=True)
            return
        fail("child: trained through the SIGTERM")
    finally:
        tr.close()


@contextlib.contextmanager
def sigterm_child_process(max_tokens: int):
    """(i), started: a child process running phase 4's trainer with
    save_steps=0 (`sigterm_child`), killed on the way out if it is still
    running. Yields (the Popen, its output directory, its log, the start)."""
    import os

    out = _host_dir("sigterm")
    log_path = _host_dir("sigterm_child.log")
    os.makedirs(_host_dir(), exist_ok=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sigterm-child", out,
             "--max-tokens", str(max_tokens)], stdout=logf, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            yield child, out, log_path, t0
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()


def host_sigterm(child, out: str, log_path: str, t0: float) -> None:
    """(i): SIGTERM to the child during update 2's reward: it raises
    `Preempted` with checkpoint 2 committed."""
    import json
    import os
    import signal

    deadline = time.monotonic() + 400
    while not os.path.exists(out + ".reward2"):
        if child.poll() is not None or time.monotonic() > deadline:
            fail(f"(i) the child ended (rc {child.returncode}) or stalled before "
                 f"update 2's reward; its log ends: {open(log_path).read()[-2000:]}")
        time.sleep(0.2)
    t_kill = time.perf_counter()
    os.kill(child.pid, signal.SIGTERM)
    rc = child.wait(timeout=400)
    tail = open(log_path).read().splitlines()
    result = next((json.loads(line) for line in reversed(tail) if line.startswith("{")), {})
    log(f"  (i) child rc {rc}: SIGTERM after {t_kill - t0:.1f} s, the child done "
        f"{time.perf_counter() - t_kill:.1f} s later: {result}")
    if rc != 0 or result.get("latest") != 2 or result.get("global_step") != 2 \
            or "emergency checkpoint" not in result.get("preempted", ""):
        fail(f"(i) the child did not commit its emergency checkpoint; its log ends: "
             f"{tail[-20:]}")


def host_planes(torch, max_tokens: int, prompts16, queries16, pad_id: int, card: str,
                seen: dict, seen_verify, turns=("off", "on", "off", "on")) -> dict:
    """Phase 13 (module docstring); the planes' overhead read in `turns`.
    Returns each kernel's launches in the run of phase 13 that ran it."""
    import shutil

    from nanorlhf_tpu_torch.entrypoints.common import build_trainer

    t_phase = time.perf_counter()
    run = host_main_train(torch, max_tokens, seen)
    on, counts = run["trainer"], run["counts"]
    # the child builds its trainer and trains while this process checks
    # the main run's files; nothing here is timed until the child is done
    with sigterm_child_process(max_tokens) as (child, sig_out, log_path, t0):
        host_main_checks(run)
        host_sigterm(child, sig_out, log_path, t0)
    counts_g = host_traced_spec(torch, on, prompts16, pad_id, seen_verify)
    counts_h = host_queued_ttft(torch, on, queries16, pad_id, max_tokens)
    # a fresh trainer, every plane off, resumes the child's emergency
    # checkpoint, then serves as the planes-off side of the overhead reading
    off = build_trainer(_host_cfg(max_tokens, sig_out, **PLANES_OFF), device="cuda")
    state = off.resume_from_checkpoint()
    log(f"  (i) a fresh trainer resumed the child's checkpoint at step "
        f"{state['global_step']} (rollouts {state['rollouts']})")
    if state["global_step"] != 2:
        fail(f"(i) the fresh trainer resumed at step {state['global_step']}, not 2")
    # its first update warms up (the staging buffers' first allocation)
    off.train(num_updates=1)
    log(f"  planes off, warm-up: update_s={off.last_timings['update_s']:.3f} "
        f"checkpoint_blocking_s={off.last_save_s:.3f}")
    readings = {"off": [], "on": []}
    for side in turns:
        tr = off if side == "off" else on
        tr.train(num_updates=1)
        t = tr.last_timings
        readings[side].append((t["update_s"], _decode_ms(t)))
        log(f"  planes {side}: update_s={t['update_s']:.3f} decode {_decode_ms(t):.3f} "
            f"ms/step rollout_s={t['generate_s']:.3f} checkpoint_blocking_s="
            f"{tr.last_save_s:.3f} (card: {card})")
    mean = {s: [sum(x[i] for x in r) / len(r) for i in (0, 1)] for s, r in readings.items()}
    log(f"  overhead of the planes: update_s {mean['off'][0]:.3f} -> {mean['on'][0]:.3f} "
        f"({mean['on'][0] / mean['off'][0]:.3f}x), decode {mean['off'][1]:.3f} -> "
        f"{mean['on'][1]:.3f} ms/step ({mean['on'][1] / mean['off'][1]:.3f}x), in turns "
        f"{'/'.join(turns)} (card: {card})")
    _free(torch, off)
    _free(torch, on)
    shutil.rmtree(_host_dir(), ignore_errors=True)
    log(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s (card: {card})")
    out = {name: counts[name] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                           "fused_logprob", "decode_attention")}
    out["decode_verify_attention"] = counts_g["decode_verify_attention"]
    out["paged_decode_attention"] = counts_h["paged_decode_attention"]
    return out


def hold_host_verify(torch, seen_verify, held: set, pad_max: int) -> None:
    """K6 at the verify shapes phase 13 (g) gave it that no earlier phase
    held, as phase 2 holds it."""
    new = sorted(set(seen_verify) - held)
    log(f"  verify shapes phase 13 gave K6 (name, B, H, Tq, hd, KV, T): {dict(seen_verify)}; "
        f"not held before: {new}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    for name, B, H, Tq, hd, KV, T in new:
        _hold_verify(torch, f"phase 13 B={B} T={T}",
                     _verify_case(torch, gen, B, H, KV, Tq, hd, T, pad_max))


# --------------------------------------------------------------------------
# phase 14: serving — the radix prefix cache, chunked prefill, the per-row
# session, the engine behind its HTTP gateway, the traffic driver
# --------------------------------------------------------------------------

# the engine's shapes on the launcher's model (Qwen2.5-1.5B geometry, 28
# layers, random weights from SERVE_SEED): 32 resident rows, prompts
# left-padded to 512, 256 new tokens, pages of 128 (T_max 768, 6 a row)
PHASE14 = ("phase 14: serving — the radix prefix cache, chunked prefill, the engine behind "
           "its gateway driven over HTTP, Qwen2.5-1.5B width")
SERVE = dict(rows=32, prompt_len=512, max_new_tokens=256, page_size=128)
SERVE_SEED = 14
# the traffic: 64 Poisson arrivals at 16 a second, 16-480 real prompt
# tokens, 4 tenants sharing 384 tokens (half the requests), half greedy,
# the sampled half at the launcher's temperature and top-p
SERVE_TRAFFIC = dict(seed=0, n_requests=64, rate_rps=16.0, arrival="poisson",
                     prompt_len_min=16, prompt_len_max=480, token_lo=4, token_hi=4096,
                     prefix_groups=4, prefix_frac=0.5, prefix_len=384, greedy_frac=0.5,
                     max_tokens_min=256, max_tokens_max=256)
# K9 widths held besides the ones the phase gives it: a chunk's, a short
# suffix's and the prompt width
SERVE_TQ = (16, 128, 512)
# (b): the suffix route's logits (a COW admission: K9 over the unmatched
# tail against cached prefix K/V) against the f32 plain full prefill may
# err up to this many times the bf16 full prefill's error: both round to
# bf16 at other places (the suffix's prefix K/V came from another forward),
# neither is the exact one
SUFFIX_FACTOR = 3.0
# a greedy token of one route may sit below the argmax of another route's
# logits by twice the two routes' logit difference; (c) allows this many
# times what (b) measured of it over 2 x 256 tokens, the routes there being
# the ones (c) compares
NEAR_TIE_FACTOR = 2.0


def _serve_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_serve", *parts)


def _loopback_only() -> None:
    """The driver and the scrapes speak HTTP to 127.0.0.1 only: no proxy
    from the environment may route them elsewhere."""
    import os

    for name in ("http_proxy", "https_proxy", "all_proxy"):
        os.environ.pop(name, None)
        os.environ.pop(name.upper(), None)
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"


def _left_pad(tokens, width: int, pad: int):
    import numpy as np

    ids = np.full(width, pad, np.int64)
    ids[width - len(tokens):] = tokens
    return ids, ids != pad


def _cut_at_eos(row, eos: int) -> list:
    row = [int(t) for t in row]
    return row[:row.index(eos) + 1] if eos in row else row


def _margin_at(torch, mcfg, params, prompt, stream, pos: int, pad: int) -> float:
    """The top-2 margin of the full forward's logits after `prompt` +
    stream[:pos] (`full_logits` drops the stand-in last token)."""
    top2 = full_logits(torch, mcfg, params, prompt, list(stream[:pos]) + [pad],
                       pad)[-1].topk(2).values
    return float(top2[0] - top2[1])


def compare_streams(torch, what: str, mcfg, params, pairs, pad: int, near_tie: float):
    """Greedy streams, (prompt, reference, got) each: equal, or differing
    first where the reference's top-2 logit margin is at most `near_tie`
    (two routes that round bf16 at other places may flip a near tie there,
    and from it on the streams part). Prints each difference; fails on one
    past a near tie."""
    same, far = 0, []
    for i, (prompt, want, got) in enumerate(pairs):
        if list(want) == list(got):
            same += 1
            continue
        n = min(len(want), len(got))
        pos = next((j for j in range(n) if want[j] != got[j]), n)
        margin = _margin_at(torch, mcfg, params, prompt, want, pos, pad)
        log(f"    {what} stream {i}: first difference at token {pos} of {len(want)} "
            f"(reference {want[pos] if pos < len(want) else 'end'}, got "
            f"{got[pos] if pos < len(got) else 'end'}); the reference's top-2 logit margin "
            f"there {margin:.4e}")
        if margin > near_tie:
            far.append((i, pos, margin))
    log(f"  {what}: {same}/{len(pairs)} greedy streams equal token for token")
    if far:
        fail(f"{what}: streams differ past a near tie (margin > {near_tie:.4e}): {far}")


def full_logits(torch, mcfg, params, prompt, stream, pad: int, width: int | None = None,
                lora_scale: float = 1.0):
    """The full forward's next-token logits (f32 [n, V]) that predict each
    token of `stream` after `prompt` (left-padded to `width`, by default
    the engine's; LoRA at `lora_scale`): one teacher-forced pass, the route
    of scoring (K1)."""
    from nanorlhf_tpu_torch.core import model as tm

    width = width or SERVE["prompt_len"]
    ids, _ = _left_pad(list(prompt), width, pad)
    seq = torch.as_tensor(list(ids) + list(stream[:-1]), device="cuda")[None]
    with torch.no_grad():
        logits = tm.padded_forward_logits(params, mcfg, seq, pad, lora_scale=lora_scale)[0]
    return logits[width - 1:].float()


def check_greedy_tokens(torch, what: str, mcfg, params, pairs, pad: int, near_tie: float,
                        width: int | None = None, lora_scale: float = 1.0):
    """Each greedy stream, (prompt, stream) each, against the full forward
    over it (prompts left-padded to `width`): every token within `near_tie`
    of the argmax of the logits that predict it (a route that rounds bf16
    elsewhere can pick either side of a near tie, and nothing else); the
    largest gap and the number of tokens that are not the argmax printed."""
    worst, off, n = 0.0, 0, 0
    for prompt, stream in pairs:
        lg = full_logits(torch, mcfg, params, prompt, stream, pad, width, lora_scale)
        tok = torch.as_tensor(stream, device="cuda")
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        off += int((gap > 0).sum())
        n += len(stream)
    log(f"  {what}: {n} greedy tokens against the full forward's argmax: {off} not the "
        f"argmax, the largest gap {worst:.4e} (near tie: at most {near_tie:.4e})")
    if worst > near_tie:
        fail(f"{what}: a greedy token {worst:.4e} under the argmax, past a near tie")


def serve_suffix(torch, mcfg, params, eos: int, pad: int) -> float:
    """(b) Two prompts of 300 real tokens sharing their first 200 admitted
    through a per-row session with the radix cache: the second is a
    mid-page hit (412 of its 512 slots matched, page 3 copied on write) whose
    K9 suffix forward gives its first logits. Held against the f32 plain
    full prefill of the same row (SUFFIX_FACTOR x the bf16 full prefill's
    error). Both rows then decode greedily, eagerly with each step's logits
    kept, and the full forward over each stream gives the logits the
    session's route is compared with at every token: their largest
    difference, returned, is the route noise the near ties of (c) are
    measured against; both streams are held against the monolithic paged
    sampler's (K1 prefill)."""
    import dataclasses

    import numpy as np

    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.sampler.paged import session as sess_mod
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate
    from nanorlhf_tpu_torch.serving import radix as rx

    Tp, M, P = SERVE["prompt_len"], SERVE["max_new_tokens"], SERVE["page_size"]
    rng = np.random.default_rng(SERVE_SEED)
    a = rng.integers(4, 4096, 300)
    b = a.copy()
    b[200:] = rng.integers(4, 4096, 100)
    rows = [_left_pad(a, Tp, pad), _left_pad(b, Tp, pad)]
    suffix, steps = [], []
    real, real_sample = rx.suffix_logits, sess_mod._serving_sample

    def recording(*args, **kw):
        logits, caches = real(*args, **kw)
        suffix.append((args[4], args[2].shape[1], logits.float().clone()))
        return logits, caches

    def recording_sample(generator, logits, *args, **kw):
        steps.append(logits.float().clone())
        return real_sample(generator, logits, *args, **kw)

    rc = rx.RadixCache()
    sess = sess_mod.DecodeSession(
        params, mcfg, rows=2, prompt_len=Tp, max_tokens=M, page_size=P,
        eos_token_id=eos, pad_token_id=pad,
        generator=torch.Generator(device="cuda").manual_seed(0), per_row=True,
        prefix_cache=rc, sync_every=8)
    rx.suffix_logits = recording
    try:
        for r, (ids, mask) in enumerate(rows):
            sess.admit(r, ids, mask, r, budget=M, greedy=True)
    finally:
        rx.suffix_logits = real
    snap = rc.snapshot()
    (fill_a, tq_a, first_a), (fill_b, tq_b, got) = suffix
    log(f"  (b) admissions through the radix cache: cold suffix at slot {int(fill_a)} (Tq "
        f"{tq_a}), then the hit at slot {int(fill_b)} (Tq {tq_b}); cow_splits "
        f"{snap['cow_splits']}, shared pages acquired {snap['shared_pages_acquired']}, "
        f"hit tokens {snap['hit_tokens']}")
    if snap["cow_splits"] != 1 or int(fill_b) != Tp - 300 + 200 or int(fill_b) % P == 0:
        fail(f"(b) the second admission is not a mid-page COW hit at slot "
             f"{Tp - 300 + 200}: {snap}, fill {int(fill_b)}")
    ids = torch.as_tensor(rows[1][0], device="cuda")[None]
    mask = torch.as_tensor(rows[1][1], device="cuda")[None]
    nb = -(-(Tp + M) // P)
    table = torch.arange(nb, device="cuda")[None]
    plain = dataclasses.replace(mcfg, attention_impl="xla")
    p32 = _tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        full = tm.prefill(params, mcfg, ids, mask,
                          tm.init_paged_kv_cache(mcfg, nb, P, torch.bfloat16, "cuda"),
                          page_table=table, page_size=P, logical_len=Tp + M)[0][0].float()
        f32 = tm.prefill(p32, plain, ids, mask,
                         tm.init_paged_kv_cache(plain, nb, P, torch.float32, "cuda"),
                         page_table=table, page_size=P, logical_len=Tp + M)[0][0]
    del p32
    torch.cuda.empty_cache()
    e_suffix = float((got - f32).abs().max())
    e_full = float((full - f32).abs().max())
    log(f"  (b) the hit's first logits (K9 suffix after the COW copy) against the f32 plain "
        f"full prefill: max|err| {e_suffix:.4e}; the bf16 full prefill's (K1) {e_full:.4e}; "
        f"suffix against full {float((got - full).abs().max()):.4e} (|logits| up to "
        f"{float(f32.abs().max()):.3f}); argmax suffix {int(got.argmax())}, full "
        f"{int(full.argmax())}, f32 {int(f32.argmax())}; tolerance: the suffix's error at "
        f"most {SUFFIX_FACTOR} x the full prefill's")
    if not math.isfinite(e_suffix) or e_suffix > SUFFIX_FACTOR * e_full:
        fail(f"(b) suffix logits err {e_suffix:.4e} against f32, more than {SUFFIX_FACTOR} x "
             f"the full prefill's {e_full:.4e}")
    # the greedy decode, eagerly (the same kernels a replay runs), each
    # step's logits kept
    sess._loop.use_graph = False
    sess_mod._serving_sample = recording_sample
    try:
        while not sess.step().all():
            pass
    finally:
        sess_mod._serving_sample = real_sample
    out, n = sess.state["out"].cpu().numpy(), sess.state["n_gen"].cpu().numpy()
    streams = [out[r, :n[r]].tolist() for r in range(2)]
    delta = 0.0
    for r, prompt in enumerate((a, b)):
        route = torch.stack([(first_a, got)[r]] + [st[r] for st in steps[:n[r] - 1]])
        delta = max(delta, float((route - full_logits(torch, mcfg, params, prompt,
                                                       streams[r], pad)).abs().max()))
    log(f"  (b) the session's logits (K9 suffixes, then K7 decode steps) against the full "
        f"forward (K1) over the same {int(n.sum())} tokens: max|diff| {delta:.4e}")
    q = torch.as_tensor(np.stack([r[0] for r in rows]), device="cuda")
    mono = generate(params, mcfg, q, q != pad, torch.Generator(device="cuda").manual_seed(0),
                    SamplingParams(greedy=True, max_tokens=M, page_size=P),
                    eos_token_id=eos, pad_token_id=pad).cpu().numpy()
    near_tie = NEAR_TIE_FACTOR * 2 * delta
    compare_streams(torch, "(b) session (radix, K9 suffixes) against the monolithic paged "
                    "sampler (K1 prefill)", mcfg, params,
                    [(t, _cut_at_eos(mono[r], eos), streams[r])
                     for r, t in enumerate((a, b))], pad, near_tie)
    return delta


@contextlib.contextmanager
def recording_streams(engine, streams: dict):
    """Tee each request's stream (and its submit's arguments) into
    `streams` by request id, as the gateway and the driver read them."""
    submit, stream = engine.submit, engine.stream

    def rec_submit(tokens, **kw):
        req, reason = submit(tokens, **kw)
        if req is not None:
            streams[req.request_id] = (tuple(int(t) for t in tokens), kw, [])
        return req, reason

    def rec_stream(req, timeout=120.0):
        for tok in stream(req, timeout=timeout):
            streams[req.request_id][2].append(tok)
            yield tok

    engine.submit, engine.stream = rec_submit, rec_stream
    try:
        yield
    finally:
        engine.submit, engine.stream = submit, stream


def serve_run(torch, what: str, mcfg, params, tok, traffic, over_http: bool, **engine_kw):
    """One engine (SERVE, on the card, a latency hub) under one traffic
    (a WorkloadSpec or a request list), through its gateway on 127.0.0.1 and
    the driver over HTTP, or the driver in process; kernel counts reset just
    before the traffic and read just after. Returns the run's record."""
    import json as _json
    import urllib.request

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.loadgen import TrafficDriver
    from nanorlhf_tpu_torch.serving import ServingEngine, ServingGateway
    from nanorlhf_tpu_torch.telemetry import LatencyHub
    from nanorlhf_tpu_torch.telemetry.exporter import validate_prometheus_text

    hub = LatencyHub()
    eng = ServingEngine(params, mcfg, eos_token_id=tok.eos_token_id,
                        pad_token_id=tok.pad_token_id, latency=hub, max_queue=64,
                        seed=SERVE_SEED, device="cuda", **SERVE, **engine_kw)
    gw = ServingGateway(eng, port=-1, host="127.0.0.1") if over_http else None
    streams: dict = {}
    try:
        driver = (TrafficDriver(base_url=f"http://127.0.0.1:{gw.port}", stream_timeout_s=600)
                  if over_http else TrafficDriver(engine=eng, stream_timeout_s=600))
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with recording_streams(eng, streams):
            summary = driver.run(traffic)
        counts = _build.launch_counts()
        scraped = None
        if over_http:
            base = f"http://127.0.0.1:{gw.port}"
            text = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
            problems = validate_prometheus_text(text)
            statusz = _json.loads(urllib.request.urlopen(base + "/statusz", timeout=60).read())
            health = urllib.request.urlopen(base + "/healthz", timeout=60).status
            if problems or health != 200 or "prefix_cache" not in statusz:
                fail(f"{what}: /metrics {problems[:3]}, /healthz {health}, /statusz keys "
                     f"{sorted(statusz)}")
            scraped = len(text.splitlines())
    finally:
        if gw is not None:
            gw.close()
        eng.close()
    snap = eng.snapshot()
    lat = hub.snapshot()
    emitted = sum(r.tokens for r in summary.records if r.outcome == "completed")
    ttft, gap = lat.get("latency/ttft_s", {}), lat.get("latency/intertoken_s", {})
    radix = snap["prefix_cache"]
    log(f"  {what}: {summary.completed}/{summary.offered} completed, shed {summary.shed}, "
        f"errors {summary.errors}, in {summary.duration_s:.3f} s; client TTFT p50 "
        f"{1e3 * (summary.p50_ttft_s or 0):.2f} ms, p95 {1e3 * (summary.p95_ttft_s or 0):.2f} "
        f"ms; engine TTFT p50 {1e3 * ttft.get('p50_s', 0):.2f} ms, p95 "
        f"{1e3 * ttft.get('p95_s', 0):.2f} ms; inter-token p50 "
        f"{1e3 * gap.get('p50_s', 0):.3f} ms, p95 {1e3 * gap.get('p95_s', 0):.3f} ms; "
        f"{emitted} tokens emitted, {emitted / summary.duration_s:.1f} tokens/s; prefill "
        f"tokens dispatched {snap['prefill_token_dispatch']}, saved by the radix cache "
        f"{radix['hit_tokens']} (hit_frac {radix['hit_frac']:.4f}), cow_splits "
        f"{radix['cow_splits']}, shared pages acquired {radix['shared_pages_acquired']}; "
        f"session counters {snap['session']['counters']}; launches {_nonzero(counts)}"
        + (f"; /metrics {scraped} lines, valid" if scraped else ""))
    if summary.completed != summary.offered or summary.errors or summary.shed:
        fail(f"{what}: not every request completed ({summary.shed_reasons})")
    # K9 admits every request (its suffix forward), and verifies the spec
    # engine's drafts; K7 decodes the other engines' rows
    if counts["paged_decode_verify_attention"] <= 0 or (
            counts["paged_decode_attention"] <= 0) != bool(engine_kw.get("spec_k")):
        fail(f"{what}: K9 never launched, or K7 launched by the spec engine or never by "
             f"another")
    for name in ("decode_attention", "decode_verify_attention", "decode_attention_q8",
                 "paged_decode_attention_q8", "flash_fwd"):
        if counts[name]:
            fail(f"{what}: {name} launched {counts[name]} times: the engine admits through "
                 "K9 suffixes and decodes through K7 (or K9) only")
    by_tokens = {}
    for prompt, kw, got in streams.values():
        by_tokens[prompt, bool(kw.get("greedy"))] = got
    return dict(summary=summary, snap=snap, counts=counts, streams=by_tokens,
                emitted=emitted, ttft=ttft, gap=gap)


def serving(torch, card: str, seen_v, seen: dict) -> dict:
    """Phase 14 (b)-(d) (module docstring): K9's shapes recorded in `seen_v`
    throughout, (d)'s K1, K2/K3, K10 and K4 shapes in `seen`. Returns each
    run's launch counts."""
    import dataclasses

    import numpy as np

    from nanorlhf_tpu_torch.entrypoints.common import resolve_model
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config
    from nanorlhf_tpu_torch.loadgen import WorkloadSpec, sample_requests
    from nanorlhf_tpu_torch.sampler.sampler import SamplingParams, generate

    t_phase = time.perf_counter()
    _loopback_only()
    launcher = build_config()
    mcfg, params, tok = resolve_model(launcher.sft_model_path, SERVE_SEED, device="cuda")
    eos, pad = tok.eos_token_id, tok.pad_token_id
    # the launcher's init scales every projection by 1/sqrt(L): rescaled to
    # N(0, 1/fan_in), as the small-input references are, so that 28 layers
    # of bf16 keep the logits' rounding small against their spread
    L = mcfg.num_hidden_layers
    for entry in params["layers"].values():
        if isinstance(entry, dict):
            entry["kernel"].mul_(math.sqrt(L / entry["kernel"].shape[-1]))
    with recording_verify_shapes(seen_v):
        delta = serve_suffix(torch, mcfg, params, eos, pad)
    near_tie = NEAR_TIE_FACTOR * 2 * delta
    log(f"  near tie below: a top-2 margin or an argmax gap of at most {near_tie:.4e}: "
        f"{NEAR_TIE_FACTOR} x twice (b)'s route noise (two logits each moved by up to it)")

    spec = WorkloadSpec(**SERVE_TRAFFIC, temp_min=launcher.temperature,
                        temp_max=launcher.temperature, top_p_min=launcher.top_p,
                        top_p_max=launcher.top_p)
    reqs = sample_requests(spec)
    greedy = [r for r in reqs if r.greedy]
    log(f"  (c) traffic: {spec.n_requests} requests, Poisson at {spec.rate_rps}/s over "
        f"{reqs[-1].t_offset:.3f} s, {len(greedy)} greedy, prompts of "
        f"{min(len(r.tokens) for r in reqs)}-{max(len(r.tokens) for r in reqs)} real tokens, "
        f"{sum(r.prefix_group >= 0 for r in reqs)} in 4 tenants of a 384-token prefix; "
        f"engine {SERVE}, sampled at temperature {launcher.temperature}, top-p "
        f"{launcher.top_p}")
    with recording_verify_shapes(seen_v):
        main = serve_run(torch, "(c) the engine behind its gateway, the driver over HTTP",
                         mcfg, params, tok, spec, over_http=True)
    radix = main["snap"]["prefix_cache"]
    if radix["hit_tokens"] <= 0 or radix["shared_pages_acquired"] <= 0:
        fail(f"(c) the radix cache saved nothing: {radix}")
    # the rollout scheduler's greedy rows for the greedy requests' prompts
    q = torch.as_tensor(np.stack([_left_pad(r.tokens, SERVE["prompt_len"], pad)[0]
                                  for r in greedy]), device="cuda")
    t0 = time.perf_counter()
    rollout = generate(params, mcfg, q, q != pad, torch.Generator(device="cuda").manual_seed(0),
                       SamplingParams(greedy=True, max_tokens=SERVE["max_new_tokens"],
                                      page_size=SERVE["page_size"],
                                      decode_rows=SERVE["rows"]),
                       eos_token_id=eos, pad_token_id=pad).cpu().numpy()
    log(f"  (c) the rollout scheduler's greedy rows for the {len(greedy)} greedy prompts "
        f"({SERVE['rows']} resident, P={SERVE['page_size']}): {time.perf_counter() - t0:.3f} s")
    check_greedy_tokens(torch, "(c) the engine's greedy streams", mcfg, params,
                        [(r.tokens, main["streams"][r.tokens, True]) for r in greedy], pad,
                        near_tie)
    compare_streams(torch, "(c) engine against the rollout scheduler", mcfg, params,
                    [(r.tokens, _cut_at_eos(rollout[i], eos), main["streams"][r.tokens, True])
                     for i, r in enumerate(greedy)], pad, near_tie)

    with recording_verify_shapes(seen_v):
        chunked = serve_run(torch, "(c) prefill_chunk=128, the same traffic over HTTP", mcfg,
                            params, tok, spec, over_http=True, prefill_chunk=128)
    if chunked["snap"]["session"]["counters"]["chunked_admissions"] <= 0:
        fail("(c) prefill_chunk=128: no admission was chunked")
    check_greedy_tokens(torch, "(c) prefill_chunk=128, the greedy streams", mcfg, params,
                        [(r.tokens, chunked["streams"][r.tokens, True]) for r in greedy], pad,
                        near_tie)
    compare_streams(torch, "(c) prefill_chunk=128 against unchunked", mcfg, params,
                    [(r.tokens, main["streams"][r.tokens, True],
                      chunked["streams"][r.tokens, True]) for r in greedy], pad, near_tie)

    greedy_full = [dataclasses.replace(r, greedy=True) for r in greedy]
    with recording_verify_shapes(seen_v):
        spec_run = serve_run(torch, "(c) spec_k=4, the greedy requests in process", mcfg,
                             params, tok, greedy_full, over_http=False, spec_k=4)
    check_greedy_tokens(torch, "(c) spec_k=4, the greedy streams", mcfg, params,
                        [(r.tokens, spec_run["streams"][r.tokens, True]) for r in greedy], pad,
                        near_tie)
    compare_streams(torch, "(c) spec_k=4 against spec off", mcfg, params,
                    [(r.tokens, main["streams"][r.tokens, True],
                      spec_run["streams"][r.tokens, True]) for r in greedy], pad, near_tie)
    del params
    torch.cuda.empty_cache()

    log("  (d) one GRPO update with rollout_prefix_cache=True, rollout_prefill_chunk=128 "
        "on phase 5's config")
    with recording_verify_shapes(seen_v), recording_all_shapes(seen):
        counts_d = serve_update(torch, card)
    log(f"  phase 14 (b)-(d) wall {time.perf_counter() - t_phase:.1f} s (card: {card})")
    return {"engine": main["counts"], "chunked": chunked["counts"],
            "spec": spec_run["counts"], "update": counts_d}


def serve_update(torch, card: str) -> dict:
    """(d) `one_card_cut(build_config())` at phase 5's paged, queued config
    (512 tokens, pages of 128, 32 resident rows) with the radix prefix cache
    and chunked prefill, through `build_trainer` + `train(1)`: finite rows,
    the session/* and prefix rows, the trainer's /statusz `prefix_cache`
    snapshot; the launch counts reset just before and read just after."""
    import json as _json
    import os
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut

    cfg = one_card_cut(build_config())
    cfg.rollout_page_size, cfg.rollout_decode_rows = 128, 32
    cfg.rollout_prefix_cache, cfg.rollout_prefill_chunk = True, 128
    log(f"CUT: response_length {cfg.response_length} -> 512")
    cfg.response_length = 512
    cfg.output_dir = _serve_dir("run")
    shutil.rmtree(_serve_dir(), ignore_errors=True)
    tr = build_trainer(cfg, device="cuda")
    try:
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        state = tr.train(num_updates=1)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        with open(os.path.join(cfg.output_dir, "metrics.jsonl")) as fh:
            row = _json.loads(fh.readlines()[-1])
        keys = ("session/dispatch_events", "session/chunked_admissions",
                "session/prefill_backlog", "rollout/prefix_hit_frac", "pages/shared",
                "rollout/page_utilization", "loss/policy_avg_new", "policy/grad_norm_new")
        status = tr._statusz()
        snap, t = status["prefix_cache"], tr.last_timings
        log(f"  (d) update {state['global_step']}: rollout {t['generate_s']:.3f} s, update "
            f"{t['update_s']:.3f} s; rows {{{', '.join(f'{k}: {row.get(k)}' for k in keys)}}}; "
            f"/statusz prefix_cache {snap}; session counters "
            f"{status['session']['counters']}; launches {_nonzero(counts)} (card: {card})")
        missing = [k for k in keys if not math.isfinite(row.get(k, float("nan")))]
        if missing or state["global_step"] != 1:
            fail(f"(d) rows missing or not finite: {missing}")
        if not snap or snap["lookups"] != cfg.batch_size * cfg.sample_n \
                or snap["hit_tokens"] <= 0 or row["rollout/prefix_hit_frac"] <= 0:
            fail(f"(d) the trainer's radix cache: {snap}")
        if status["session"]["features"] != {
                "spec_k": 0, "prefix_cache": True, "prefill_chunk": 128,
                "per_row_sampling": False, "drafter_seed_window": 0}:
            fail(f"(d) session features {status['session']['features']}")
        for name in ("paged_decode_attention", "paged_decode_verify_attention", "flash_fwd",
                     "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob"):
            if counts[name] <= 0:
                fail(f"(d) {name} never launched")
    finally:
        _free(torch, tr)
        shutil.rmtree(_serve_dir(), ignore_errors=True)
    return counts


def verify_bound(torch, c, table_bytes: int = 0) -> tuple[float, str]:
    """The least time of a verify call on case `c`: each valid key's K and V
    read once, q read and out written once, the bounds (and the table);
    4 flops a (row, query, key, dim) pair of QK^T and PV."""
    B, H, Tq, hd, KV, T = (c[n] for n in ("B", "H", "Tq", "hd", "KV", "T"))
    start, fill = c["start"], c["fill"]
    qi = torch.arange(Tq, device="cuda")[None, :]
    hi = torch.clamp(fill[:, None] + qi + 1, max=T)
    pairs = float((hi - start[:, None]).clamp(min=0).sum())   # (row, query) x key
    keys = float((torch.clamp(fill + Tq, max=T) - start).clamp(min=0).sum())
    nbytes = 2 * (2 * keys * KV * hd) + 2 * 2 * B * H * Tq * hd + 8 * B + table_bytes
    return bound_ms(nbytes, 4.0 * pairs * H * hd)


def _serve_verify_case(torch, gen, Tq: int, start: int, fill: int, nb: int, copies: int = 4):
    """One row of the serving path's K9 call: q [1, 12, Tq, 128], its K/V
    [1, 2, nb·128, 128] laid out contiguously and through a table of
    distinct pages scattered through a pool with spare ones; `copies` K/V
    sets (> L2 where 28 layers would be)."""
    P, H, KV, hd = SERVE["page_size"], 12, 2, 128
    T = nb * P

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    N = nb + 7
    table = torch.randperm(N, generator=gen, device="cuda")[:nb].reshape(1, nb).int()
    caches = [(randn(1, KV, T, hd), randn(1, KV, T, hd)) for _ in range(copies)]
    s = torch.tensor([start], device="cuda").int()
    f = torch.tensor([fill], device="cuda").int()
    qi = torch.arange(Tq, device="cuda")[None, :]
    return dict(q=randn(1, H, Tq, hd), caches=caches, B=1, H=H, KV=KV, Tq=Tq, hd=hd, T=T,
                P=P, nb=nb, N=N, table=table, start=s, fill=f,
                empty=f[:, None] + qi + 1 <= s[:, None],
                pools=[(_scatter(torch, k, table, N, P), _scatter(torch, v, table, N, P))
                       for k, v in caches])


def _time_k9(torch, F, c) -> dict:
    """K9 on case `c`: events over the K/V copies in turns, device time,
    the plain version, the yardstick (not one call: SDPA with a boolean
    mask over the pre-gathered view) and the bound."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    q, start, fill, table = c["q"], c["start"], c["fill"], c["table"]
    kp, vp = c["pools"][0]
    it = iter(range(10**9))

    def k9():
        kk, vv = c["pools"][next(it) % len(c["pools"])]
        da.paged_decode_verify_attention(q, kk, vv, table, start, fill)

    ms = time_ms(torch, k9, 40)
    on_card = dev_total(device_ms(torch, k9, 20, "verify_kernel"))
    plain = time_ms(torch, lambda: da.reference_paged_decode_verify_attention(
        q, kp, vp, table, start, fill), 10)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    pos = torch.arange(c["T"], device="cuda")[None, None, :]
    qi = torch.arange(c["Tq"], device="cuda")[None, :, None]
    m = ((pos >= start[:, None, None]) & (pos < fill[:, None, None] + qi + 1))[:, None]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=m, enable_gqa=True), 20)
    gather = time_ms(torch, lambda: (da._gather_pool(kp, table), da._gather_pool(vp, table)),
                     10)
    b = verify_bound(torch, c, 4 * table.numel())
    return dict(ms=ms, device_ms=on_card, plain_ms=plain, library_ms=lib, gather_ms=gather,
                bound_ms=b[0], bound_by=b[1])


def hold_serve_verify(torch, F, seen_v, held: set) -> list:
    """(a) K9 at SERVE_TQ and at every shape phase 14 gave it (recorded in
    `seen_v`), as phase 2 holds it (`_hold_verify`: within one bf16 ulp of
    the f32 plain version per element, K9 == K6 on the same logical cache,
    K6 at Tq = 1 against K4, the split count the rule's): one row's shapes
    on a mid-page hit (start 37, fill 203: a left-padded prefix, the
    candidates straddling pages) and a cold suffix (start = fill = 129),
    rows of the spec engine's shapes as phase 2 holds them. Then each
    one-row shape's times at the engine's table width. Returns the kernels
    line's `serve` shape rows."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    P = SERVE["page_size"]
    nb = -(-(SERVE["prompt_len"] + SERVE["max_new_tokens"]) // P)
    given = {(s[1], s[3], s[7]) for s in seen_v if s[0] == "paged_decode_verify_attention"}
    shapes = sorted(given | {(1, Tq, nb) for Tq in SERVE_TQ})
    log(f"  (a) K9 calls by shape (name, B, H, Tq, hd, KV, P, nb) in phase 14: "
        f"{dict(seen_v)}; held at (B, Tq, nb) {shapes}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for B, Tq, n in shapes:
        T = n * P
        if B > 1:
            if ("paged_decode_verify_attention", B, 12, Tq, 128, 2, P, n) in held:
                continue
            _hold_verify(torch, f"phase 14 B={B} Tq={Tq} T_max={T}",
                         _verify_case(torch, gen, B, 12, 2, Tq, 128, T, 256, P=P))
            continue
        fill = min(203, T - Tq)
        fill -= fill % P == 0
        cold = min(129, T - Tq)
        cold -= cold % P == 0
        for label, s, f in (("hit", min(37, fill), fill), ("cold", cold, cold)):
            c = _serve_verify_case(torch, gen, Tq, s, f, n)
            e6, e9 = _hold_verify(torch, f"phase 14 {label} Tq={Tq} start={s} fill={f} "
                                  f"T_max={T}", c)
            if label == "hit" and n == nb:       # the engine's shapes are timed
                t = _time_k9(torch, F, c)
                shape = (f"B=1 H=12 KV=2 Tq={Tq} hd=128 P={P} nb={n} start={s} fill={f}, "
                         f"S={da.verify_split_count_on_card(1, 2)}, "
                         f"{-(-6 * Tq // 32)} row groups a kv head")
                log(f"  K9 {shape}: kernel {t['ms']:.4f} ms, device time (profiler) "
                    f"{fmt_ms(t['device_ms'])}; plain {t['plain_ms']:.4f} ms; yardstick (not "
                    f"one call: SDPA over the pre-gathered view) {t['library_ms']:.4f} ms + "
                    f"gather {t['gather_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
                    f"({t['bound_by']})")
                rows.append(dict(shape=shape, max_abs_err=e9, given=(B, Tq, n) in given,
                                 **{k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                                      "library_ms", "gather_ms",
                                                      "bound_ms", "bound_by")}))
    return rows


def serve_entries(torch, F, seen_v, counts: dict, held: set) -> dict:
    """(a) and the holds of K7 at the engine's decode shape (32 rows,
    T_max 768, pages of 128, as phase 2 holds K7); the kernels line's
    `serve` entries of K7 and K9: their launches in each run of phase 14
    (counts reset just before it) and their times at its shapes."""
    rows = hold_serve_verify(torch, F, seen_v, held)
    k7 = check_paged(torch, F, SERVE["prompt_len"], SERVE["max_new_tokens"])
    k7 = k7["paged_decode_attention"]
    return {
        "paged_decode_attention": {
            "launches": {run: c["paged_decode_attention"] for run, c in counts.items()},
            **{k: k7[k] for k in ("shape", "ms", "device_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by", "max_abs_err")}},
        "paged_decode_verify_attention": {
            "launches": {run: c["paged_decode_verify_attention"]
                         for run, c in counts.items()},
            "shapes": rows},
    }


# --------------------------------------------------------------------------
# phases 15 and 16: multi-turn GRPO over the python-tool environment, the
# chaos harness's serving soak
# --------------------------------------------------------------------------

PHASE15 = ("phase 15: multi-turn GRPO — the python-tool environment, the pooled executor, "
           "the episode driver on the paged session, Qwen2.5-1.5B width")
PHASE16 = ("phase 16: the chaos harness's serving soak on the engine, Qwen2.5-1.5B width")
# the tool call phase 15 plants (random weights never write a fenced
# ```python block): the environment's own `extractor` returns it for every
# turn, and the pooled executor runs it in its spawned child
ENV_PROGRAM = "print(sum(i * i for i in range(12)))"
ENV_STDOUT = "506"
# the two greedy runs of phase 15 (c): tool calls answered at once, and every
# other call delayed by this many seconds (another completion order)
ENV_DELAY = "env.hang:every=2,delay=0.05"
# phase 15 (b): one crashed tool call and one delayed by a second
ENV_FAULTS = "env.crash:at=1 env.hang:at=2,delay=1.0"
# (c): each route's logits (turn 1's generate; a continuation's K1 paged
# prefill and K7 steps) against the f32 plain full forward may err up to
# this many times the bf16 full forward's error (both round to bf16 at
# other places; 0.97-1.01 read on an H100)
ENV_ROUTE_FACTOR = 1.5
# ... and may differ from the bf16 full forward (K1) by at most this share
# of the bf16 full forward's error of f32: two roundings of one function
# (0.13-0.24 read on an H100); a continuation whose context lost
# its observation must read above it
ENV_ROUTE_SHARE = 0.5
# the episodes whose two turns measure (c)'s route noise
ENV_NOISE_EPISODES = (0, 16)
# the soak's model: the launcher's geometry, random weights from this seed
SOAK_SEED = 16
# the phase-15 kernels whose launches the kernels line reports
ENV_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_logprob",
               "paged_decode_attention")


def _envs_dir(*parts) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "output",
                        "chip_smoke_envs", *parts)


def env_config():
    """`one_card_cut(build_config(env_name="python_tool", env_max_turns=2))`
    cut to 512 tokens, the launcher's rule giving the turn and observation
    budgets (`grpo.env_budgets`); no checkpoint."""
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config, env_budgets, one_card_cut

    cfg = one_card_cut(build_config(env_name="python_tool", env_max_turns=2))
    log(f"CUT: response_length {cfg.response_length} -> 512 (turns "
        f"{cfg.env_turn_tokens} -> 128 tokens, observations {cfg.env_obs_budget} -> 256); "
        f"save_steps {cfg.save_steps} -> 0")
    cfg.response_length = 512
    env_budgets(cfg)
    cfg.save_steps = 0
    cfg.output_dir = _envs_dir("run")
    return cfg


@contextlib.contextmanager
def capturing_env_runs(payloads: list, batches: list):
    """Keep every episode payload the driver returns and every batch the
    trainer assembles (the driver's and the assembly's code unchanged)."""
    from nanorlhf_tpu_torch.envs import rollout as envroll
    from nanorlhf_tpu_torch.trainer import trainer as trainer_mod

    run, asm = envroll.run_env_episodes, trainer_mod.assemble_batch
    envroll.run_env_episodes = lambda *a, **k: payloads.append(run(*a, **k)) or payloads[-1]
    trainer_mod.assemble_batch = lambda *a, **k: batches.append(asm(*a, **k)) or batches[-1]
    try:
        yield
    finally:
        envroll.run_env_episodes, trainer_mod.assemble_batch = run, asm


def check_episodes(what: str, p: dict, rows: int) -> None:
    """The episode payload's contract: every episode two turns and one
    admission, pages recycled, the loss mask False exactly on the recorded
    observation spans, the scores the turn rewards' sums."""
    import numpy as np

    st = p["stats"]
    if st["env/turns_per_episode"] != 2.0 or p["admissions"] != rows \
            or p["pages_recycled"] <= 0:
        fail(f"{what}: turns_per_episode {st['env/turns_per_episode']}, admissions "
             f"{p['admissions']} (want {rows}), pages_recycled {p['pages_recycled']}")
    want = np.ones_like(p["loss_mask"])
    for rec in p["turns"]:
        if rec["obs_range"]:
            a, b = rec["obs_range"]
            want[rec["row"], a:b] = False
    if not np.array_equal(p["loss_mask"], want) or want.all():
        fail(f"{what}: the loss mask is not False exactly on the observation spans")
    if not np.array_equal(p["scores"], p["turn_rewards"].sum(1)):
        fail(f"{what}: scores are not the turn rewards' sums")


@contextlib.contextmanager
def stamping_hangs(inj, hangs: list, beats: list, admits: list):
    """Record each delayed env.hang fire of `inj` as (episode, start,
    delay), and the start of every decode session beat and admission."""
    from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession

    fire, step, admit = inj.fire, DecodeSession.step, DecodeSession.admit

    def stamped_fire(point, worker=None):
        t0 = time.perf_counter()
        act = fire(point, worker=worker)
        if point == "env.hang" and act and act.startswith("delay:"):
            hangs.append((worker, t0, float(act.split(":", 1)[1])))
        return act

    def stamped_step(self):
        beats.append(time.perf_counter())
        return step(self)

    def stamped_admit(self, *a, **kw):
        admits.append(time.perf_counter())
        return admit(self, *a, **kw)

    inj.fire, DecodeSession.step, DecodeSession.admit = stamped_fire, stamped_step, stamped_admit
    try:
        yield
    finally:
        inj.fire, DecodeSession.step, DecodeSession.admit = fire, step, admit


@contextlib.contextmanager
def keeping_logits(kept: list):
    """Keep the logits of every one-row draw of the sampler and the paged
    session (the first row's, f32)."""
    from nanorlhf_tpu_torch.sampler import sampler as smod
    from nanorlhf_tpu_torch.sampler.paged import session as sess_mod

    real = smod._sample_token

    def keeping(generator, logits, *a, **kw):
        kept.append(logits[0].float().clone())
        return real(generator, logits, *a, **kw)

    smod._sample_token = sess_mod._sample_token = keeping
    try:
        yield
    finally:
        smod._sample_token = sess_mod._sample_token = real


def env_route_noise(torch, tr, cfg, queries, run: dict, prompts, width: int) -> float:
    """(c)'s near-tie allowance, measured on the routes (c) holds (module
    docstring): for each of ENV_NOISE_EPISODES, turn 1's `generate` on its
    prompt alone and an empty-start session's continuation on its turn-2
    context from `run`, greedy and eager (`per_step`), each step's logits
    kept, against the bf16 full forward (K1) and the f32 plain full
    forward over the route's own stream. Fails if a route errs more than
    ENV_ROUTE_FACTOR x the bf16 full forward's error of f32, or differs
    from the bf16 full forward by more than ENV_ROUTE_SHARE of that error;
    a planted fault, the first episode's continuation admitted without its
    observation, must differ by more. Returns the largest difference of
    the sound routes from the bf16 full forward."""
    import dataclasses

    import numpy as np

    from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
    from nanorlhf_tpu_torch.sampler.sampler import generate
    from nanorlhf_tpu_torch.trainer.rollout import env_sampling_params, rollout_model_config

    pad, eos = tr.tokenizer.pad_token_id, tr.tokenizer.eos_token_id
    sampling = dataclasses.replace(env_sampling_params(cfg), greedy=True, n=1,
                                   decode_loop="per_step")
    params, gen_mcfg = tr._rollout_params(), rollout_model_config(tr.mcfg, cfg)
    Tp_ep = width - sampling.max_tokens
    routes = []  # (route, context, stream, logits [n, V])
    with torch.no_grad():
        for ep in ENV_NOISE_EPISODES:
            pairs = _episode_pairs(run, prompts, pad, [ep])
            if len(pairs) != 2:
                fail(f"(c) episode {ep} cannot measure the route noise: {len(pairs)} held turns")
            kept: list = []
            q = torch.as_tensor(queries[ep // cfg.sample_n][None], device="cuda")
            with keeping_logits(kept):
                toks = generate(params, gen_mcfg, q, q != pad,
                                torch.Generator(device="cuda").manual_seed(0), sampling,
                                eos_token_id=eos, pad_token_id=pad, lora_scale=tr.lora_scale)
            stream = _cut_at_eos(toks[0].cpu().numpy(), eos)
            routes.append(("turn 1 (generate)", pairs[0][0], stream,
                           torch.stack(kept[:len(stream)])))
            ctx = pairs[1][0]
            streams = {}
            obs = next(r["obs_range"] for r in run["turns"] if r["row"] == ep and r["obs_range"])
            n_obs = obs[1] - obs[0]
            for what, admitted in (("continuation (K1 paged prefill, K7 steps)", ctx),
                                   ("planted: the continuation without its observation",
                                    ctx[:len(ctx) - n_obs])):
                if what.startswith("planted") and ep != ENV_NOISE_EPISODES[0]:
                    continue
                ids = np.full(Tp_ep, pad, np.int64)
                ids[Tp_ep - len(admitted):] = admitted
                mask = np.zeros(Tp_ep, bool)
                mask[Tp_ep - len(admitted):] = True
                sess = DecodeSession(
                    params, gen_mcfg, rows=1, prompt_len=Tp_ep, max_tokens=sampling.max_tokens,
                    page_size=cfg.rollout_page_size, eos_token_id=eos, pad_token_id=pad,
                    generator=torch.Generator(device="cuda").manual_seed(0),
                    temperature=sampling.temperature, top_p=sampling.top_p, greedy=True,
                    top_k=sampling.top_k, approx_top_k=sampling.approx_top_k,
                    lora_scale=tr.lora_scale, sync_every=sampling.sync_every,
                    decode_loop="per_step", empty_start=True)
                kept = []
                with keeping_logits(kept):
                    sess.admit(0, ids, mask, 0)
                    while not sess.step()[0]:
                        pass
                n = int(sess.state["n_gen"][0])
                stream = [int(t) for t in sess.state["out"][0, :n].cpu()]
                # both are held against the full forward over the true context
                routes.append((what, ctx, stream, torch.stack(kept[:n])))
                del sess
        plain = dataclasses.replace(tr.mcfg, attention_impl="xla")
        p32 = _tree_map(lambda t: t.float(), tr.params)
        delta = 0.0
        for what, ctx, stream, got in routes:
            if len(got) != len(stream):
                fail(f"(c) {what}: {len(got)} kept logits for {len(stream)} tokens")
            full = full_logits(torch, tr.mcfg, tr.params, ctx, stream, pad, width, tr.lora_scale)
            f32 = full_logits(torch, plain, p32, ctx, stream, pad, width, tr.lora_scale)
            d = float((got - full).abs().max())
            e_route, e_full = float((got - f32).abs().max()), float((full - f32).abs().max())
            log(f"  (c) route noise, {what}, {len(stream)} tokens: max|route - K1 full| "
                f"{d:.4e} ({d / e_full:.3f} of the bf16 full forward's error, at most "
                f"{ENV_ROUTE_SHARE}); against the f32 plain full forward: route {e_route:.4e}, "
                f"bf16 full {e_full:.4e} (at most {ENV_ROUTE_FACTOR} x); |logits| up to "
                f"{float(f32.abs().max()):.3f}")
            if what.startswith("planted"):
                if not d > ENV_ROUTE_SHARE * e_full:
                    fail(f"(c) {what} differs from the full forward by only {d:.4e}: the "
                         f"bound {ENV_ROUTE_SHARE} x {e_full:.4e} cannot tell a wrong route")
                continue
            if not math.isfinite(e_route) or e_route > ENV_ROUTE_FACTOR * e_full:
                fail(f"(c) the {what} route errs {e_route:.4e} against f32, more than "
                     f"{ENV_ROUTE_FACTOR} x the full forward's {e_full:.4e}")
            if d > ENV_ROUTE_SHARE * e_full:
                fail(f"(c) the {what} route differs from the full forward by {d:.4e}, more "
                     f"than {ENV_ROUTE_SHARE} x its error of f32 {e_full:.4e}")
            delta = max(delta, d)
    del p32
    torch.cuda.empty_cache()
    return delta


def _episode_pairs(p: dict, prompts, pad: int, eps) -> list:
    """(context, model tokens) of each turn of episodes `eps`: the turn's
    context is the real prompt, the earlier turns and observations. An
    episode that sampled the pad id is left out (the full forward masks
    that token as padding; the episode's rows do not)."""
    pairs = []
    for ep in eps:
        if pad in p["tokens"][ep][:p["turn_ends"][ep].max() + 1]:
            log(f"    episode {ep} sampled the pad id: not held against the full forward")
            continue
        prompt = [int(t) for t in prompts[ep] if t != pad]
        for rec in sorted((r for r in p["turns"] if r["row"] == ep), key=lambda r: r["turn"]):
            a, b = rec["tok_range"]
            if b > a:
                pairs.append((prompt + [int(t) for t in p["tokens"][ep][:a]],
                              [int(t) for t in p["tokens"][ep][a:b]]))
    return pairs


def multi_turn(torch, card: str, seen: dict) -> dict:
    """Phase 15 (module docstring): (a) one multi-turn GRPO update, (b) one
    under injected tool faults, (c) two greedy episode runs with other tool
    delays; the shapes K1, K2/K3, K10 and K4 were given recorded in `seen`.
    Returns each update's launch counts, K1's calls by shape and the
    session's decode shape."""
    import dataclasses
    import shutil

    import numpy as np

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.entrypoints.common import build_trainer
    from nanorlhf_tpu_torch.envs import run_env_episodes
    from nanorlhf_tpu_torch.resilience import FaultInjector
    from nanorlhf_tpu_torch.trainer.bucketing import depad_queries
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.rollout import env_sampling_params, rollout_model_config

    t_phase = time.perf_counter()
    cfg = env_config()
    shutil.rmtree(_envs_dir(), ignore_errors=True)
    tr = build_trainer(cfg, device="cuda")
    try:
        rows = cfg.batch_size * cfg.sample_n
        tr.env.extractor = lambda text: ENV_PROGRAM
        log(f"  config: {cfg.batch_size} prompts x {cfg.sample_n} samples = {rows} episodes "
            f"of {cfg.env_max_turns} turns, {cfg.env_turn_tokens} tokens a turn, observations "
            f"of at most {cfg.env_obs_budget}, pages of {cfg.rollout_page_size}, "
            f"{cfg.env_decode_rows or cfg.rollout_decode_rows or rows} resident rows; the tool "
            f"call planted through PythonToolEnv's extractor: {ENV_PROGRAM!r}")
        lora_b = {p: t.detach().clone() for p, t in flatten(tr.params).items()
                  if p[0] == "lora" and p[-1] == "b"}

        # (a) one update
        payloads, batches = [], []
        with capturing_env_runs(payloads, batches), recording_all_shapes(seen):
            _build.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            tr.train(num_updates=1)
            torch.cuda.synchronize()
            counts_a = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        (p,), ((batch, _),) = payloads, batches
        check_episodes("(a)", p, rows)
        t = tr.last_timings
        obs = [rec for rec in p["turns"] if rec["obs_range"]]
        out_text = tr.tokenizer.decode(p["tokens"][0][obs[0]["obs_range"][0]:
                                                     obs[0]["obs_range"][1]])
        if ENV_STDOUT not in out_text:
            fail(f"(a) episode 0's observation {out_text!r} lacks the tool's stdout "
                 f"{ENV_STDOUT}")
        bm = batch["loss_mask"]
        if (~bm).sum() <= 0 or bm.shape != batch["responses"].shape:
            fail(f"(a) the assembled batch's loss mask {bm.shape}: no observation token")
        st = tr.last_stats
        gn = [s["grad_norm"] for s in st]
        moved = sum(not torch.equal(t_.detach(), lora_b[k])
                    for k, t_ in flatten(tr.params).items() if k in lora_b)
        if not all(math.isfinite(g) and g > 0 for g in gn) or moved == 0:
            fail(f"(a) grad norms {gn}, LoRA B leaves moved {moved}/{len(lora_b)}")
        launches = tr.last_launches
        log(f"  (a) update 1: rollout {t['generate_s']:.3f} s (tools {t['tool_s']:.3f} s "
            f"of tool-thread wall, summed), scoring {t['score_s']:.3f} s, update "
            f"{t['update_s']:.3f} s, peak {peak:.2f} GB; env rows {p['stats']}; admissions "
            f"{p['admissions']}, pages recycled {p['pages_recycled']}; {int((~p['loss_mask']).sum())}"
            f" observation tokens masked, {int((~bm).sum())} in the kept batch; grad norms "
            f"{[round(g, 6) for g in gn]}, LoRA B leaves moved {moved}/{len(lora_b)}; "
            f"observation of episode 0: {out_text!r}; launches: rollout "
            f"{_nonzero(launches['generate'])}, scoring {_nonzero(launches['score'])}, update "
            f"{_nonzero(launches['update'])} (card: {card})")
        for name in ENV_KERNELS:
            if counts_a[name] <= 0:
                fail(f"(a) {name} never launched")
        Tp = batch["query_responses"].shape[1] - cfg.response_length
        Tp_ep = Tp + (cfg.env_max_turns - 1) * (cfg.env_turn_tokens + cfg.env_obs_budget)
        cont = seen["fwd"][(1, 12, 2, Tp_ep, 128)]
        if cont != rows * tr.mcfg.num_hidden_layers:
            fail(f"(a) {cont} K1 calls at the continuation shape (1, 12, 2, {Tp_ep}, 128), "
                 f"want {rows} admissions x {tr.mcfg.num_hidden_layers} layers")

        # (b) one update under injected tool faults
        st_a = p["stats"]
        tr.faults = FaultInjector.from_spec(ENV_FAULTS)
        payloads.clear()
        batches.clear()
        hangs, beats, admits = [], [], []
        with capturing_env_runs(payloads, batches), \
                stamping_hangs(tr.faults, hangs, beats, admits):
            _build.reset_launch_counts()
            tr.train(num_updates=1)
            torch.cuda.synchronize()
            counts_b = _build.launch_counts()
        (p,) = payloads
        st = p["stats"]
        hung = [rec for rec in p["turns"] if (rec["tool_wall_s"] or 0) >= 1.0]
        during = [(sum(t0 <= b <= t0 + d for b in beats),
                   sum(t0 <= b <= t0 + d for b in admits)) for _, t0, d in hangs]
        log(f"  (b) fault_spec {ENV_FAULTS!r}: env rows {st}; turns whose tool took >= 1 s: "
            f"{[(r['row'], r['turn'], r['tool_wall_s']) for r in hung]}; fires "
            f"{tr.faults.stats()}; while the hung call stalled (episode, delay: "
            f"{[(ep, d) for ep, _, d in hangs]}), session beats and admissions {during} of "
            f"{len(beats)} and {len(admits)}; (a) without faults: stalled rows "
            f"{st_a['env/stalled_rows']}, overlap {st_a['env/tool_stall_overlap']}")
        check_episodes("(b)", p, rows)
        if st["env/tool_errors"] != 1.0:
            fail(f"(b) env/tool_errors {st['env/tool_errors']}, want the one crash")
        if len(hangs) != 1 or not hung or not all(b > 0 and a > 0 for b, a in during):
            fail(f"(b) the hung call: fires {hangs}, turns >= 1 s {len(hung)}, session beats "
                 f"and admissions while it stalled {during}: the other episodes did not go "
                 f"on beside it")

        # (c) two greedy runs with other tool delays
        queries = depad_queries(next(tr.dataset.loader(cfg.batch_size, 17)),
                                tr.tokenizer.pad_token_id, tr.ctx_menu)
        q = torch.as_tensor(queries, device="cuda")
        pad, eos = tr.tokenizer.pad_token_id, tr.tokenizer.eos_token_id
        sampling = dataclasses.replace(env_sampling_params(cfg), greedy=True)
        gen_mcfg = rollout_model_config(tr.mcfg, cfg)
        runs = []
        for spec in (None, ENV_DELAY):
            t0 = time.perf_counter()
            runs.append(run_env_episodes(
                tr._rollout_params(), gen_mcfg, q, q != pad,
                torch.Generator(device="cuda").manual_seed(0), sampling, tr.env,
                eos_token_id=eos, pad_token_id=pad, tokenizer=tr.tokenizer,
                max_turns=cfg.env_max_turns, turn_tokens=sampling.max_tokens,
                obs_budget=cfg.env_obs_budget, response_length=cfg.response_length,
                page_size=cfg.rollout_page_size,
                decode_rows=cfg.env_decode_rows or cfg.rollout_decode_rows,
                lora_scale=tr.lora_scale, faults=FaultInjector.from_spec(spec)))
            check_episodes(f"(c) greedy, tools {spec or 'at once'}", runs[-1], rows)
            log(f"  (c) greedy episodes, tools {spec or 'answered at once'}: "
                f"{time.perf_counter() - t0:.3f} s, env rows {runs[-1]['stats']}")
        a, b = runs
        prompts = np.repeat(queries, cfg.sample_n, axis=0)
        differ = [ep for ep in range(rows) if not np.array_equal(a["tokens"][ep], b["tokens"][ep])]
        same_mask = np.array_equal(a["loss_mask"], b["loss_mask"]) and np.array_equal(
            a["turn_ends"], b["turn_ends"])
        log(f"  (c) {rows - len(differ)}/{rows} greedy episode streams equal token for token "
            f"across the two tool schedules; loss masks and turn ends "
            f"{'equal' if same_mask else 'differ'}")
        # every turn of the first episodes, and every episode that parted,
        # against the full forward's argmax over its context, within the
        # routes' own measured noise
        width = Tp_ep + cfg.env_turn_tokens
        delta = env_route_noise(torch, tr, cfg, queries, a, prompts, width)
        near_tie = NEAR_TIE_FACTOR * 2 * delta
        log(f"  (c) near-tie allowance {near_tie:.4e}: {NEAR_TIE_FACTOR} x twice the routes' "
            f"largest difference from the full forward, {delta:.4e}")
        pairs = _episode_pairs(a, prompts, pad, sorted(set(range(0, rows, 16)) | set(differ)))
        if not pairs:
            fail("(c) no held episode: every one sampled the pad id")
        check_greedy_tokens(torch, "(c) greedy episode turns", tr.mcfg, tr.params, pairs, pad,
                            near_tie, width, tr.lora_scale)
        if differ:
            pairs = _episode_pairs(b, prompts, pad, differ)
            if len(pairs) < cfg.env_max_turns * len(differ):
                fail("(c) an episode that parted sampled the pad id: it cannot be held")
            check_greedy_tokens(torch, "(c) the delayed schedule's parted episodes", tr.mcfg,
                                tr.params, pairs, pad, near_tie, width, tr.lora_scale)
        elif not same_mask:
            fail("(c) equal streams but the loss masks or turn ends differ")
    finally:
        _free(torch, tr)
        shutil.rmtree(_envs_dir(), ignore_errors=True)
    log(f"  phase 15 wall {time.perf_counter() - t_phase:.1f} s (card: {card})")
    return {"update": counts_a, "faults": counts_b,
            "k7_shape": (rows, Tp_ep, cfg.env_turn_tokens, cfg.rollout_page_size),
            "k1_calls": dict(seen["fwd"])}


def chaos_soak(torch, card: str, seen_v) -> dict:
    """Phase 16 (module docstring): the serving soak at JAX's sizes on the
    launcher's geometry, the K9 shapes recorded in `seen_v`. Returns the
    soak's launch counts."""
    import json as _json
    import os
    import shutil

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.chaos import INVARIANTS, compose, soak_serving
    from nanorlhf_tpu_torch.entrypoints.common import resolve_model
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    t_phase = time.perf_counter()
    mcfg, params, _ = resolve_model(build_config().sft_model_path, SOAK_SEED, device="cuda")
    run_dir = _envs_dir("soak")
    shutil.rmtree(run_dir, ignore_errors=True)
    plan = compose(3, "serving")
    log(f"  the soak: plan {plan.spec!r} (digest {plan.digest}); 24 requests at 40/s "
        f"(time scale 0.02), engine of 2 rows, pages of 4, 12-token prompts, 8 new tokens")
    try:
        with recording_verify_shapes(seen_v):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = soak_serving(run_dir, plan, device="cuda", model=(mcfg, params))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _build.launch_counts()
        log(f"  soak: {wall:.3f} s; summary {rep.summary}; fires {rep.fault_stats}; "
            f"launches {_nonzero(counts)} (card: {card})")
        for a in rep.audits:
            log(f"    [{'ok ' if a.ok else 'FAIL'}] {a.name} (checked={a.checked})"
                + (f" — {a.detail}" if a.detail else ""))
        if not rep.ok or {a.name for a in rep.audits} != set(INVARIANTS):
            fail(f"phase 16: audits failed: {[a.name for a in rep.failed]}")
        s = rep.summary
        if rep.fired_sites() != {"gw.disconnect"} or s["offered"] != 24 \
                or s["completed"] + s["errors"] + s["shed"] != s["offered"] or s["errors"] < 1:
            fail(f"phase 16: fires {rep.fault_stats}, summary {s}")
        for name in ("paged_decode_attention", "paged_decode_verify_attention"):
            if counts[name] <= 0:
                fail(f"phase 16: {name} never launched")
        out = subprocess.run([sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "inspect_run.py"), run_dir, "--chaos",
            "--json"], capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            fail(f"phase 16: tools/inspect_run.py --chaos exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        rebuilt = _json.loads(out.stdout)
        fires = sum(v["fires"] for v in rep.fault_stats.values())
        log(f"  tools/inspect_run.py --chaos on the port's ledger: ok {rebuilt['ok']}, "
            f"{len(rebuilt['fires'])} fires, {len(rebuilt['audits'])} verdicts, spec "
            f"{rebuilt['runs'][0]['spec']!r}")
        if not (rebuilt["ok"] is True and len(rebuilt["fires"]) == fires
                and rebuilt["runs"][0]["spec_digest"] == plan.digest
                and {a["name"] for a in rebuilt["audits"]} == set(INVARIANTS)):
            fail(f"phase 16: the inspector's rebuild disagrees: {rebuilt}")
    finally:
        del params
        torch.cuda.empty_cache()
        shutil.rmtree(run_dir, ignore_errors=True)
    log(f"  phase 16 wall {time.perf_counter() - t_phase:.1f} s (card: {card})")
    return counts


def hold_soak_verify(torch, seen_v) -> list:
    """K9 at every shape phase 16 gave it (the engine's suffix forwards:
    one row, pages of 4), held as phase 2 holds it (`_hold_verify`)."""
    given = sorted({(s[1], s[3], s[6], s[7]) for s in seen_v
                    if s[0] == "paged_decode_verify_attention"})
    log(f"  K9 calls by shape (name, B, H, Tq, hd, KV, P, nb) in phase 16: {dict(seen_v)}")
    gen = torch.Generator(device="cuda").manual_seed(16)
    for B, Tq, P, nb in given:
        _hold_verify(torch, f"phase 16 B={B} Tq={Tq} P={P} nb={nb}",
                     _verify_case(torch, gen, B, 12, 2, Tq, 128, nb * P,
                                  max(0, min(2, nb * P - Tq)), P=P))
    return [dict(B=B, Tq=Tq, P=P, nb=nb) for B, Tq, P, nb in given]


def env_entries(torch, F, counts15: dict, counts16: dict, soak_k9: list) -> dict:
    """K7 held and timed at phase 15's session shape and at the soak's
    engine shape; the kernels line's `envs` entries: each kernel's launches
    in phase 15's update (K1 by the call shapes it was given) and in the
    soak."""
    rows, Tp_ep, turn, P = counts15["k7_shape"]
    k7 = check_paged(torch, F, Tp_ep, turn, rows=rows, page=P)["paged_decode_attention"]
    k7_soak = check_paged(torch, F, 12, 8, rows=2, page=4)["paged_decode_attention"]
    keep = ("shape", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    out = {name: {"launches": {"update": counts15["update"][name],
                               "faults_update": counts15["faults"][name]}}
           for name in ENV_KERNELS}
    out["flash_fwd"]["calls_by_shape"] = {str(k): v for k, v in counts15["k1_calls"].items()}
    out["paged_decode_attention"].update(
        {k: k7[k] for k in keep}, soak=dict(launches=counts16["paged_decode_attention"],
                                            **{k: k7_soak[k] for k in keep}))
    out["paged_decode_verify_attention"] = {
        "launches": {"soak": counts16["paged_decode_verify_attention"]}, "shapes": soak_k9}
    return out


def envs_phases(torch, F, card: str, held: dict | None):
    """Phases 15 and 16, then the holds of the kernels at the shapes they
    gave them that no earlier phase held (`held`; None: hold them all).
    Returns phase 15's and 16's counts and the soak's K9 shapes."""
    log(PHASE15)
    seen15 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
    counts15 = multi_turn(torch, card, seen15)
    log("  the kernels at the shapes phase 15 gave them that no earlier phase held, "
        "against their plain versions")
    hold_new_shapes(torch, F, seen15, held or {k: set() for k in seen15}, 512, phase=15)
    log(PHASE16)
    seen16v: collections.Counter = collections.Counter()
    counts16 = chaos_soak(torch, card, seen16v)
    soak_k9 = hold_soak_verify(torch, seen16v)
    return counts15, counts16, soak_k9


# `--learn`: the learning harness's knobs on the card (the Qwen2-1.5B
# geometry at the toy 512 vocab; the binary phase on)
LEARN_KNOBS = {"LEARN_MODEL": "1_5b", "LEARN_UPDATES": "30", "LEARN_BINARY_UPDATES": "10"}


def learn(card: str) -> None:
    """`--learn`: `entrypoints/learning_run.main` on the card with
    LEARN_KNOBS (an environment variable already set wins): the reward
    series, the skip counts of both phases and their seconds printed."""
    import os

    from nanorlhf_tpu_torch.entrypoints import learning_run

    for k, v in LEARN_KNOBS.items():
        os.environ.setdefault(k, v)
    log(f"learn: the learning-curve harness, {learning_run.knobs()}")
    art = learning_run.main(device="cuda")
    log(json.dumps({"learning_curve": art}))
    scores = [s["score"] for s in art["series"]]
    if art.get("interrupted") or not scores or not all(math.isfinite(x) for x in scores):
        fail(f"learn: the run was cut or its scores are not finite: {art.get('interrupted')}")
    log(f"learn: shaped reward {art['reward_first3_avg']} -> {art['reward_last3_avg']} "
        f"over {art['shaped_phase']} ; binary phase {art.get('binary_phase')} (card: {card})")


# --holds: the kernel source each hold set builds
HOLDS = {"K1": "flash_fwd", "K4": "decode_attention", "K6": "decode_attention",
         "K10": "fused_logprob"}

# Faults that the phase-2 holds must catch, each planted in its own copy of
# the port (a text edit of one kernel source): (what, holds, source, text,
# planted text). Split 1 and rank 1 exist at the held shapes (K4: S = 8 at
# B=16; K6: S = 2 at K9's B=32, S = 8 and 3 at the edges; K10: 7 vocab
# splits at R=24000); the heaviest
# query tiles are the grid's first B·H blocks.
FAULTS = (
    ("K4: one split's last tile dropped", "K4", "decode_attention.cu",
     "for (int t0 = lo + warp * 32; t0 < hi; t0 += DECODE_WARPS * 32) {",
     "for (int t0 = lo + warp * 32; t0 + (split == 1 ? 32 : 0) < hi; t0 += DECODE_WARPS * 32) {"),
    ("K4: one cluster rank's partial left out of the merge", "K4", "decode_attention.cu",
     "if (r < a.S)", "if (r < a.S && r != 1)"),
    ("K1: the heaviest query tile missing its last key tile", "K1", "flash_fwd.cu",
     "const int n_steps = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;",
     "const int n_steps = (causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt)"
     " - (blockIdx.x < B * H);"),
    ("K1: the alpha rescale of O skipped on key tile 1", "K1", "flash_fwd.cu",
     "      for (int jn = 0; jn < HD / 8; ++jn) {\n        o[4 * jn] *= alpha0;",
     "      for (int jn = 0; jn < HD / 8 && j != 1; ++jn) {\n        o[4 * jn] *= alpha0;"),
    ("K10: split 1's last vocab tile left out of l, the label still gathered", "K10",
     "fused_logprob.cu", "l[h] = l[h] * alpha[h] + sum;",
     "l[h] = l[h] * alpha[h] + (split == 1 && vt == vt_end - 1 ? 0.f : sum);"),
    ("K10: the alpha rescale of l skipped on a split's second vocab tile", "K10",
     "fused_logprob.cu", "l[h] = l[h] * alpha[h] + sum;",
     "l[h] = (vt == vt_begin + 1 ? l[h] : l[h] * alpha[h]) + sum;"),
    ("K6: split 1's last key tile dropped", "K6", "decode_attention.cu",
     "const int n_tiles = (s1 - s0 + VT - 1) / VT;",
     "const int n_tiles = (s1 - s0 + VT - 1) / VT - (split == 1 && s1 > s0);"),
    ("K6: candidate 1's bound off by one (fill + qi, not fill + qi + 1)", "K6",
     "decode_attention.cu", "hi[mt][h] = r < rows ? min(fill + qi + 1, s1) : -1;",
     "hi[mt][h] = r < rows ? min(fill + qi + (qi != 1), s1) : -1;"),
)


def plant_faults() -> None:
    """Plant each of FAULTS in a copy of the port under output/faults/ (the
    checkout's own git-ignored directory; the copies are removed after) and
    run that copy's `chip_smoke.py --holds`: each must fail. Prints the hold
    lines that caught it."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, "output", "faults")
    shutil.rmtree(base, ignore_errors=True)
    missed = []
    for i, (what, holds, source, text, planted) in enumerate(FAULTS):
        tree = os.path.join(base, str(i))
        shutil.copytree(os.path.join(root, "nanorlhf_tpu_torch"),
                        os.path.join(tree, "nanorlhf_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.abspath(__file__), tree)
        path = os.path.join(tree, "nanorlhf_tpu_torch", "csrc", source)
        with open(path) as f:
            code = f.read()
        if text not in code:
            fail(f"fault {what!r}: its text is not in {source}")
        with open(path, "w") as f:
            f.write(code.replace(text, planted))
        run = subprocess.run([sys.executable, "chip_smoke.py", "--holds", holds], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        caught = run.returncode != 0 and "FAILED" in run.stderr
        log(f"  planted fault {what} ({source}): {'caught' if caught else 'NOT CAUGHT'}")
        for line in run.stdout.splitlines():
            if "max|kernel" in line or "per 64-row tile" in line:
                log(f"    {line.strip()}")
        log(f"    {(run.stderr.strip().splitlines() or [''])[-1]}")
        if not caught:
            missed.append(what)
    shutil.rmtree(base, ignore_errors=True)
    if missed:
        fail(f"planted faults passed their holds: {missed}")
    log(f"every planted fault failed its hold ({len(FAULTS)})")


def _demo_config():
    """The launcher's model geometry (Qwen2.5-1.5B), as `resolve_model`
    builds it."""
    from nanorlhf_tpu_torch.core.config import ModelConfig

    return ModelConfig.qwen2_1_5b()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-tokens", type=int, default=1500,
                    help="response length of the end-to-end rollout")
    ap.add_argument("--holds", choices=sorted(HOLDS),
                    help="build one kernel source and run only its phase-2 holds "
                         "(what --plant-faults runs in each copy)")
    ap.add_argument("--plant-faults", action="store_true",
                    help="plant each of FAULTS in its own copy of the port under "
                         "output/faults/ and check that its hold fails")
    ap.add_argument("--graph-loops", action="store_true",
                    help="build, then run only phase 8 (each decode loop's graph "
                         "replay against its per-step body) and the decode-step "
                         "profile, eager against graph replay")
    ap.add_argument("--io", action="store_true",
                    help="build, then run only phase 10 (HF weights written and loaded, "
                         "async checkpoint saves, a failed write, resume, export, the RM) "
                         "and the holds of the kernels at the shapes it gives them")
    ap.add_argument("--r1", action="store_true",
                    help="build, then run only phase 11 (sparse GRPO through the R1-Zero "
                         "launcher at 8,000-token responses) and the holds of the kernels "
                         "at the shapes it gives them")
    ap.add_argument("--routes", action="store_true",
                    help="build, then run only phase 12 (remat_policy='dots', the naive "
                         "update branch and int8 rollout weights) and the holds of the "
                         "kernels at the shapes it gives them")
    ap.add_argument("--host", action="store_true",
                    help="build, then run only phase 13 (the host planes on the GRPO "
                         "main path) and the holds of the kernels at the shapes it "
                         "gives them")
    ap.add_argument("--serve", action="store_true",
                    help="build, then run only phase 14 (the radix prefix cache, chunked "
                         "prefill, the engine behind its gateway driven over HTTP, one GRPO "
                         "update through the prefix cache) and the holds of the kernels at "
                         "the shapes it gives them")
    ap.add_argument("--envs", action="store_true",
                    help="build, then run only phases 15 (multi-turn GRPO over the python-tool "
                         "environment) and 16 (the chaos harness's serving soak) and the holds "
                         "of the kernels at the shapes they give them")
    ap.add_argument("--learn", action="store_true",
                    help="build, then run only the learning-curve harness "
                         "(entrypoints/learning_run: sparse GRPO, shaped then binary reward) "
                         "at LEARN_MODEL=1_5b; not part of the default run")
    ap.add_argument("--sigterm-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--algos", action="store_true",
                    help="build, then run only phase 2's holds of the shapes phase 9 "
                         "gives the kernels, and phase 9 (one update of each of RLOO, "
                         "ReMax, REINFORCE, RAFT and PPO)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    # the port lives beside this script; with nothing else of the repo
    # present the import fails here, before any result is printed
    from nanorlhf_tpu_torch import _build  # noqa: F401

    if args.sigterm_child:
        # phase 13 (i)'s child: the kernels are built, this only loads them
        sigterm_child(args.sigterm_child, min(args.max_tokens, 512))
        return
    with closing_trainers():
        run(args, torch, F)


@contextlib.contextmanager
def closing_trainers():
    """Close every trainer built inside (each holds a SIGTERM guard, maybe a
    status port and a checkpoint writer), also when a phase fails; a
    trainer's close() is idempotent. The trainers are held weakly: a phase
    that drops its trainer frees its device memory."""
    import weakref

    from nanorlhf_tpu_torch.trainer import trainer as trainer_mod

    built, real_init = weakref.WeakSet(), trainer_mod.RLTrainer.__init__

    def init(self, *a, **k):
        built.add(self)
        real_init(self, *a, **k)

    trainer_mod.RLTrainer.__init__ = init
    try:
        yield
    finally:
        trainer_mod.RLTrainer.__init__ = real_init
        for tr in list(built):
            try:
                tr.close()
            except Exception as e:
                print(f"closing a trainer: {type(e).__name__}: {e}", file=sys.stderr)


def run(args, torch, F) -> None:
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
    from nanorlhf_tpu_torch.trainer.bucketing import depad_queries, shape_menu

    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    if args.plant_faults:
        plant_faults()
        log(f"card: {card}")
        return
    log("phase 1: build")
    if args.holds:
        _build.KERNELS[HOLDS[args.holds]].load()
    else:
        secs = _build.build_all()
        log(f"  built {len(_build.KERNELS)} kernels from "
            f"{len({k.source for k in _build.KERNELS.values()})} sources in {secs:.2f} s")
        for k in {k.source_name: k for k in _build.KERNELS.values()}.values():
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  [{k.source_name}] {line.strip()}")

    # the prompt width the rollout path uses: the first synthetic batch,
    # de-padded to the shape menu
    tok = ToyTokenizer(4096)
    ds = load_prompt_dataset("synthetic:512", tok)
    first = depad_queries(next(ds.loader(4, 1)), tok.pad_token_id,
                          shape_menu(ds.input_ids.shape[1], 16))
    prompt_width = first.shape[1]
    resp = args.max_tokens
    phase8_prompts = depad_queries(next(ds.loader(16, 4)), tok.pad_token_id,
                                   shape_menu(ds.input_ids.shape[1], 16))
    phase5_queries = depad_queries(next(ds.loader(16, 2)), tok.pad_token_id,
                                   shape_menu(ds.input_ids.shape[1], 16))
    if args.graph_loops:
        log("phase 8: the compiled decode loop, graph replay against the per-step body")
        graph_loops(torch, phase8_prompts, tok.pad_token_id)
        from nanorlhf_tpu_torch.core import model as tm

        from nanorlhf_tpu_torch.entrypoints.grpo import build_config

        mcfg, cfg = _demo_config(), build_config()
        decode_profile(torch, mcfg, tm.init_params(mcfg, seed=8, device="cuda"), 1.0,
                       dict(temperature=cfg.temperature, top_p=cfg.top_p, greedy=False,
                            top_k=cfg.rollout_top_k, approx_top_k=cfg.rollout_approx_top_k),
                       16, prompt_width + min(resp, 512))
        log(f"graph loops: every hold passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.io:
        log("phase 10: checkpoints and data in and out, Qwen2.5-1.5B width, full depth")
        checkpoints_in_and_out(torch, F, min(resp, 512),
                               {"fwd": set(), "bwd": set(), "fused": set(), "decode": set()})
        log(f"io: every check passed; total wall {time.perf_counter() - t_all:.1f} s; "
            f"card: {card}")
        return
    if args.r1:
        log("phase 11: sparse GRPO and the R1-Zero launcher, 8,000-token responses, "
            "Qwen2-1.5B width, full depth")
        r1_seen = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
        counts11 = r1_zero(torch, r1_seen)
        log("  the kernels at the shapes phase 11 gave them, against their plain versions")
        r1 = hold_r1_shapes(torch, F, r1_seen)
        log(json.dumps({"r1_kernels": r1_entries(r1, counts11)}))
        log(f"r1: every hold and check passed; total wall {time.perf_counter() - t_all:.1f} "
            f"s; card: {card}")
        return
    if args.host:
        short = min(resp, 512)
        log("phase 13: the host planes on the GRPO main path, Qwen2.5-1.5B width")
        seen13 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
        seen13v: collections.Counter = collections.Counter()
        counts13 = host_planes(torch, short, phase8_prompts, phase5_queries,
                               tok.pad_token_id, card, seen13, seen13v)
        log("  the kernels at the shapes phase 13 gave them, against their plain versions")
        hold_new_shapes(torch, F, seen13, {k: set() for k in seen13}, short, phase=13)
        hold_host_verify(torch, seen13v, set(), prompt_width)
        check_paged(torch, F, prompt_width, short)
        log(json.dumps({"host_kernels": counts13}))
        log(f"host: every hold and check passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.serve:
        log(PHASE14)
        seen14v: collections.Counter = collections.Counter()
        seen14 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
        counts14 = serving(torch, card, seen14v, seen14)
        log("  the kernels at the shapes phase 14 gave them, against their plain versions")
        hold_new_shapes(torch, F, seen14, {k: set() for k in seen14}, 512, phase=14)
        log(json.dumps({"serve_kernels": serve_entries(torch, F, seen14v, counts14, set())}))
        log(f"serve: every hold and check passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.envs:
        counts15, counts16, soak_k9 = envs_phases(torch, F, card, held=None)
        log(json.dumps({"env_kernels": env_entries(torch, F, counts15, counts16, soak_k9)}))
        log(f"envs: every hold and check passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.learn:
        learn(card)
        log(f"learn: total wall {time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.routes:
        log("phase 12: the update's and the rollout's other routes (remat_policy='dots', "
            "the naive update branch, int8 rollout weights), Qwen2.5-1.5B width")
        seen12 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
        counts12 = other_routes(torch, min(resp, 512), seen12, card, cold=True)
        log("  the kernels at the shapes phase 12 gave them, against their plain versions")
        hold_new_shapes(torch, F, seen12, {k: set() for k in seen12}, min(resp, 512))
        log(json.dumps({"routes_kernels": routes_entries(counts12)}))
        log(f"routes: every hold and check passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    log("phase 2: kernels against their plain versions (bf16)")
    # phases 3, 4, 5, 6 and 7b run shorter responses than the launcher's 1500
    # so the whole script stays within half its time limit: phase 7a, this
    # slice's main path, keeps the full length
    short = min(resp, 512)
    # the verify shapes phase 7 gives K6 (7a: the one-card update's 16
    # prompts x 4 samples, cache of prompt + response + spec_k slots) and K9
    # (7b: 32 resident rows, pages of 128); phase 7 records the shapes it
    # gave and fails unless they are these
    spec_k, P7 = 4, 128
    k6_shape = (64, 12, spec_k + 1, 128, 2, prompt_width + resp + spec_k)
    k9_shape = (32, 12, spec_k + 1, 128, 2, P7, -(-(prompt_width + short) // P7))
    # the flash backward shapes of the updates: phase 4 (B=4 microbatch
    # rows, prompt + short responses) and phase 7a (prompt + full
    # responses); phases 4 and 7a record what they gave and fail unless
    # they are these
    bwd_shapes = {(4, 12, 2, prompt_width + t, 128) for t in (short, resp)}
    # the flash forward at the scoring shape of the full response (the
    # kernels line) and at the shapes phase 4 gives it: the prefill of its 16
    # prompts at the prompt width, the scoring batch and the update's
    # microbatch at prompt + short responses; phase 4 records what it gave
    # and fails unless they are these
    fwd_long = (16, 12, 2, prompt_width + resp, 128)
    fwd_shapes = {(16, 12, 2, prompt_width, 128), (16, 12, 2, prompt_width + short, 128),
                  (4, 12, 2, prompt_width + short, 128)}
    # the K10 shapes (R, D, V, with_entropy, transposed) of phase 4 (short
    # responses) and phase 7a (full ones): the scoring pass of the 16 kept
    # rows, and the update's microbatch of 4 rows with entropy, over the
    # tied weight; phases 4 and 7a record what they gave and fail unless
    # they are these
    fused4, fused7 = ({(rows * t, 1536, 151936, rows == 4, True) for rows in (16, 4)}
                      for t in (short, resp))
    fused_shapes = fused4 | fused7
    # phase 9's shapes (its value init reads the dataset's own prompt width);
    # it records what it gave and fails unless they are these
    fwd9, bwd9, fused9, decode9 = phase9_shapes(prompt_width, ds.input_ids.shape[1], short)
    # the decode rows of phase 3 (4 prompts x 4 samples) and phase 4 (16 x 4)
    # at the full and the short response length, the full length first
    decode_shapes = sorted({(B, prompt_width + t) for B in (16, 64) for t in (resp, short)}
                           | decode9, key=lambda s: (-s[1], s[0]))
    if args.algos:
        check_flash(torch, F, sorted(fwd9))
        check_flash_bwd(torch, F, bwd9)
        check_fused(torch, F, short, fused9, timed=False)
        check_decode(torch, F, prompt_width, sorted(decode9, key=lambda s: (-s[1], s[0])))
        log("phase 9: the other five algorithms (RLOO, ReMax, REINFORCE, RAFT, PPO), "
            "Qwen2.5-1.5B width")
        other_algorithms(torch, short, prompt_width, fwd9, bwd9, fused9, card)
        log(f"algos: every hold and check passed; total wall "
            f"{time.perf_counter() - t_all:.1f} s; card: {card}")
        return
    if args.holds == "K1":
        check_flash(torch, F, [fwd_long, *sorted(fwd_shapes - {fwd_long})])
    if args.holds == "K4":
        check_decode(torch, F, prompt_width, decode_shapes)
    if args.holds == "K6":
        check_verify(torch, F, prompt_width, k6_shape, k9_shape, timed=False)
        check_verify_edges(torch, prompt_width)
    if args.holds == "K10":
        check_fused(torch, F, resp, fused_shapes, timed=False)
    if args.holds:
        log(f"{args.holds}: every hold passed")
        return
    bwd = check_flash_bwd(torch, F, bwd_shapes | bwd9)
    flash = check_flash(torch, F, [fwd_long, *sorted((fwd_shapes | fwd9) - {fwd_long})])
    decode = check_decode(torch, F, prompt_width, decode_shapes)
    results = {
        "flash_fwd": flash[fwd_long],
        "decode_attention": decode[(16, prompt_width + resp)],
        "fused_logprob": check_fused(torch, F, resp, fused_shapes | fused9),
        # the kernels line gives K2/K3 at phase 4's shape, whose launches it counts
        **bwd[prompt_width + short],
        **check_paged(torch, F, prompt_width, resp),
        **check_verify(torch, F, prompt_width, k6_shape, k9_shape),
    }
    checked = {("decode_verify_attention",) + k6_shape,
               ("paged_decode_verify_attention",) + k9_shape}
    check_verify_edges(torch, prompt_width)
    check_edges(torch)
    k4_64 = decode[(64, prompt_width + resp)]["device_ms"]
    k6_dev = results["decode_verify_attention"]["device_ms"]
    if k4_64 is not None and k6_dev is not None:
        log(f"  K6 device time at B=64 Tq={spec_k + 1} T_max={k6_shape[-1]} against K4's at "
            f"B=64 T_max={prompt_width + resp} in this run: {k6_dev:.4f} / {k4_64:.4f} ms "
            f"= {k6_dev / k4_64:.3f}")
    for name, r in results.items():
        on_card = f", device {fmt_ms(r['device_ms'])}" if "device_ms" in r else ""
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms{on_card}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    log("phase 3: GRPO rollout-and-score, Qwen2.5-1.5B width")
    end_to_end(torch, short)

    log("phase 4: one GRPO update (rollout, score, loss, backward, AdamW, "
        "checkpoint), Qwen2.5-1.5B width, contiguous KV cache")
    bwd_seen: collections.Counter = collections.Counter()
    fwd_seen: collections.Counter = collections.Counter()
    fused_seen: collections.Counter = collections.Counter()
    counts4 = train_update(torch, short, bwd_seen, fwd_seen, fused_seen)
    fused_device_per_update(torch, fused_seen, counts4["fused_logprob"])
    if set(fused_seen) != fused4:
        fail(f"phase 4 gave fused_logprob {set(fused_seen)}; phase 2 held it at {fused4}")
    log(f"  flash forward shapes phase 4 gave the kernel (B, H, KV, T, hd): calls "
        f"{dict(fwd_seen)}")
    if set(fwd_seen) != fwd_shapes:
        fail(f"phase 4 gave the flash forward {set(fwd_seen)}; phase 2 held and timed it "
             f"at {fwd_shapes}")
    if sum(fwd_seen.values()) != counts4["flash_fwd"]:
        fail(f"phase 4 launched flash_fwd {counts4['flash_fwd']} times, "
             f"{sum(fwd_seen.values())} through recorded calls")

    log("phase 5: one GRPO update over continuous batching (paged KV cache, "
        "page size 128, 32 resident rows), Qwen2.5-1.5B width")
    counts5 = paged_update(torch, short)
    staggered_queue(torch, _demo_config(), phase5_queries, tok.pad_token_id)

    log("phase 6: GRPO rollout-and-score with the int8 KV cache (contiguous, "
        "then paged + queued), Qwen2.5-1.5B width")
    counts6 = int8_rollouts(torch, short)

    log("phase 7: speculative decode (n-gram drafts, k-token verify), "
        "Qwen2.5-1.5B width")
    seen: collections.Counter = collections.Counter()
    fused7_seen: collections.Counter = collections.Counter()
    with recording_verify_shapes(seen):
        counts7 = spec_update(torch, resp, bwd_seen, fused7_seen)
        counts7b = spec_queued_rollout(torch, short)
    log(f"  fused_logprob shapes phase 7a gave the kernel (R, D, V, with_entropy, "
        f"transposed): calls {dict(fused7_seen)}")
    if set(fused7_seen) != fused7:
        fail(f"phase 7a gave fused_logprob {set(fused7_seen)}; phase 2 held and timed it "
             f"at {fused7}")
    if sum(fused7_seen.values()) != counts7["fused_logprob"]:
        fail(f"phase 7a launched fused_logprob {counts7['fused_logprob']} times, "
             f"{sum(fused7_seen.values())} through recorded calls")
    log(f"  verify shapes phase 7a/7b gave the kernels (name, B, H, Tq, hd, KV, "
        f"T | P, nb): calls {dict(seen)}")
    if set(seen) != checked:
        fail(f"phase 7 gave the verify kernels {set(seen)}; phase 2 held and timed "
             f"them at {checked}")
    log(f"  flash backward shapes phases 4 and 7a gave the kernels (name, B, H, KV, "
        f"T, hd, causal): calls {dict(bwd_seen)}")
    bwd_checked = {(name, B, H, KV, T, hd, True) for name in ("flash_bwd_dq", "flash_bwd_dkv")
                   for B, H, KV, T, hd in bwd_shapes}
    if set(bwd_seen) != bwd_checked:
        fail(f"phases 4 and 7a gave the flash backward {set(bwd_seen)}; phase 2 held "
             f"and timed it at {bwd_checked}")
    # every launch of the backward kernels in phases 4 and 7a went through a
    # recorded call at that phase's shape
    bwd_want: collections.Counter = collections.Counter()
    for counts, t in ((counts4, short), (counts7, resp)):
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            bwd_want[(name, 4, 12, 2, prompt_width + t, 128, True)] += counts[name]
    if bwd_seen != bwd_want:
        fail(f"flash backward calls by shape {dict(bwd_seen)}, launches by phase "
             f"{dict(bwd_want)}")
    spec_cycle(torch, _demo_config(),
               depad_queries(next(ds.loader(16, 3)), tok.pad_token_id,
                             shape_menu(ds.input_ids.shape[1], 16)),
               tok.pad_token_id)
    spec_int8_rollout(torch)

    log("phase 8: the compiled decode loop, graph replay against the per-step body")
    graph_loops(torch, phase8_prompts, tok.pad_token_id)

    log("phase 9: the other five algorithms (RLOO, ReMax, REINFORCE, RAFT, PPO), "
        "Qwen2.5-1.5B width")
    other_algorithms(torch, short, prompt_width, fwd9, bwd9, fused9, card)

    log("phase 10: checkpoints and data in and out, Qwen2.5-1.5B width, full depth")
    checkpoints_in_and_out(torch, F, short, {
        "fwd": {fwd_long} | fwd_shapes | fwd9, "bwd": bwd_shapes | bwd9,
        "fused": fused_shapes | fused9, "decode": set(decode_shapes)})

    log("phase 11: sparse GRPO and the R1-Zero launcher, 8,000-token responses, "
        "Qwen2-1.5B width, full depth")
    r1_seen = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
    log(f"CUT: phase 11 trains 1 update of the model's first {R1_CUT_LAYERS} layers here "
        f"and runs no accuracy eval (`--r1` trains the launcher's 2 at 28 layers with an "
        f"eval before and after each), so that the whole script stays inside its time "
        f"limit with phases 13 and 14; widths, lengths and the kernels' shapes are the "
        f"launcher's")
    counts11 = r1_zero(torch, r1_seen, updates=1, evals=False, layers=R1_CUT_LAYERS)
    log("  the kernels at the shapes phase 11 gave them, against their plain versions")
    r1 = r1_entries(hold_r1_shapes(torch, F, r1_seen), counts11)

    log("phase 12: the update's and the rollout's other routes (remat_policy='dots', "
        "the naive update branch, int8 rollout weights), Qwen2.5-1.5B width")
    seen12 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
    counts12 = other_routes(torch, short, seen12, card)
    log("  the kernels at the shapes phase 12 gave them that no earlier phase held, "
        "against their plain versions")
    hold_new_shapes(torch, F, seen12, {
        "fwd": {fwd_long} | fwd_shapes | fwd9 | set(r1_seen["fwd"]),
        "bwd": bwd_shapes | bwd9 | {s[1:6] for s in r1_seen["bwd"]},
        "fused": fused_shapes | fused9 | set(r1_seen["fused"]),
        "decode": set(decode_shapes) | set(r1_seen["decode"])}, short)
    routes = routes_entries(counts12)

    log("phase 13: the host planes on the GRPO main path, Qwen2.5-1.5B width")
    seen13 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
    seen13v: collections.Counter = collections.Counter()
    log("CUT: phase 13 reads the planes' overhead in one turn a side here (off/on; "
        "`--host` takes two), so that the whole script stays inside its time limit with "
        "phase 14")
    host = host_planes(torch, short, phase8_prompts, phase5_queries, tok.pad_token_id,
                       card, seen13, seen13v, turns=("off", "on"))
    log("  the kernels at the shapes phase 13 gave them that no earlier phase held, "
        "against their plain versions")
    hold_new_shapes(torch, F, seen13, {
        "fwd": {fwd_long} | fwd_shapes | fwd9 | set(r1_seen["fwd"]) | set(seen12["fwd"]),
        "bwd": (bwd_shapes | bwd9 | {s[1:6] for s in r1_seen["bwd"]}
                | {s[1:6] for s in seen12["bwd"]}),
        "fused": fused_shapes | fused9 | set(r1_seen["fused"]) | set(seen12["fused"]),
        "decode": set(decode_shapes) | set(r1_seen["decode"]) | set(seen12["decode"])},
        short, phase=13)
    hold_host_verify(torch, seen13v, {("decode_verify_attention",) + k6_shape}, prompt_width)

    log(PHASE14)
    seen14v: collections.Counter = collections.Counter()
    seen14 = {k: collections.Counter() for k in ("fwd", "bwd", "fused", "decode")}
    counts14 = serving(torch, card, seen14v, seen14)
    log("  the kernels at the shapes phase 14 gave them that no earlier phase held, "
        "against their plain versions")
    hold_new_shapes(torch, F, seen14, {
        "fwd": ({fwd_long} | fwd_shapes | fwd9 | set(r1_seen["fwd"]) | set(seen12["fwd"])
                | set(seen13["fwd"])),
        "bwd": (bwd_shapes | bwd9 | {s[1:6] for s in r1_seen["bwd"]}
                | {s[1:6] for s in seen12["bwd"]} | {s[1:6] for s in seen13["bwd"]}),
        "fused": (fused_shapes | fused9 | set(r1_seen["fused"]) | set(seen12["fused"])
                  | set(seen13["fused"])),
        "decode": (set(decode_shapes) | set(r1_seen["decode"]) | set(seen12["decode"])
                   | set(seen13["decode"]))}, 512, phase=14)
    serve = serve_entries(torch, F, seen14v, counts14,
                          {("paged_decode_verify_attention",) + k9_shape})

    counts15, counts16, soak_k9 = envs_phases(torch, F, card, held={
        "fwd": ({fwd_long} | fwd_shapes | fwd9 | set(r1_seen["fwd"]) | set(seen12["fwd"])
                | set(seen13["fwd"]) | set(seen14["fwd"])),
        "bwd": (bwd_shapes | bwd9 | {s[1:6] for s in r1_seen["bwd"]}
                | {s[1:6] for s in seen12["bwd"]} | {s[1:6] for s in seen13["bwd"]}
                | {s[1:6] for s in seen14["bwd"]}),
        "fused": (fused_shapes | fused9 | set(r1_seen["fused"]) | set(seen12["fused"])
                  | set(seen13["fused"]) | set(seen14["fused"])),
        "decode": (set(decode_shapes) | set(r1_seen["decode"]) | set(seen12["decode"])
                   | set(seen13["decode"]) | set(seen14["decode"]))})
    envs = env_entries(torch, F, counts15, counts16, soak_k9)

    # each kernel's launches from the run of the path that runs it, counts
    # reset just before that run: the contiguous update (phase 4), the
    # paged update (phase 5), the int8 rollouts (phase 6), the speculative
    # update and the queued speculative rollout (phase 7)
    launches = dict(counts4)
    launches["paged_decode_attention"] = counts5["paged_decode_attention"]
    launches["decode_attention_q8"] = counts6["contiguous"]["decode_attention_q8"]
    launches["paged_decode_attention_q8"] = counts6["paged+queued"]["paged_decode_attention_q8"]
    launches["decode_verify_attention"] = counts7["decode_verify_attention"]
    launches["paged_decode_verify_attention"] = counts7b["paged_decode_verify_attention"]
    kernels = []
    for name, k in _build.KERNELS.items():
        r = results[name]
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": k.repo_source,
            "replaces": k.replaces.split()[0], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"r1": r1[name]} if name in r1 else {}),
            **({"routes": routes[name]} if name in routes else {}),
            **({"host": host[name]} if name in host else {}),
            **({"serve": serve[name]} if name in serve else {}),
            **({"envs": envs[name]} if name in envs else {}),
        })
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
