#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nanorlhf_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py                 # the whole contract
    python3 chip_smoke.py --max-tokens 64 # a shorter end-to-end rollout

Phases (any failure exits non-zero):
  1. build — compile the Hopper kernels from nanorlhf_tpu_torch/csrc (one
     nvcc per source, all at once) and load them;
  2. kernel checks — each kernel against its plain PyTorch version on the
     card, in bf16 (int8 for the int8 cache), at the shapes the rollout and
     the update give it, with the stated tolerance; the paged kernels (K7,
     K8, K9) on pages scattered through a pool with spare pages and a
     sentinel block, each equal bit for bit to its contiguous twin (K4, K5,
     K6) on the same logical cache; the verify kernels (K6, K9) at the
     shapes phase 7 gives them (Tq = 5 candidates; K6 at B = 64 rows, K9 at
     32), held per element within one bf16 ulp of the f32 result, with
     candidate blocks straddling tiles and pages, K6 at Tq = 1 against K4,
     and off those shapes (64 rows per block, one, head_dim 64, the key
     range in one split and in three); the flash backward (K2, K3) at the
     shapes phases 4 and 7a give it (B=4, T = prompt + 512 and prompt +
     1500), held at 1e-2 · max|g| and per 64-row tile relative to the
     tile's norm, two launches equal bit for bit, and off those shapes (head_dim
     64, G 4 and 7, non-causal, ragged T, T under one tile, B=1 at the
     largest dK/dV split, key tiles cut into several parts, held against
     the split's plain version too); then the kernel's time, its plain
     version's time,
     one library call's time as a yardstick (for the paged and int8 cache,
     where no single call exists: SDPA over a pre-gathered / pre-dequantized
     view, "not one call"), and the bound (the least time the card could
     take: bytes / 3.35 TB/s or flops / 989 TFLOP/s);
  3. rollout and score — the rollout-and-score half of one GRPO update
     through the launcher's own config (`entrypoints/grpo.build_config`) at
     the full Qwen2.5-1.5B width (random weights from the seed), 4 synthetic
     prompts × 4 samples (1 kept per prompt and scored), with the kernels'
     launch counters read around it, then the results checked: finite
     logprobs of the expected shape, policy == ref at the zero-init LoRA,
     and — on a small input (2 layers at full width, teacher-forced
     prefill/decode, then scoring) — the kernel route no less accurate than
     the plain route against the plain route in f32. Last, a profile of a
     few decode steps (device busy vs wall);
  4. one GRPO update — `entrypoints/common.build_trainer` +
     `RLTrainer.train(num_updates=1)` on the launcher's config with the
     one-card cut (`entrypoints/grpo.one_card_cut`: 16 prompts × 4 samples,
     2 optimizer steps of 2 microbatches of 4 rows), with the launch counts
     of the update half checked, then: finite loss and grad norm > 0, LoRA B
     moved, frozen base and ref unchanged, the first minibatch's approxkl
     (new vs old logprobs from the same kernels) small, the checkpoint
     written and reloading to the same tensors; and, on a small input, the
     LoRA gradients through the kernels no less accurate than the plain
     bf16 route against the plain route in f32. Phases 3 and 4 run
     responses of at most 512 tokens (a cut, printed), so that the whole
     script stays within half its time limit;
  5. one GRPO update over continuous batching — the same, with
     rollout_page_size=128 and rollout_decode_rows=32 (32 of the 64 rows
     resident, the rest admitted mid-loop into recycled pages), at most
     512 tokens (a cut, printed): K7 launched once per layer and executed
     decode step, K4 never, one flash forward per layer for the bootstrap
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
     The verify shapes (a) and (b) gave the kernels, and the flash
     backward shapes of phase 4's and (a)'s updates, are recorded and must
     be those phase 2 held and timed.

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


def log(msg: str) -> None:
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


def device_ms(torch, fn, iters: int, match: str) -> dict[str, float]:
    """Device time per call of `fn`'s kernels whose name holds `match`, by
    kernel (torch.profiler over `iters` calls after a warm-up): the card's
    own time, without the host's launch and wrapper overhead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.device_type == cuda and match in e.key}


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


def check_flash(torch, F, prompt_width: int, resp: int) -> dict:
    from nanorlhf_tpu_torch.ops.attention import (
        flash_attention_forward, flash_attention_reference)

    # out: the kernel rounds P to bf16 for P·V and writes bf16 (≤ ~1 bf16 ulp
    # of |out| < 4); lse stays f32 throughout
    tol_out, tol_lse = 2e-2, 1e-3
    H, KV, hd = 12, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    result = {}
    for label, B, T in (("prefill", 4, prompt_width), ("scoring", 16, prompt_width + resp)):
        q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
        # left padding as the rollout has it, one row unpadded
        pad = torch.randint(0, max(1, prompt_width // 2), (B,), generator=gen,
                            device="cuda")
        pad[0] = 0
        valid = torch.arange(T, device="cuda")[None, :] >= pad[:, None]
        out, lse = flash_attention_forward(q, k, v, valid, causal=True)
        ref_out, ref_lse = flash_attention_reference(*_f32(q, k, v), valid, causal=True)
        b_out, b_lse = flash_attention_reference(q, k, v, valid, causal=True)
        rows = valid[:, None, :].expand(B, H, T)  # padding query rows are free
        what = f"flash_fwd {label} B={B} T={T}"
        worst = max(worst,
                    hold(torch, what, [("out", out, ref_out, b_out, rows)], tol_out),
                    hold(torch, what, [("lse", lse, ref_lse, b_lse, rows)], tol_lse))
        if label == "scoring":
            ms = time_ms(torch, lambda: flash_attention_forward(q, k, v, valid), 10)
            plain = time_ms(torch, lambda: flash_attention_reference(q, k, v, valid), 3)
            mask = (valid[:, None, None, :]
                    & torch.ones((T, T), dtype=torch.bool, device="cuda").tril())
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 5)
            nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + valid.numel()
                      + 2 * q.numel() + 4 * lse.numel())
            flops = 4.0 * B * H * hd * T * (T + 1) / 2  # causal pairs only
            bms, by = bound_ms(nbytes, flops)
            result = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                          bound_by=by, shape=f"B={B} H={H} KV={KV} T={T} hd={hd}")
    result["max_abs_err"] = worst
    return result


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
            on_card[name] = sum(parts.values())
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
            f"device time (profiler) dq {on_card['dq']:.4f} dkv {on_card['dkv']:.4f} ms; "
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


def check_decode(torch, F, prompt_width: int, resp: int) -> dict:
    from nanorlhf_tpu_torch.ops.decode_attention import (
        decode_attention, reference_decode_attention)

    tol = 2e-2  # f32 inside; the bf16 output rounds by up to one ulp of |out| < 4
    B, H, KV, hd = 16, 12, 2, 128
    T = prompt_width + resp
    gen = torch.Generator(device="cuda").manual_seed(2)
    start = torch.randint(0, max(1, prompt_width - 1), (B,), generator=gen, device="cuda")
    filled = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    filled = torch.maximum(filled, start + 1)
    # bounds straddling and sitting on 32-key tile edges, a full row, one key
    filled[:6] = torch.tensor([T, 64, 65, 1024, 31, 33], device="cuda")
    start[:6] = torch.tensor([0, 0, 63, 5, 30, 32], device="cuda")
    filled[6] = start[6] + 1
    start, filled = start.int(), filled.int()
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    caches = [(torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16),
               torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16))
              for _ in range(4)]  # 4 distinct caches > L2, as 28 layers are
    k, v = caches[0]
    err = hold(torch, f"decode_attention B={B} T_max={T}", [(
        "out", decode_attention(q, k, v, start, filled),
        reference_decode_attention(*_f32(q, k, v), start, filled),
        reference_decode_attention(q, k, v, start, filled), None)], tol)
    it = iter(range(10**9))

    def kern():
        kk, vv = caches[next(it) % 4]
        decode_attention(q, kk, vv, start, filled)

    ms = time_ms(torch, kern, 40)
    plain = time_ms(torch, lambda: reference_decode_attention(q, k, v, start, filled), 10)
    pos = torch.arange(T, device="cuda")[None, :]
    mask = ((pos >= start[:, None]) & (pos < filled[:, None]))[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True), 20)
    n_valid = float((filled - start).sum())
    nbytes = 2 * (2 * n_valid * KV * hd) + 2 * 2 * q.numel() + 8 * B
    flops = 4.0 * n_valid * H * hd
    bms, by = bound_ms(nbytes, flops)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                max_abs_err=err, shape=f"B={B} H={H} KV={KV} T_max={T} hd={hd}")


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


def check_paged(torch, F, prompt_width: int, resp: int) -> dict:
    """K7 (paged bf16), K5 (int8) and K8 (paged int8) at the rollout's
    decode shape — 32 resident rows, H=12, KV=2, hd=128, T_max = prompt
    width + response, page size 128 — with the pages scattered through a
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

    B, H, KV, hd, P = 32, 12, 2, 128, 128
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

    ms7 = time_ms(torch, lambda: (lambda s: da.paged_decode_attention(
        q, s["kp"], s["vp"], table, start, filled))(rot()), 40)
    ms4 = time_ms(torch, lambda: (lambda s: da.decode_attention(
        q, s["k"], s["v"], start, filled))(rot()), 40)
    log(f"  K4 on the same logical caches laid out contiguously (B={B}): "
        f"{ms4:.4f} ms; K7 through the pages {ms7:.4f} ms")
    ms5 = time_ms(torch, lambda: (lambda s: da.decode_attention_q8(
        q, s["kq"], s["ks"], s["vq"], s["vs"], start, filled))(rot()), 40)
    ms8 = time_ms(torch, lambda: (lambda s: da.paged_decode_attention_q8(
        q, *s["q8_pools"], table, start, filled))(rot()), 40)
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
            ms=ms7, plain_ms=plain7, library_ms=lib7, bound_ms=b7[0], bound_by=b7[1],
            max_abs_err=e7, shape=f"{shape} P={P}, pool of {c['N']} pages"),
        "decode_attention_q8": dict(
            ms=ms5, plain_ms=plain5, library_ms=lib5, bound_ms=b5[0], bound_by=b5[1],
            max_abs_err=e5, shape=f"{shape}, int8 + bf16 scales"),
        "paged_decode_attention_q8": dict(
            ms=ms8, plain_ms=plain8, library_ms=lib5, bound_ms=b8[0], bound_by=b8[1],
            max_abs_err=e8, shape=f"{shape} P={P}, int8 pools"),
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
    S = da.verify_split_count(c["B"], c["KV"], 0)
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


def check_verify(torch, F, pad_max: int, k6_shape, k9_shape) -> dict:
    """K6 and K9 at the shapes the speculative path gives them — K6
    (B, H, Tq, hd, KV, T) over the contiguous cache, K9 (B, H, Tq, hd, KV,
    P, nb) over pages scattered through a pool with spare pages and a
    sentinel block on row 0 — each held by `_hold_verify`; then the times
    (4 distinct caches, > L2 as 28 layers are), the yardsticks (K6: SDPA
    with a boolean mask over the contiguous cache, query length Tq; K9: not
    one call — SDPA over the pre-gathered view, the gather timed beside it)
    and the bounds. Returns the two kernels-line entries."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(8)

    def mask(c):
        pos = torch.arange(c["T"], device="cuda")[None, None, :]
        qi = torch.arange(c["Tq"], device="cuda")[None, :, None]
        return ((pos >= c["start"][:, None, None])
                & (pos < c["fill"][:, None, None] + qi + 1))[:, None]

    def bound(c, table_bytes=0):
        B, H, Tq, hd, KV, T = (c[n] for n in ("B", "H", "Tq", "hd", "KV", "T"))
        start, fill = c["start"], c["fill"]
        qi = torch.arange(Tq, device="cuda")[None, :]
        hi = torch.clamp(fill[:, None] + qi + 1, max=T)
        pairs = float((hi - start[:, None]).clamp(min=0).sum())   # (row, query) x key
        keys = float((torch.clamp(fill + Tq, max=T) - start).clamp(min=0).sum())
        nbytes = 2 * (2 * keys * KV * hd) + 2 * 2 * B * H * Tq * hd + 8 * B + table_bytes
        return bound_ms(nbytes, 4.0 * pairs * H * hd)

    B, H, Tq, hd, KV, T = k6_shape
    c = _verify_case(torch, gen, B, H, KV, Tq, hd, T, pad_max, copies=4)
    shape = f"B={B} H={H} KV={KV} Tq={Tq} hd={hd} T_max={T}"
    e6, _ = _hold_verify(torch, shape, c)
    q, (k, v), start, fill = c["q"], c["caches"][0], c["start"], c["fill"]
    it = iter(range(10**9))
    ms = time_ms(torch, lambda: (lambda kv: da.decode_verify_attention(
        q, kv[0], kv[1], start, fill))(c["caches"][next(it) % 4]), 40)
    plain = time_ms(torch, lambda: da.reference_decode_verify_attention(
        q, k, v, start, fill), 10)
    m = mask(c)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True), 20)
    b = bound(c)
    k6_row = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0], bound_by=b[1],
        max_abs_err=e6, shape=f"{shape} S={da.verify_split_count(B, KV, 0)}")
    B, H, Tq, hd, KV, P, nb = k9_shape
    c = _verify_case(torch, gen, B, H, KV, Tq, hd, nb * P, pad_max, P=P, copies=4)
    shape = f"B={B} H={H} KV={KV} Tq={Tq} hd={hd}"
    _, e9 = _hold_verify(torch, shape, c)
    q, start, fill, table = c["q"], c["start"], c["fill"], c["table"]
    kp, vp = c["pools"][0]
    it = iter(range(10**9))
    ms = time_ms(torch, lambda: (lambda kv: da.paged_decode_verify_attention(
        q, kv[0], kv[1], table, start, fill))(c["pools"][next(it) % 4]), 40)
    ms6 = time_ms(torch, lambda: (lambda kv: da.decode_verify_attention(
        q, kv[0], kv[1], start, fill))(c["caches"][next(it) % 4]), 40)
    plain = time_ms(torch, lambda: da.reference_paged_decode_verify_attention(
        q, kp, vp, table, start, fill), 10)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    m = mask(c)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=m, enable_gqa=True), 20)
    gather_ms = time_ms(torch, lambda: (da._gather_pool(kp, table),
                                        da._gather_pool(vp, table)), 10)
    b = bound(c, 4 * table.numel())
    log(f"  K6 on the same logical caches laid out contiguously ({shape}): "
        f"{ms6:.4f} ms; K9 through the pages {ms:.4f} ms; yardstick (not one call): "
        f"SDPA over the pre-gathered view {lib:.4f} ms + gather {gather_ms:.4f} ms")
    return {"decode_verify_attention": k6_row, "paged_decode_verify_attention": dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0], bound_by=b[1],
        max_abs_err=e9, shape=f"{shape} P={P} nb={nb}, pool of {c['N']} pages, "
                              f"S={da.verify_split_count(B, KV, 0)}")}


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
    held too): R = G·Tq = 64 rows per block (G 8 × Tq 8) at head_dim 128
    and 64, one row per block (G 1, Tq 1), G 7 × Tq 3 at head_dim 64 with
    pages of 48, and the key-range splits S = 1 and S = 3 (B from the SM
    count; the split count is asserted)."""
    from nanorlhf_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(9)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    #         B                H   KV Tq hd  T_need P    S wanted
    cases = [(4,               16, 2, 8, 128, 300, 128, None),
             (3,               2,  2, 1, 128, 200, 16,  None),
             (5,               14, 2, 3, 64,  257, 48,  None),
             (sm + 1,          64, 8, 8, 64,  160, 48,  1),
             (8 * sm // 6,     12, 2, 5, 128, 400, 128, 3)]
    for B, H, KV, Tq, hd, T_need, P, want_S in cases:
        S = da.verify_split_count(B, KV, 0)
        if want_S is not None and S != want_S:
            fail(f"verify edge B={B} KV={KV}: split count {S}, meant to cover {want_S}")
        T = -(-T_need // P) * P
        c = _verify_case(torch, gen, B, H, KV, Tq, hd, T, min(pad_max, T // 4), P=P)
        _hold_verify(torch, f"edge B={B} H={H} KV={KV} Tq={Tq} hd={hd} T_max={T}", c)


def check_fused(torch, resp: int) -> dict:
    from nanorlhf_tpu_torch.ops.fused_logprob import (
        fused_chunk_rows, fused_logprob_chunked, fused_logprob_kernel)

    tol = 1e-3  # f32 accumulation and softmax; only the summation order differs
    R, D, V, temp = 16 * resp, 1536, 151936, 0.9
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((R, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), generator=gen, device="cuda")
    chunk = fused_chunk_rows(V, R)
    worst = 0.0
    for ent in (False, True):
        got = fused_logprob_kernel(h, w, labels, temp, with_entropy=ent, transposed=True)
        want = fused_logprob_chunked(*_f32(h, w), labels, temp, chunk, with_entropy=ent,
                                     transposed=True)
        bf16 = fused_logprob_chunked(h, w, labels, temp, chunk, with_entropy=ent,
                                     transposed=True)
        pairs = [("logprob", got[0], want[0], bf16[0], None)]
        if ent:
            pairs.append(("entropy", got[1], want[1], bf16[1], None))
        worst = max(worst, hold(torch, f"fused_logprob R={R} D={D} V={V} tied "
                                f"with_entropy={ent}", pairs, tol))
    # the [D, V] weight layout on a slice
    wt = w[:4096].t().contiguous()
    lab_s = labels[:512] % 4096
    worst = max(worst, hold(torch, "fused_logprob [D, V] layout R=512 V=4096", [(
        "logprob", fused_logprob_kernel(h[:512], wt, lab_s, temp)[0],
        fused_logprob_chunked(*_f32(h[:512], wt), lab_s, temp, 512)[0],
        fused_logprob_chunked(h[:512], wt, lab_s, temp, 512)[0], None)], tol))
    ms = time_ms(torch, lambda: fused_logprob_kernel(h, w, labels, temp, transposed=True), 3)
    plain = time_ms(torch, lambda: fused_logprob_chunked(h, w, labels, temp, chunk,
                                                         transposed=True), 1)
    # the update's variant: one microbatch of 4 rows, with entropy
    r_up = 4 * resp
    ms_ent = time_ms(torch, lambda: fused_logprob_kernel(
        h[:r_up], w, labels[:r_up], temp, with_entropy=True, transposed=True), 3)
    plain_ent = time_ms(torch, lambda: fused_logprob_chunked(
        h[:r_up], w, labels[:r_up], temp, chunk, with_entropy=True, transposed=True), 1)
    log(f"  fused_logprob with entropy [R={r_up} D={D} V={V}, the update's "
        f"microbatch]: kernel {ms_ent:.4f} ms, plain {plain_ent:.4f} ms, bound "
        f"{bound_ms(2 * r_up * D + 2 * w.numel() + 16 * r_up, 2.0 * r_up * D * V)[0]:.4f} ms")

    h_t = (h.float() / temp).to(torch.bfloat16)  # temperature folded in up front

    def library():
        z = torch.matmul(h_t, w.t())  # the [R, V] logits the kernel never writes
        return torch.gather(z, 1, labels[:, None])[:, 0] - torch.logsumexp(z, dim=-1)

    lib = time_ms(torch, library, 1)
    nbytes = 2 * h.numel() + 2 * w.numel() + 8 * R + 4 * R
    flops = 2.0 * R * D * V
    bms, by = bound_ms(nbytes, flops)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                max_abs_err=worst, shape=f"R={R} D={D} V={V} tied, no entropy")


def check_edges(torch) -> None:
    """The kernels off the main shapes: head_dim 64, GQA groups of 4 and 7
    (Llama-3.2-1B and Qwen2-0.5B geometry), ragged T / rows / vocab, the
    non-causal flash path (forward and backward), fully masked left-pad
    rows in the backward, an empty decode row (zeros, reading nothing).
    The backward also at T under one tile, at B=1 with the largest split
    S, and with key tiles cut into several parts, its dK/dV held against
    the plain version of the split (`flash_bwd_dkv_split_reference`) too."""
    from nanorlhf_tpu_torch.ops.attention import (
        DKV_MAX_SPLITS, dkv_key_tile_steps, dkv_schedule, dkv_split,
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_forward, flash_attention_reference,
        flash_bwd_dkv_split_reference, reference_attention)
    from nanorlhf_tpu_torch.ops.decode_attention import (
        decode_attention, reference_decode_attention)
    from nanorlhf_tpu_torch.ops.fused_logprob import (
        fused_logprob_chunked, fused_logprob_kernel)

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
    for H, KV, T, hd in ((32, 8, 300, 64), (14, 2, 257, 64)):
        B = 4
        q, k, v = randn(B, H, hd), randn(B, KV, T, hd), randn(B, KV, T, hd)
        start = torch.tensor([0, 3, 31, 100], device="cuda", dtype=torch.int32)
        filled = torch.tensor([T, 200, 32, 0], device="cuda", dtype=torch.int32)
        out = decode_attention(q, k, v, start, filled)
        hold(torch, f"edge decode_attention H={H} KV={KV} T={T} hd={hd}", [(
            "out", out[:3], reference_decode_attention(*_f32(q, k, v), start, filled)[:3],
            reference_decode_attention(q, k, v, start, filled)[:3], None)], 2e-2)
        if out[3].float().abs().max() != 0:
            fail("decode_attention: a row with no valid slot must return zeros")
    for transposed in (True, False):
        R, D, V = 300, 128, 1000
        h = randn(R, D)
        w = randn(V, D, scale=0.1) if transposed else randn(D, V, scale=0.1)
        labels = torch.randint(0, V, (R,), generator=gen, device="cuda")
        lp, ent = fused_logprob_kernel(h, w, labels, 0.7, with_entropy=True,
                                       transposed=transposed)
        want = fused_logprob_chunked(*_f32(h, w), labels, 0.7, 64, with_entropy=True,
                                     transposed=transposed)
        bf16 = fused_logprob_chunked(h, w, labels, 0.7, 64, with_entropy=True,
                                     transposed=transposed)
        hold(torch, f"edge fused_logprob R={R} D={D} V={V} transposed={transposed} T=0.7",
             [("logprob", lp, want[0], bf16[0], None),
              ("entropy", ent, want[1], bf16[1], None)], 1e-3)


# --------------------------------------------------------------------------
# phase 3: the rollout-and-score path
# --------------------------------------------------------------------------

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
        f"{rows}, decode steps {timings['decode_steps']}")
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
        "decode_attention": L * timings["decode_steps"],
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
    decode_profile(torch, out, cfg, decode_rows)
    return counts, timings


def decode_profile(torch, out, cfg, rows: int, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over a few decode
    steps of the rollout's model at its batch (`rows` = prompts × samples)
    with the cache half full — device busy time (sum of kernel times)
    against the wall time, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from nanorlhf_tpu_torch.core import model as tm

    mcfg, params = out["mcfg"], out["params"]
    resp = out["responses"].shape[1]
    T = out["context_length"] + resp
    fill = T // 2
    caches = tm.init_kv_cache(mcfg, rows, T, device="cuda")
    key_mask = torch.zeros((rows, T), dtype=torch.bool, device="cuda")
    key_mask[:, :fill] = True
    tok = torch.full((rows,), 5, dtype=torch.long, device="cuda")
    pos = torch.full((rows,), fill, dtype=torch.long, device="cuda")
    with torch.no_grad():
        for s in range(2):  # warm up
            tm.decode_step(params, mcfg, tok, pos, fill, key_mask, caches, out["lora_scale"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(steps):
                key_mask[:, fill + s] = True
                tm.decode_step(params, mcfg, tok, pos + s, fill + s, key_mask, caches,
                               out["lora_scale"])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"  decode-step profile ({rows} rows, cache {fill}/{T}, {steps} steps, "
        f"profiler on): wall {wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step, idle share {1 - busy_us / wall_us:.3f}, "
        f"kernel launches {sum(e.count for e in kernels) // steps}/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step  x{e.count // steps:<4d} "
            f"{e.key[:90]}")


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

def train_update(torch, max_tokens: int, bwd_seen) -> dict:
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
    with recording_backward_shapes(bwd_seen):
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
        f"checkpoint_write_s={trainer.last_save_s:.3f}")
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
    same = same and all(
        torch.equal(t, flatten(getattr(trainer.opt_state, m))[p])
        for m in ("mu", "nu") for p, t in flatten(saved["opt_state"][m]).items())
    if not same or int(saved["opt_state"]["count"]) != trainer.opt_state.count:
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
    rows finish. Checks the launch counts (K7 once per layer and executed
    decode step, K4 never, one flash forward per layer for the batched
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
    gen_expected = {"paged_decode_attention": L * iters, "decode_attention": 0,
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
        f"{t['decode_s'] / max(iters, 1) * 1e3:.3f} ms/step) "
        f"scoring_ms={t['score_s'] * 1e3:.3f} update_wall_s={t['update_s']:.3f} "
        f"({t['update_s'] / n_steps:.3f} s/step, "
        f"{metrics['perf/tokens_per_sec_update']:.2f} update tokens/s) "
        f"checkpoint_write_s={trainer.last_save_s:.3f} peak_mem_gb={peak / 1e9:.2f}")
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

    def run(ids, eos, **sp):
        stats = []
        out = generate(params, small, ids, ids != pad_id,
                       torch.Generator(device="cuda").manual_seed(0),
                       SamplingParams(greedy=True, max_tokens=M, **sp),
                       eos_token_id=eos, pad_token_id=pad_id, paged_stats_out=stats)
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
            or counts["paged_decode_attention"] != small.num_hidden_layers * st["decode_iterations"]:
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
        steps = timings["decode_steps"]
        want = {"decode_attention": 0, "paged_decode_attention": 0,
                "decode_attention_q8": 0 if page else L * steps,
                "paged_decode_attention_q8": L * steps if page else 0}
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

def spec_update(torch, max_tokens: int, bwd_seen) -> dict:
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
    with recording_backward_shapes(bwd_seen):
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
    gen_expected = {"decode_verify_attention": L * steps, "decode_attention": 0,
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
        f"{t['decode_s'] / max(steps, 1) * 1e3:.3f} ms per verify step, "
        f"{t['emitted_tokens']} tokens emitted, "
        f"{t['emitted_tokens'] / t['decode_s']:.2f} emitted tokens/s) "
        f"scoring_ms={t['score_s'] * 1e3:.3f} update_wall_s={t['update_s']:.3f} "
        f"({t['update_s'] / n_steps:.3f} s/step, "
        f"{metrics['perf/tokens_per_sec_update']:.2f} update tokens/s) "
        f"checkpoint_write_s={trainer.last_save_s:.3f} peak_mem_gb={peak / 1e9:.2f}; "
        f"loss {loss:.6e}, grad_norm {gnorm:.6e}, {len(moved_b)} LoRA B leaves moved")
    trainer.close()
    shutil.rmtree(cfg.output_dir, ignore_errors=True)
    return counts


def spec_queued_rollout(torch, max_tokens: int) -> dict:
    """(b) `run_rollout` with rollout_spec_k=4 through the continuous-batching
    scheduler (page size 128, 32 resident rows, 16 prompts x 4 samples):
    K9 launched once per layer and decode (draft + verify) iteration, K7,
    K6 and K4 never."""
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
    log(f"  queued spec rollout: {iters} iterations ({timings['decode_s']:.3f} s, "
        f"{timings['decode_s'] / max(iters, 1) * 1e3:.3f} ms per iteration, "
        f"{stats['emitted'] / timings['decode_s']:.2f} emitted tokens/s), "
        f"admitted_midloop {pages['admitted_midloop']}, page utilization "
        f"{pages['page_utilization']:.4f}; spec stats {stats}; launches {counts}")
    want = {"paged_decode_verify_attention": L * iters, "paged_decode_attention": 0,
            "decode_verify_attention": 0, "decode_attention": 0}
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

    def run(model, ids, **sp):
        stats = []
        out = generate(model[1], model[0], ids, ids != pad_id,
                       torch.Generator(device="cuda").manual_seed(0),
                       SamplingParams(greedy=True, max_tokens=M, **sp),
                       eos_token_id=eos, pad_token_id=pad_id, spec_stats_out=stats)
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
        if counts[kernel] != cfg.num_hidden_layers * steps or counts["decode_attention"]:
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
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    # the port lives beside this script; with nothing else of the repo
    # present the import fails here, before any result is printed
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
    from nanorlhf_tpu_torch.trainer.bucketing import depad_queries, shape_menu

    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    log("phase 1: build")
    secs = _build.build_all()
    log(f"  built {len(_build.KERNELS)} kernels from "
        f"{len({k.source for k in _build.KERNELS.values()})} sources in {secs:.2f} s")
    for k in {k.source_name: k for k in _build.KERNELS.values()}.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{k.source_name}] {line.strip()}")

    log("phase 2: kernels against their plain versions (bf16)")
    # the prompt width the rollout path uses: the first synthetic batch,
    # de-padded to the shape menu
    tok = ToyTokenizer(4096)
    ds = load_prompt_dataset("synthetic:512", tok)
    first = depad_queries(next(ds.loader(4, 1)), tok.pad_token_id,
                          shape_menu(ds.input_ids.shape[1], 16))
    prompt_width = first.shape[1]
    resp = args.max_tokens
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
    bwd = check_flash_bwd(torch, F, bwd_shapes)
    results = {
        "flash_fwd": check_flash(torch, F, prompt_width, resp),
        "decode_attention": check_decode(torch, F, prompt_width, resp),
        "fused_logprob": check_fused(torch, resp),
        # the kernels line gives K2/K3 at phase 4's shape, whose launches it counts
        **bwd[prompt_width + short],
        **check_paged(torch, F, prompt_width, resp),
        **check_verify(torch, F, prompt_width, k6_shape, k9_shape),
    }
    checked = {("decode_verify_attention",) + k6_shape,
               ("paged_decode_verify_attention",) + k9_shape}
    check_verify_edges(torch, prompt_width)
    check_edges(torch)
    for name, r in results.items():
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    log("phase 3: GRPO rollout-and-score, Qwen2.5-1.5B width")
    end_to_end(torch, short)

    log("phase 4: one GRPO update (rollout, score, loss, backward, AdamW, "
        "checkpoint), Qwen2.5-1.5B width, contiguous KV cache")
    bwd_seen: collections.Counter = collections.Counter()
    counts4 = train_update(torch, short, bwd_seen)

    log("phase 5: one GRPO update over continuous batching (paged KV cache, "
        "page size 128, 32 resident rows), Qwen2.5-1.5B width")
    counts5 = paged_update(torch, short)
    staggered_queue(torch, _demo_config(),
                    depad_queries(next(ds.loader(16, 2)), tok.pad_token_id,
                                  shape_menu(ds.input_ids.shape[1], 16)),
                    tok.pad_token_id)

    log("phase 6: GRPO rollout-and-score with the int8 KV cache (contiguous, "
        "then paged + queued), Qwen2.5-1.5B width")
    counts6 = int8_rollouts(torch, short)

    log("phase 7: speculative decode (n-gram drafts, k-token verify), "
        "Qwen2.5-1.5B width")
    seen: collections.Counter = collections.Counter()
    with recording_verify_shapes(seen):
        counts7 = spec_update(torch, resp, bwd_seen)
        counts7b = spec_queued_rollout(torch, short)
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
        })
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
