#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nanorlhf_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py                 # the whole contract
    python3 chip_smoke.py --max-tokens 64 # a shorter end-to-end rollout

Phases (any failure exits non-zero):
  1. build — compile the three Hopper kernels from nanorlhf_tpu_torch/csrc
     (one nvcc per source, all at once) and load them;
  2. kernel checks — each kernel against its plain PyTorch version on the
     card, in bf16, at the shapes the rollout path gives it, with the stated
     tolerance; then the kernel's time, its plain version's time, one
     library call's time as a yardstick, and the bound (the least time the
     card could take: bytes / 3.35 TB/s or flops / 989 TFLOP/s);
  3. end to end — the rollout-and-score half of one GRPO update through the
     launcher's own config (`entrypoints/grpo.build_config`) at the full
     Qwen2.5-1.5B width (random weights from the seed), 4 synthetic prompts
     × 4 samples, with the kernels' launch counters read around it, then the
     results checked: finite logprobs of the expected shape, policy == ref at
     the zero-init LoRA, and — on a small input (2 layers at full width,
     teacher-forced prefill/decode, then scoring) — the kernel route no
     less accurate than the plain route against the plain route in f32.
     Last, a profile of a few decode steps (device busy vs wall).

Prints the card's name and power limit, a `kernels` JSON line, and as the
last line `{"ok": true, "device": {...}}`. Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
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
    non-causal flash path, an empty decode row (zeros, reading nothing)."""
    from nanorlhf_tpu_torch.ops.attention import (
        flash_attention_forward, flash_attention_reference)
    from nanorlhf_tpu_torch.ops.decode_attention import (
        decode_attention, reference_decode_attention)
    from nanorlhf_tpu_torch.ops.fused_logprob import (
        fused_logprob_chunked, fused_logprob_kernel)

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    for B, H, KV, T, hd, causal in ((2, 32, 8, 77, 64, True), (2, 14, 2, 130, 64, False),
                                    (1, 12, 2, 65, 128, False)):
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
    rows, resp = out["responses"].shape
    ctx = out["context_length"]
    log(f"  model: {mcfg.num_hidden_layers} layers D={mcfg.hidden_size} "
        f"F={mcfg.intermediate_size} H={mcfg.num_attention_heads} "
        f"KV={mcfg.num_key_value_heads} V={mcfg.vocab_size} "
        f"attention_impl={mcfg.attention_impl} LoRA r={cfg.lora_r} alpha={cfg.lora_alpha}")
    log(f"  prompt width {ctx}, responses {rows} x {resp}, "
        f"decode steps {timings['decode_steps']}")
    log(f"  launches: {counts}")
    log(f"  prefill_ms={timings['prefill_s'] * 1e3:.3f} "
        f"decode_tokens_per_s={rows * timings['decode_steps'] / timings['decode_s']:.2f} "
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
    decode_profile(torch, out, cfg)
    return counts, timings


def decode_profile(torch, out, cfg, steps: int = 3) -> None:
    """Where a decode step's time goes: torch.profiler over a few decode
    steps of the rollout's model at its batch (16 rows) with the cache half
    full — device busy time (sum of kernel times) against the wall time,
    and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from nanorlhf_tpu_torch.core import model as tm

    mcfg, params = out["mcfg"], out["params"]
    rows, resp = out["responses"].shape
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
    log(f"  built {len(_build.KERNELS)} kernels in {secs:.2f} s")
    for k in _build.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{k.name}] {line.strip()}")

    log("phase 2: kernels against their plain versions (bf16)")
    # the prompt width the rollout path uses: the first synthetic batch,
    # de-padded to the shape menu
    tok = ToyTokenizer(4096)
    ds = load_prompt_dataset("synthetic:512", tok)
    first = next(ds.loader(4, 1))
    prompt_width = depad_queries(first, tok.pad_token_id,
                                 shape_menu(ds.input_ids.shape[1], 16)).shape[1]
    resp = args.max_tokens
    results = {
        "flash_fwd": check_flash(torch, F, prompt_width, resp),
        "decode_attention": check_decode(torch, F, prompt_width, resp),
        "fused_logprob": check_fused(torch, resp),
    }
    check_edges(torch)
    for name, r in results.items():
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    log("phase 3: GRPO rollout-and-score, Qwen2.5-1.5B width")
    counts, _ = end_to_end(torch, args.max_tokens)

    kernels = []
    for name, k in _build.KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.repo_source,
            "replaces": k.replaces.split()[0], "launches": counts[name],
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
