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
     card, in bf16, at the shapes the rollout and the update give it, with
     the stated tolerance; then the kernel's time, its plain version's time,
     one library call's time as a yardstick, and the bound (the least time
     the card could take: bytes / 3.35 TB/s or flops / 989 TFLOP/s);
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
     bf16 route against the plain route in f32.

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


def check_flash_bwd(torch, F, prompt_width: int, resp: int) -> dict:
    """K2/K3 at the update's shape (B=4 microbatch rows, T = prompt width +
    response), causal, left-padded; held against the plain backward in f32
    on the same bf16 inputs and residuals (out, lse from the forward
    kernel). Tolerance relative to each gradient's scale: 1e-2 · max|g|
    (dS and P round to bf16 for their products, the outputs to bf16). The
    plain bf16 route (autograd through `reference_attention` in bf16) is
    printed beside it."""
    from nanorlhf_tpu_torch.ops.attention import (
        flash_attention_backward_reference, flash_attention_forward,
        flash_bwd_dkv, flash_bwd_dq, reference_attention)

    H, KV, hd, B = 12, 2, 128, 4
    T = prompt_width + resp
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((B, H, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, KV, T, hd), generator=gen, device="cuda").to(torch.bfloat16)
    pad = torch.randint(0, max(1, prompt_width // 2), (B,), generator=gen, device="cuda")
    pad[0] = 0
    valid = torch.arange(T, device="cuda")[None, :] >= pad[:, None]
    out, lse = flash_attention_forward(q, k, v, valid, causal=True)
    # left-pad query rows carry no cotangent on the training path
    do = (torch.randn((B, H, T, hd), generator=gen, device="cuda")
          * valid[:, None, :, None]).to(torch.bfloat16)
    dq, delta = flash_bwd_dq(q, k, v, valid, out, lse, do)
    dk, dv = flash_bwd_dkv(q, k, v, valid, lse, delta, do)
    want = flash_attention_backward_reference(*_f32(q, k, v), valid, out.float(), lse,
                                              do.float())
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(reference_attention(*leaves, valid), leaves, do)
    worst = {}
    for label, got, w, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want, plain):
        scale = float(w.abs().max())
        worst[label] = hold(torch, f"flash_bwd {label} B={B} H={H} KV={KV} T={T} "
                            f"hd={hd} causal (scale {scale:.3e})",
                            [(label, got, w, b, None)], 1e-2 * scale)
    ms_dq = time_ms(torch, lambda: flash_bwd_dq(q, k, v, valid, out, lse, do), 10)
    ms_dkv = time_ms(torch, lambda: flash_bwd_dkv(q, k, v, valid, lse, delta, do), 10)
    plain_ms = time_ms(torch, lambda: flash_attention_backward_reference(
        q, k, v, valid, out, lse, do), 3)
    mask = valid[:, None, None, :] & torch.ones((T, T), dtype=torch.bool,
                                                device="cuda").tril()
    sq, sk, sv = (t.detach().requires_grad_() for t in (q, k, v))
    s_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True)
    lib = time_ms(torch, lambda: torch.autograd.grad(s_out, (sq, sk, sv), do,
                                                     retain_graph=True), 5)
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
    log(f"  flash backward as a whole: kernels {ms_dq + ms_dkv:.4f} ms, bound "
        f"{b_all[0]:.4f} ms ({b_all[1]}: 2.5 x causal forward flops)")
    shape = f"B={B} H={H} KV={KV} T={T} hd={hd}, causal"
    return {
        "flash_bwd_dq": dict(ms=ms_dq, plain_ms=plain_ms, library_ms=lib,
                             bound_ms=b_dq[0], bound_by=b_dq[1],
                             max_abs_err=worst["dq"], shape=shape),
        "flash_bwd_dkv": dict(ms=ms_dkv, plain_ms=plain_ms, library_ms=lib,
                              bound_ms=b_dkv[0], bound_by=b_dkv[1],
                              max_abs_err=max(worst["dk"], worst["dv"]), shape=shape),
    }


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
    rows in the backward, an empty decode row (zeros, reading nothing)."""
    from nanorlhf_tpu_torch.ops.attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_forward, flash_attention_reference, reference_attention)
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
        # backward: left-pad rows (all keys masked when causal) get dO = 0
        # as on the training path, and must come out finite
        do = randn(B, H, T, hd) * rows[..., None].to(torch.bfloat16)
        got = flash_attention_backward(q, k, v, valid, out, lse, do, causal)
        want = flash_attention_backward_reference(*_f32(q, k, v), valid, out.float(),
                                                  lse, do.float(), causal)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(reference_attention(*leaves, valid, causal), leaves, do)
        for label, g, w, b in zip(("dq", "dk", "dv"), got, want, plain):
            hold(torch, f"edge flash_bwd {label} B={B} H={H} KV={KV} T={T} hd={hd} "
                 f"causal={causal}", [(label, g, w, b, None)],
                 1e-2 * float(w.abs().max()))
        if causal:
            # a fully masked row with a NON-zero cotangent: finite, not NaN
            g_any = flash_attention_backward(q, k, v, valid, out, lse,
                                             randn(B, H, T, hd), causal)
            if not all(bool(torch.isfinite(g.float()).all()) for g in g_any):
                fail("flash backward: a fully masked row gave a non-finite gradient")
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

def train_update(torch, max_tokens: int) -> dict:
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
    for name in _build.KERNELS:
        if counts[name] <= 0:
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
    first = next(ds.loader(4, 1))
    prompt_width = depad_queries(first, tok.pad_token_id,
                                 shape_menu(ds.input_ids.shape[1], 16)).shape[1]
    resp = args.max_tokens
    results = {
        "flash_fwd": check_flash(torch, F, prompt_width, resp),
        "decode_attention": check_decode(torch, F, prompt_width, resp),
        "fused_logprob": check_fused(torch, resp),
        **check_flash_bwd(torch, F, prompt_width, resp),
    }
    check_edges(torch)
    for name, r in results.items():
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    log("phase 3: GRPO rollout-and-score, Qwen2.5-1.5B width")
    end_to_end(torch, args.max_tokens)

    log("phase 4: one GRPO update (rollout, score, loss, backward, AdamW, "
        "checkpoint), Qwen2.5-1.5B width")
    # the main path of this slice: its launch counts fill the kernels line
    counts = train_update(torch, args.max_tokens)

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
