#!/usr/bin/env python3
"""Time two checkouts of the PyTorch port's attention kernels on one card,
in turns, so that a redesigned kernel is compared with its parent on the
same card in the same call.

    python3 kernel_ab.py PARENT_TREE CHANGED_TREE   # turns A B B A
    python3 kernel_ab.py --ablate                   # where a K4 launch's time goes

Each turn runs `kernel_ab.py --measure TREE` in a subprocess with TREE
first on `sys.path` (ahead of this script's own directory), so it imports
TREE's `nanorlhf_tpu_torch` and builds that tree's kernels into its own
`_build/`; the JSON line names the package file it imported. Each turn
prints one JSON line: per shape, the flash forward
(K1) and the decode kernels (K4; K5, K7, K8 at B=32) as CUDA-event time
over back-to-back wrapper calls (`ms`) and profiler device time
(`device_ms`), and a few decode steps of the Qwen2.5-1.5B-width demo model
at 16 and 64 rows with the cache half full: wall and device-busy ms per
step and K4's device ms per step. Inputs come from fixed seeds, so every
turn sees the same data.

`--ablate` builds copies of this tree's `csrc/decode_attention.cu` with one
part of the decode body taken out (ABLATIONS: the V loads, the K loads,
both, the rank-0 merge, the tiles altogether, the split) and prints K4's
device time for each at 16 and 64 rows with full windows. The outputs of
the copies are wrong by design; only their times are read. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _profile(torch, fn, iters: int, match: str) -> float:
    """Device ms per call of `fn`'s kernels whose name holds `match`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if match in e.key) / iters / 1e3


def _events(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import nanorlhf_tpu_torch
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.config import ModelConfig
    from nanorlhf_tpu_torch.ops import attention as A
    from nanorlhf_tpu_torch.ops import decode_attention as D

    _build.build_all()
    out: dict = {"kind": torch.cuda.get_device_name(0), "package": nanorlhf_tpu_torch.__file__}

    def randn(gen, *shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # K1 at the scoring shape of 1500-token responses and phase 4's shapes
    for B, T in ((16, 1510), (16, 522), (4, 522), (16, 10)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = randn(gen, B, 12, T, 128), randn(gen, B, 2, T, 128), randn(gen, B, 2, T, 128)
        valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
        valid[1:, :5] = False

        def fwd():
            A.flash_attention_forward(q, k, v, valid)

        out[f"flash_fwd B={B} T={T}"] = dict(ms=_events(torch, fwd, 20),
                                             device_ms=_profile(torch, fwd, 10, "flash_fwd"))
    # the decode kernels: 4 distinct caches (> L2, as 28 layers are), windows
    # of random length from a left pad
    for B, T in ((16, 1510), (16, 522), (64, 522), (32, 1510)):
        gen = torch.Generator(device="cuda").manual_seed(2)
        q = randn(gen, B, 12, 128)
        caches = [(randn(gen, B, 2, T, 128), randn(gen, B, 2, T, 128)) for _ in range(4)]
        start = torch.randint(0, 9, (B,), generator=gen, device="cuda").int()
        filled = torch.maximum(torch.randint(1, T + 1, (B,), generator=gen, device="cuda").int(),
                               start + 1)
        it = iter(range(10**9))

        def dec():
            kk, vv = caches[next(it) % 4]
            D.decode_attention(q, kk, vv, start, filled)

        out[f"decode_attention B={B} T={T}"] = dict(
            ms=_events(torch, dec, 40), device_ms=_profile(torch, dec, 20, "decode_kernel"))
        if B != 32:
            continue
        # K5, K7, K8 at PR 4's shape: pages of 128 scattered through a pool
        P, nb = 128, -(-T // 128)
        N = B * nb + 7
        table = torch.randperm(N, generator=gen, device="cuda")[:B * nb].reshape(B, nb).int()
        k, v = caches[0]
        pad = torch.zeros((B, 2, nb * P - T, 128), dtype=torch.bfloat16, device="cuda")
        kl, vl = torch.cat([k, pad], 2), torch.cat([v, pad], 2)
        (kq, ks), (vq, vs) = tm.quantize_kv(kl), tm.quantize_kv(vl)

        def pool(x):
            p = torch.zeros((N, 2, P) + tuple(x.shape[3:]), dtype=x.dtype, device="cuda")
            p[table.long()] = x.reshape(B, 2, nb, P, *x.shape[3:]).transpose(1, 2)
            return p

        kp, vp = pool(kl), pool(vl)
        q8_pools = [pool(x) for x in (kq, ks, vq, vs)]
        for name, fn in (
                ("paged_decode_attention", lambda: D.paged_decode_attention(
                    q, kp, vp, table, start, filled)),
                ("decode_attention_q8", lambda: D.decode_attention_q8(
                    q, kq, ks, vq, vs, start, filled)),
                ("paged_decode_attention_q8", lambda: D.paged_decode_attention_q8(
                    q, *q8_pools, table, start, filled))):
            out[f"{name} B={B} T={T}"] = dict(
                ms=_events(torch, fn, 40), device_ms=_profile(torch, fn, 20, "decode_kernel"))
    # decode steps of the demo model, cache half full
    mcfg = ModelConfig.qwen2_1_5b()
    params = tm.init_params(mcfg, seed=1, device="cuda")
    for rows in (16, 64):
        T, fill, steps = 522, 261, 3
        caches = tm.init_kv_cache(mcfg, rows, T, device="cuda")
        key_mask = torch.zeros((rows, T), dtype=torch.bool, device="cuda")
        key_mask[:, :fill] = True
        tok = torch.full((rows,), 5, dtype=torch.long, device="cuda")
        pos = torch.full((rows,), fill, dtype=torch.long, device="cuda")
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad():
            for _ in range(2):
                tm.decode_step(params, mcfg, tok, pos, fill, key_mask, caches)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for s in range(steps):
                    key_mask[:, fill + s] = True
                    tm.decode_step(params, mcfg, tok, pos + s, fill + s, key_mask, caches)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / steps
        cuda = torch.autograd.DeviceType.CUDA
        kern = [e for e in prof.key_averages() if e.device_type == cuda]
        k4 = [e for e in kern if "decode_kernel" in e.key]
        out[f"decode_step rows={rows} cache={fill}/{T}"] = dict(
            wall_ms=wall, busy_ms=sum(e.self_device_time_total for e in kern) / steps / 1e3,
            k4_device_ms=sum(e.self_device_time_total for e in k4) / steps / 1e3,
            k4_launches=sum(e.count for e in k4) // steps)
        del caches
    return out


# (name, text of csrc/decode_attention.cu, what replaces it)
ABLATIONS = (
    ("no V loads", "vv[j] = j <= last ? *reinterpret_cast<const VVec*>(vrow + j * HD) : VVec{};",
     "vv[j] = VVec{};"),
    ("no K loads", "kv[c] = reinterpret_cast<const KVec*>(kc + si * HD)[c];", "kv[c] = KVec{};"),
    ("no merge", "  if (split == 0) {\n    constexpr int ROWS", "  if (split == 0 && a.S < 0) {\n    constexpr int ROWS"),
    ("no tiles", "for (int t0 = lo + warp * 32; t0 < hi;", "for (int t0 = lo + warp * 32; t0 < hi && a.S < 0;"),
    ("no split (S = 1)", "a.S = split_count(B, a.KV, sms);", "a.S = 1;"),
)


def ablate() -> None:
    import ctypes

    import torch

    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch._build import cuda_stream, ptr
    from nanorlhf_tpu_torch.ops import decode_attention as D

    src = _build.KERNELS["decode_attention"].source
    code = src.read_text()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    variants = [("as built", [])] + [(name, [(a, b)]) for name, a, b in ABLATIONS]
    procs = []
    for i, (name, edits) in enumerate(variants):
        text = code
        for a, b in edits:
            if a not in text:
                sys.exit(f"ablation {name!r}: its text is not in {src.name}")
            text = text.replace(a, b)
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"ablation {name!r} did not build:\n{log}")
        fn = ctypes.CDLL(so).decode_attention_bf16
        fn.argtypes, fn.restype = D._DECODE_ARGS, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, T in ((16, 1510), (16, 522), (64, 522)):
        q = torch.randn((B, 12, 128), generator=gen, device="cuda").to(torch.bfloat16)
        caches = [tuple(torch.randn((B, 2, T, 128), generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(2)) for _ in range(4)]
        start = torch.zeros(B, dtype=torch.int32, device="cuda")
        filled = torch.full((B,), T, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        times = {}
        for name, fn in fns.items():
            it = iter(range(10**9))

            def call():
                kk, vv = caches[next(it) % 4]
                if fn(ptr(q), ptr(kk), ptr(vv), ptr(start), ptr(filled), ptr(out), B, 12, 2, T,
                      128, cuda_stream(q.device)):
                    sys.exit("launch failed")

            times[name] = _profile(torch, call, 20, "decode_kernel")
        print(json.dumps({"decode_attention": f"B={B} T_max={T}, full windows",
                          "device_ms": times}), flush=True)


def main() -> None:
    if sys.argv[1:] == ["--ablate"]:
        ablate()
        return
    if sys.argv[1:2] == ["--measure"]:
        print("AB " + json.dumps(measure(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for turn, tree in enumerate([trees[0], trees[1], trees[1], trees[0]]):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        line = [x for x in run.stdout.splitlines() if x.startswith("AB ")]
        if run.returncode or not line:
            sys.exit(f"turn {turn} ({tree}) failed:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        result = json.loads(line[0][3:])
        if not result["package"].startswith(tree + os.sep):
            sys.exit(f"turn {turn} imported {result['package']}, not {tree}'s package")
        print(json.dumps({"turn": turn, "tree": tree, **result}), flush=True)


if __name__ == "__main__":
    main()
