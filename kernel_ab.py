#!/usr/bin/env python3
"""Time two checkouts of the PyTorch port's kernels on one card, in turns,
so that a redesigned kernel is compared with its parent on the same card in
the same call.

    python3 kernel_ab.py PARENT_TREE CHANGED_TREE   # turns A B B A
    python3 kernel_ab.py PARENT_TREE CHANGED_TREE --only K10,K6
    python3 kernel_ab.py --ablate [K4|K10|K6]       # where a launch's time goes

Each turn runs `kernel_ab.py --measure TREE` in a subprocess with TREE
first on `sys.path` (ahead of this script's own directory), so it imports
TREE's `nanorlhf_tpu_torch` and builds that tree's kernels into its own
`_build/`; the JSON line names the package file it imported. Each turn
prints one JSON line: per shape, the flash forward
(K1) and the decode kernels (K4; K5, K7, K8 at B=32) as CUDA-event time
over back-to-back wrapper calls (`ms`) and profiler device time
(`device_ms`), and a few decode steps of the Qwen2.5-1.5B-width demo model
at 16 and 64 rows with the cache half full: wall and device-busy ms per
step and K4's device ms per step; the fused hidden→logprob kernel (K10) at
the scoring shape (R = 24000 rows, D = 1536, V = 151936, tied weight) and
the update's entropy microbatch (R = 6000), and phase 4's (R = 8192, and
R = 2048 with entropy); the verify kernels at phase 7's
shapes (K6: B=64, Tq=5, T_max=1514; K9: B=32, pages of 128, nb=5). `--only`
names the groups to run (K1, K4 — the decode family and the decode steps —,
K10, K6 — K6 and K9). Inputs come from fixed seeds, so every turn sees the
same data.

`--ablate GROUP` builds copies of this tree's kernel source with one part
taken out or one design choice changed (ABLATIONS: for K4 the V loads, the
K loads, both, the rank-0 merge, the tiles altogether, the split; for K10
the raster order, the ring depth, the softmax epilogue; for K6 the ring
depth, the split rule, the second P·V product) and prints the kernel's
device time for each at the main path's shapes (K6 also at 32, 16 and 4
rows, and K9 at phase 7b's shape, so that each split count is read). Where a part is taken out
the outputs are wrong by design; only the times are read. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time


GROUPS = ("K1", "K4", "K10", "K6")


def _profile(torch, fn, iters: int, match) -> float:
    """Device ms per call of `fn`'s kernels whose name holds `match` (a
    string, or a tuple of strings any of which may match)."""
    from torch.profiler import ProfilerActivity, profile

    match = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(m in e.key for m in match)) / iters / 1e3


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


def measure(tree: str, groups=GROUPS) -> dict:
    sys.path.insert(0, tree)
    import torch

    import nanorlhf_tpu_torch
    from nanorlhf_tpu_torch import _build
    from nanorlhf_tpu_torch.core import model as tm
    from nanorlhf_tpu_torch.core.config import ModelConfig
    from nanorlhf_tpu_torch.ops import attention as A
    from nanorlhf_tpu_torch.ops import decode_attention as D
    from nanorlhf_tpu_torch.ops import fused_logprob as FL

    _build.build_all()
    out: dict = {"kind": torch.cuda.get_device_name(0), "package": nanorlhf_tpu_torch.__file__}

    def randn(gen, *shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if "K10" in groups:
        # the scoring pass and the update's entropy microbatch at phase 7a's
        # 1500-token responses and phase 4's 512 (K10 and its merge pass;
        # the parent's merge kernel is `merge_kernel`)
        gen = torch.Generator(device="cuda").manual_seed(3)
        R, D_, V = 24000, 1536, 151936
        h = randn(gen, R, D_)
        w = (torch.randn((V, D_), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        labels = torch.randint(0, V, (R,), generator=gen, device="cuda")
        for rows, ent in ((R, False), (6000, True), (8192, False), (2048, True)):
            def fused(rows=rows, ent=ent):
                FL.fused_logprob_kernel(h[:rows], w, labels[:rows], 0.9, with_entropy=ent,
                                        transposed=True)

            out[f"fused_logprob R={rows} with_entropy={ent}"] = dict(
                ms=_events(torch, fused, 3),
                device_ms=_profile(torch, fused, 3, ("fused_partial_kernel", "merge_kernel")))
        del h, w
    if "K6" in groups:
        # phase 7's verify shapes: 7a's K6 over the contiguous cache, 7b's K9
        # over pages of 128 scattered through a pool (prompt width 10)
        for B, T, P in ((64, 1514, None), (32, 640, 128)):
            gen = torch.Generator(device="cuda").manual_seed(8)
            q = randn(gen, B, 12, 5, 128)
            caches = [(randn(gen, B, 2, T, 128), randn(gen, B, 2, T, 128)) for _ in range(4)]
            start = torch.randint(0, 10, (B,), generator=gen, device="cuda").int()
            fill = torch.randint(10, T - 5 + 1, (B,), generator=gen, device="cuda").int()
            it = iter(range(10**9))
            if P is None:
                def verify():
                    kk, vv = caches[next(it) % 4]
                    D.decode_verify_attention(q, kk, vv, start, fill)

                name = f"decode_verify_attention B={B} T_max={T}"
            else:
                nb = T // P
                N = B * nb + 7
                table = torch.randperm(N, generator=gen, device="cuda")[:B * nb] \
                    .reshape(B, nb).int()

                def pool(x):
                    p = torch.zeros((N, 2, P, 128), dtype=x.dtype, device="cuda")
                    p[table.long()] = x.reshape(B, 2, nb, P, 128).transpose(1, 2)
                    return p

                pools = [(pool(k), pool(v)) for k, v in caches]

                def verify():
                    kk, vv = pools[next(it) % 4]
                    D.paged_decode_verify_attention(q, kk, vv, table, start, fill)

                name = f"paged_decode_verify_attention B={B} P={P} nb={nb}"
            out[name] = dict(ms=_events(torch, verify, 40),
                             device_ms=_profile(torch, verify, 20, "verify_"))

    # K1 at the scoring shape of 1500-token responses and phase 4's shapes
    for B, T in ((16, 1510), (16, 522), (4, 522), (16, 10)) if "K1" in groups else ():
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
    for B, T in ((16, 1510), (16, 522), (64, 522), (32, 1510)) if "K4" in groups else ():
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
    params = tm.init_params(mcfg, seed=1, device="cuda") if "K4" in groups else None
    for rows in (16, 64) if "K4" in groups else ():
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


# per group: the source, and its variants as (name, [(text, what replaces
# it), ...]). K4's take a part of the decode body out (their outputs are
# wrong by design); K10's and K6's change a design choice (the raster
# order, the ring depth, the split rule) or take one part out (K10's
# softmax epilogue, K6's second P·V product)
ABLATIONS = {
    "K4": ("decode_attention", [
        ("no V loads", [("vv[j] = j <= last ? *reinterpret_cast<const VVec*>(vrow + j * HD) : VVec{};",
                         "vv[j] = VVec{};")]),
        ("no K loads", [("kv[c] = reinterpret_cast<const KVec*>(kc + si * HD)[c];", "kv[c] = KVec{};")]),
        ("no merge", [("  if (split == 0) {\n    constexpr int ROWS",
                       "  if (split == 0 && a.S < 0) {\n    constexpr int ROWS")]),
        ("no tiles", [("for (int t0 = lo + warp * 32; t0 < hi;",
                       "for (int t0 = lo + warp * 32; t0 < hi && a.S < 0;")]),
        ("no split (S = 1)", [("a.S = split_count(B, a.KV, sms);", "a.S = 1;")]),
    ]),
    "K10": ("fused_logprob", [
        ("row tiles fastest over the whole grid",
         [("constexpr int GROUP_ROWS = 32;", "constexpr int GROUP_ROWS = 1 << 16;")]),
        ("groups of 8 row tiles", [("constexpr int GROUP_ROWS = 32;", "constexpr int GROUP_ROWS = 8;")]),
        ("a 3-stage ring", [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]),
        ("no softmax epilogue", [
            ("      // the label's logit, only in the thread whose columns hold it;\n",
             "      if (n_k < 0) {\n      // the label's logit, only in the thread whose columns hold it;\n"),
            ("        if (ENTROPY) u[h] = u[h] * alpha[h] + (pz[2 * h] + pz[2 * h + 1]);\n      }\n",
             "        if (ENTROPY) u[h] = u[h] * alpha[h] + (pz[2 * h] + pz[2 * h + 1]);\n      }\n      }\n"),
        ]),
    ]),
    "K6": ("decode_attention", [
        ("2-stage rings", [("constexpr int VSTAGES = 3;", "constexpr int VSTAGES = 2;")]),
        ("S for two blocks an SM", [("std::min(VMAX_SPLITS, VSPLIT_BLOCKS_PER_SM * sms / (B * KV))",
                                     "std::min(VMAX_SPLITS, 2 * sms / (B * KV))")]),
        ("S for four blocks an SM", [("std::min(VMAX_SPLITS, VSPLIT_BLOCKS_PER_SM * sms / (B * KV))",
                                      "std::min(VMAX_SPLITS, 4 * sms / (B * KV))")]),
        ("no split (S = 1)", [("a.S = verify_split_count(B, a.KV, sms);", "a.S = 1;")]),
        ("P in one bf16 part", [
            ("        mma16816(o[mt][2 * np], ps[mt], vf[0], vf[1]);\n", ""),
            ("        mma16816(o[mt][2 * np + 1], ps[mt], vf[2], vf[3]);\n", "")]),
    ]),
}


def _variants(group: str) -> dict:
    """Build this tree's source of `group` as built and with each of its
    ABLATIONS edits, one nvcc each, all at once; {name: CDLL}."""
    import ctypes

    from nanorlhf_tpu_torch import _build

    source, edits = ABLATIONS[group]
    src = _build.SRC_DIR / f"{source}.cu"
    code = src.read_text()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    for header in _build.source_closure(src)[1:]:  # the copies' includes resolve beside them
        shutil.copy(header, out_dir)
    procs = []
    for i, (name, pairs) in enumerate([("as built", [])] + edits):
        text = code
        for a, b in pairs:
            if a not in text:
                sys.exit(f"ablation {name!r}: its text is not in {src.name}")
            text = text.replace(a, b)
        cu, so = (os.path.join(out_dir, f"{group}_{i}.{ext}") for ext in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"ablation {name!r} did not build:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def ablate(group: str) -> None:
    import ctypes

    import torch

    from nanorlhf_tpu_torch._build import cuda_stream, ptr
    from nanorlhf_tpu_torch.ops import decode_attention as D
    from nanorlhf_tpu_torch.ops import fused_logprob as FL

    libs = _variants(group)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def timed(fns, match):
        return {name: _profile(torch, fn, 20 if group != "K10" else 3, match)
                for name, fn in fns.items()}

    def checked(err):
        if err:
            sys.exit(f"launch failed: CUDA error {err}")

    if group == "K4":
        for B, T in ((16, 1510), (16, 522), (64, 522)):
            q = torch.randn((B, 12, 128), generator=gen, device="cuda").to(torch.bfloat16)
            caches = [tuple(torch.randn((B, 2, T, 128), generator=gen, device="cuda")
                            .to(torch.bfloat16) for _ in range(2)) for _ in range(4)]
            start = torch.zeros(B, dtype=torch.int32, device="cuda")
            filled = torch.full((B,), T, dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)
            fns = {}
            for name, lib in libs.items():
                fn = lib.decode_attention_bf16
                fn.argtypes, fn.restype = D._DECODE_ARGS, ctypes.c_int
                it = iter(range(10**9))

                def call(fn=fn, it=it):
                    kk, vv = caches[next(it) % 4]
                    checked(fn(ptr(q), ptr(kk), ptr(vv), ptr(start), ptr(filled), ptr(out),
                               B, 12, 2, T, 128, cuda_stream(q.device)))

                fns[name] = call
            print(json.dumps({"decode_attention": f"B={B} T_max={T}, full windows",
                              "device_ms": timed(fns, "decode_kernel")}), flush=True)
    elif group == "K10":
        R, Dm, V = 24000, 1536, 151936
        h = torch.randn((R, Dm), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((V, Dm), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        labels = torch.randint(0, V, (R,), generator=gen, device="cuda").int()
        lp = torch.empty(R, dtype=torch.float32, device="cuda")
        splits = FL.fused_logprob_split_count_on_card(R, V)  # the C entry's own
        part = torch.empty((splits, R, 4), dtype=torch.float32, device="cuda")
        fns = {}
        for name, lib in libs.items():
            fn = lib.fused_logprob_bf16
            fn.argtypes, fn.restype = FL._FUSED_ARGS, ctypes.c_int
            fns[name] = lambda fn=fn: checked(fn(
                ptr(h), ptr(w), ptr(labels), ptr(part), ptr(lp), None, R, Dm, V, 1,
                1 / 0.9, cuda_stream(h.device)))
        print(json.dumps({"fused_logprob": f"R={R} D={Dm} V={V} tied, {splits} splits",
                          "device_ms": timed(fns, "fused_")}), flush=True)
    else:
        # phase 7a's K6 (B=64) and fewer rows over the same cache length, so
        # each split count the rule gives is read; then phase 7b's K9 (B=32,
        # pages of 128, nb=5) through its own entry
        H, KV, Tq = 12, 2, 5
        for B, T, P in ((64, 1514, None), (32, 1514, None), (16, 1514, None),
                        (4, 1514, None), (32, 640, 128)):
            q = torch.randn((B, H, Tq, 128), generator=gen, device="cuda").to(torch.bfloat16)
            caches = [tuple(torch.randn((B, KV, T, 128), generator=gen, device="cuda")
                            .to(torch.bfloat16) for _ in range(2)) for _ in range(4)]
            start = torch.randint(0, 10, (B,), generator=gen, device="cuda").int()
            fill = torch.randint(10, T - Tq + 1, (B,), generator=gen, device="cuda").int()
            out = torch.empty_like(q)
            if P is not None:
                nb = T // P
                N = B * nb + 7
                table = torch.randperm(N, generator=gen, device="cuda")[:B * nb] \
                    .reshape(B, nb).int()

                def pool(x):
                    p = torch.zeros((N, KV, P, 128), dtype=x.dtype, device="cuda")
                    p[table.long()] = x.reshape(B, KV, nb, P, 128).transpose(1, 2)
                    return p

                caches = [(pool(k), pool(v)) for k, v in caches]
            fns = {}
            for name, lib in libs.items():
                if P is None:
                    fn = lib.decode_verify_attention_bf16
                    fn.argtypes, fn.restype = D._VERIFY_ARGS, ctypes.c_int
                else:
                    fn = lib.paged_decode_verify_attention_bf16
                    fn.argtypes, fn.restype = D._PAGED_VERIFY_ARGS, ctypes.c_int
                it = iter(range(10**9))

                def call(fn=fn, it=it):
                    kk, vv = caches[next(it) % 4]
                    if P is None:
                        checked(fn(ptr(q), ptr(kk), ptr(vv), ptr(start), ptr(fill), ptr(out),
                                   B, H, KV, T, Tq, 128, cuda_stream(q.device)))
                    else:
                        checked(fn(ptr(q), ptr(kk), ptr(vv), ptr(table), ptr(start),
                                   ptr(fill), ptr(out), B, H, KV, N, P, nb, Tq, 128,
                                   cuda_stream(q.device)))

                fns[name] = call
            what = (f"decode_verify_attention B={B} Tq={Tq} T_max={T}" if P is None else
                    f"paged_decode_verify_attention B={B} Tq={Tq} P={P} nb={T // P}")
            print(json.dumps({what: f"S as built {D.verify_split_count_on_card(B, KV)}",
                              "device_ms": timed(fns, "verify_kernel")}), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--ablate"]:
        group = sys.argv[2] if len(sys.argv) > 2 else "K4"
        if group not in ABLATIONS:
            sys.exit(__doc__)
        ablate(group)
        return
    if sys.argv[1:2] == ["--measure"]:
        print("AB " + json.dumps(measure(sys.argv[2], sys.argv[3].split(","))), flush=True)
        return
    args = sys.argv[1:]
    groups = list(GROUPS)
    if len(args) == 4 and args[2] == "--only":
        groups = args[3].split(",")
        args = args[:2]
    if len(args) != 2 or not set(groups) <= set(GROUPS):
        sys.exit(__doc__)
    trees = [os.path.abspath(t) for t in args]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for turn, tree in enumerate([trees[0], trees[1], trees[1], trees[0]]):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree,
                              ",".join(groups)],
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
