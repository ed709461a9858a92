"""Causal GQA flash attention — the port of `nanorlhf_tpu/ops/attention.py`.

- `flash_attention_forward` wraps the Hopper kernel `csrc/flash_fwd.cu`
  (which replaces the Pallas `_flash_kernel`);
- `flash_attention_backward` wraps the two kernels of `csrc/flash_bwd.cu`
  (`_dq_kernel` and `_dkv_kernel`): Δ and dQ, then dK/dV summed over each
  kv head's query group. The dK/dV kernel walks a schedule that splits the
  heavy key tiles' (query head, query tile) steps into parts
  (`dkv_schedule`, `dkv_split_count`), each part writing f32 partials that
  a reduce pass sums in a fixed order;
- `flash_attention` is the differentiable entry (the JAX `custom_vjp`
  becomes `_FlashAttention`, a `torch.autograd.Function`): forward = the
  forward kernel, saving (q, k, v, key_valid, out, lse); backward = the two
  backward kernels.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version for CPU tensors: `flash_attention_reference` and
`flash_attention_backward_reference` (and, for the split, its twin
`flash_bwd_dkv_split_reference`), which `chip_smoke.py` also holds the
kernels against on the card. So on the CPU the backward of
`flash_attention` is `flash_attention_backward_reference`, the FA2 formulas
written out, not autograd through `_reference`. The TPU tiling workarounds
(128-multiple T padding, sublane-broadcast mask, lane-expanded LSE) are not
copied: any T works and LSE is [B, H, T] f32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr

NEG_INF = -1e30

_FLASH = KERNELS["flash_fwd"]
_FLASH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DQ = KERNELS["flash_bwd_dq"]
_DKV = KERNELS["flash_bwd_dkv"]
_DQ_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# + the schedule table and its block count, the reduce table and its row
# count, the f32 dK/dV partials
_DKV_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
_KERNEL_HEAD_DIMS = (64, 128)

# the dK/dV kernel's tiles: one block owns DKV_BLOCK_K key rows and streams
# the query rows in tiles of DKV_BLOCK_Q (csrc/flash_bwd.cu BK / BQ)
DKV_BLOCK_Q = 64
DKV_BLOCK_K = 64
DKV_MAX_SPLITS = 16
DKV_MIN_BLOCKS_PER_SM = 2  # blocks per SM the split aims for, at least
DKV_MAX_IMBALANCE = 1.3  # the heaviest block's steps over the mean, at most
SCHEDULE_COLS = 8        # int32 per schedule / reduce row


def reference_attention(q, k, v, key_valid, causal: bool = True):
    """Plain GQA attention (the JAX `reference_attention`). q: [B, H, T, d];
    k/v: [B, KV, T, d]; key_valid: [B, T] bool. Returns [B, H, T, d]."""
    return _reference(q, k, v, key_valid, causal)[0]


def flash_attention_reference(q, k, v, key_valid, causal: bool = True):
    """Plain version of the kernel: `(out [B, H, T, d], lse [B, H, T] f32)`."""
    return _reference(q, k, v, key_valid, causal)


def _reference(q, k, v, key_valid, causal):
    B, H, T, d = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, T, d)
    s = torch.einsum("bkgqh,bkth->bkgqt", qg, k).float()
    s = s / math.sqrt(d)
    s = torch.where(_causal_key_mask(key_valid, T, causal, q.device), s,
                    torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bkth->bkgqh", p, v)
    return out.reshape(B, H, T, d), lse.reshape(B, H, T)


def _causal_key_mask(key_valid, T: int, causal: bool, device):
    mask = key_valid.bool()[:, None, None, None, :]
    if causal:
        tril = torch.ones((T, T), dtype=torch.bool, device=device).tril()
        mask = mask & tril[None, None, None, :, :]
    return mask


def flash_attention_backward_reference(q, k, v, key_valid, out, lse, do,
                                       causal: bool = True):
    """Plain version of the backward kernels: the FA2 formulas of the JAX
    module (`nanorlhf_tpu/ops/attention.py:219-227`) step by step, in f32,
    from the forward's residuals. With P = exp(S − lse), Δ = Σ dO·O:
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − Δ), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale; dK/dV summed over each kv head's query group.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, T, d = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(B, KV, G, T, d)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, KV, G, T, d)
    of = out.float().reshape(B, KV, G, T, d)
    s = torch.einsum("bkgqh,bkth->bkgqt", qf, kf) * scale
    s = torch.where(_causal_key_mask(key_valid, T, causal, q.device), s,
                    torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.float().reshape(B, KV, G, T)[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqh->bkth", p, dof)
    dp = torch.einsum("bkgqh,bkth->bkgqt", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqt,bkth->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqh->bkth", ds, qf) * scale
    return dq.reshape(B, H, T, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dkv_key_tile_steps(T: int, causal: bool, block_q: int = DKV_BLOCK_Q,
                       block_k: int = DKV_BLOCK_K) -> list[tuple[int, int]]:
    """Per key tile x: (the first query tile that sees it, the number of
    query tiles from there to the end). Under the causal mask query tile i
    sees key tile x iff its last row reaches x's first key."""
    n_q, n_k = -(-T // block_q), -(-T // block_k)
    first = [(x * block_k) // block_q if causal else 0 for x in range(n_k)]
    return [(i0, n_q - i0) for i0 in first]


@functools.lru_cache(maxsize=64)
def dkv_schedule(B: int, KV: int, G: int, T: int, causal: bool, S: int,
                 block_q: int = DKV_BLOCK_Q, block_k: int = DKV_BLOCK_K):
    """The dK/dV kernel's work list, a pure function of the shape.

    A unit is one (b, kv head, key tile x); its steps are the (g, query
    tile) pairs it walks, g outer: step s is g = s // n_i, query tile
    i0 + s % n_i (`dkv_key_tile_steps`). The heaviest unit is cut into S
    parts of at most ceil(w_max / S) steps, and every unit into as many
    parts of that cap as it needs, as even as the steps allow. Returns
    `(blocks, reduce, n_slots)`:
      blocks: one row per kernel block, heaviest first —
        (b, kv head, x, first step, end step, partial slot or -1, 0, 0);
        slot -1: the unit is one part and its block writes bf16 dK/dV;
      reduce: one row per unit cut into parts —
        (b, kv head, x, first slot, parts, 0, 0, 0); its parts hold
        slots first..first+parts-1 in step order, summed in that order;
      n_slots: the f32 partial tiles the parts write."""
    steps = dkv_key_tile_steps(T, causal, block_q, block_k)
    w_max = G * max(n for _, n in steps)
    cap = -(-w_max // max(1, min(S, w_max)))
    blocks, reduce, slot = [], [], 0
    for b in range(B):
        for kvh in range(KV):
            for x, (_, n_i) in enumerate(steps):
                w = G * n_i
                parts = -(-w // cap)
                edges = [w * p // parts for p in range(parts + 1)]
                for p in range(parts):
                    blocks.append((b, kvh, x, edges[p], edges[p + 1],
                                   slot + p if parts > 1 else -1, 0, 0))
                if parts > 1:
                    reduce.append((b, kvh, x, slot, parts, 0, 0, 0))
                    slot += parts
    # heaviest first (a stable sort: equal blocks keep unit order)
    blocks.sort(key=lambda r: r[3] - r[4])
    return tuple(blocks), tuple(reduce), slot


def dkv_balance(blocks) -> tuple[int, float, int]:
    """(blocks, mean steps, max steps) of a schedule."""
    work = [r[4] - r[3] for r in blocks]
    return len(work), sum(work) / len(work), max(work)


@functools.lru_cache(maxsize=64)
def dkv_split_count(B: int, KV: int, G: int, T: int, causal: bool, sms: int,
                    block_q: int = DKV_BLOCK_Q, block_k: int = DKV_BLOCK_K) -> int:
    """S for `dkv_schedule`: the fewest parts of the heaviest key tile that
    give at least DKV_MIN_BLOCKS_PER_SM blocks per SM with no block above
    DKV_MAX_IMBALANCE × the mean steps; the most parts the shape allows
    (up to DKV_MAX_SPLITS) where none does."""
    w_max = G * max(n for _, n in dkv_key_tile_steps(T, causal, block_q, block_k))
    top = min(DKV_MAX_SPLITS, w_max)
    for S in range(1, top + 1):
        n, mean, most = dkv_balance(dkv_schedule(B, KV, G, T, causal, S,
                                                 block_q, block_k)[0])
        if n >= DKV_MIN_BLOCKS_PER_SM * sms and most <= DKV_MAX_IMBALANCE * mean:
            return S
    return top


def flash_bwd_dkv_split_reference(q, k, v, key_valid, lse, delta, do,
                                  causal: bool = True, S: int = 1,
                                  block_q: int = DKV_BLOCK_Q,
                                  block_k: int = DKV_BLOCK_K):
    """Plain version of the dK/dV kernel's split: walks `dkv_schedule`'s
    blocks, each over its (g, query tile) steps, into f32 partial dK/dV,
    then sums each key tile's parts in slot order and scales dK, as the
    kernel's reduce pass does. `delta` = Σ dO·O [B, H, T]. Returns
    (dk, dv) in the dtypes of k, v."""
    B, H, T, d = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lsef, deltaf = lse.float(), delta.float()
    valid = key_valid.bool()
    pos = torch.arange(T, device=q.device)
    steps = dkv_key_tile_steps(T, causal, block_q, block_k)
    blocks, _, _ = dkv_schedule(B, KV, G, T, causal, S, block_q, block_k)
    parts: dict[tuple[int, int, int], list] = {}
    for b, kvh, x, first, end, _slot, _, _ in blocks:
        i0, n_i = steps[x]
        ks = slice(x * block_k, min(T, (x + 1) * block_k))
        acc_k = torch.zeros((ks.stop - ks.start, d), device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for s in range(first, end):
            g, i = divmod(s, n_i)
            h, i = kvh * G + g, i0 + i
            qs = slice(i * block_q, min(T, (i + 1) * block_q))
            sc = qf[b, h, qs] @ kf[b, kvh, ks].T * scale
            ok = valid[b, ks][None, :]
            if causal:
                ok = ok & (pos[ks][None, :] <= pos[qs][:, None])
            sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
            p = torch.exp(sc - lsef[b, h, qs, None])
            dp = dof[b, h, qs] @ vf[b, kvh, ks].T
            ds = p * (dp - deltaf[b, h, qs, None])
            acc_v += p.T @ dof[b, h, qs]
            acc_k += ds.T @ qf[b, h, qs]
        parts.setdefault((b, kvh, x), []).append((first, acc_k, acc_v))
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    for (b, kvh, x), got in parts.items():
        got.sort(key=lambda r: r[0])
        sum_k, sum_v = got[0][1], got[0][2]
        for _, pk, pv in got[1:]:
            sum_k, sum_v = sum_k + pk, sum_v + pv
        ks = slice(x * block_k, min(T, (x + 1) * block_k))
        dk[b, kvh, ks] = sum_k * scale
        dv[b, kvh, ks] = sum_v
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_inputs(q, k, v, key_valid):
    B, H, T, d = q.shape
    if k.shape != (B, k.shape[1], T, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[1]}")
    if tuple(key_valid.shape) != (B, T):
        raise ValueError(f"key_valid shape {tuple(key_valid.shape)} != {(B, T)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, got {name}.dtype={t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs contiguous, 16-byte aligned {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim {d} not in {_KERNEL_HEAD_DIMS}")


def _check_contiguous_bf16(q, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, got {name}.dtype={t.dtype}")
        if t.shape != q.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs a contiguous, 16-byte aligned "
                             f"{name} shaped like q {tuple(q.shape)}")


def flash_attention_forward(q, k, v, key_valid, causal: bool = True):
    """Flash-attention forward: `(out [B, H, T, d], lse [B, H, T] f32)`.

    CUDA tensors go through the Hopper kernel (bf16, head_dim 64 or 128);
    CPU tensors through `flash_attention_reference`. Padding query rows
    (all keys masked) come back finite and unconstrained, as in JAX."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, key_valid, causal)
    _check_cuda_inputs(q, k, v, key_valid)
    B, H, T, d = q.shape
    valid = _key_flags(key_valid, q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _FLASH.launch(
        "flash_fwd_bf16", _FLASH_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(out), ptr(lse),
        B, H, k.shape[1], T, d, int(bool(causal)), cuda_stream(q.device),
    )
    return out, lse


def _check_backward_inputs(q, k, v, key_valid, lse, do, **bf16):
    """The backward kernels read q/k/v/dO through 3-D TMA maps [B·heads, T,
    d], lse (and delta) through 1-D ones and `out` in 16-byte loads: each
    base 16-byte aligned (the row strides, d·2 and T·d·2 bytes, are
    multiples of 16 at d = 64 and 128)."""
    if not q.is_cuda:
        raise ValueError("the flash backward kernels run on CUDA tensors only")
    _check_cuda_inputs(q, k, v, key_valid)
    _check_contiguous_bf16(q, do=do, **bf16)
    B, H, T, _ = q.shape
    if any(t.device != q.device for t in (lse, do, *bf16.values())):
        raise ValueError(f"every flash backward input must be on {q.device}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) \
            or not lse.is_contiguous() or lse.data_ptr() % 16:
        raise ValueError(f"lse must be contiguous, 16-byte aligned [B, H, T] f32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")


def _key_flags(key_valid, q):
    """key_valid as the kernels' uint8 flags: a bool mask is viewed, not
    copied (both are one byte of 0 or 1)."""
    valid = key_valid.to(device=q.device)
    return (valid.view(torch.uint8) if valid.dtype == torch.bool
            else valid.to(torch.uint8)).contiguous()


def flash_bwd_dq(q, k, v, key_valid, out, lse, do, causal: bool = True):
    """The dq kernel (CUDA tensors only): `(dq [B, H, T, d], delta
    [B, H, T] f32)`; the entry first launches a pass that writes
    delta = Σ dO·O, which the dq blocks and `flash_bwd_dkv` read."""
    _check_backward_inputs(q, k, v, key_valid, lse, do, out=out)
    B, H, T, d = q.shape
    valid = _key_flags(key_valid, q)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _DQ.launch(
        "flash_bwd_dq_bf16", _DQ_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(out), ptr(lse), ptr(do),
        ptr(dq), ptr(delta), B, H, k.shape[1], T, d, int(bool(causal)),
        cuda_stream(q.device),
    )
    return dq, delta


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def dkv_split(q, KV: int, causal: bool) -> int:
    """The S `flash_bwd_dkv` cuts the heaviest key tile into on q's card."""
    B, H, T, _ = q.shape
    return dkv_split_count(B, KV, H // KV, T, bool(causal), _sm_count(q.device.index))


def blocks_per_sm(kernel: str, head_dim: int) -> int:
    """How many blocks of the dq (`kernel="dq"`) or dkv kernel one SM holds
    at once (the CUDA occupancy query; launches nothing)."""
    n = ctypes.c_int(0)
    err = _DQ.function("flash_bwd_blocks_per_sm", [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p])(
        int(kernel != "dq"), head_dim, ctypes.cast(ctypes.pointer(n), ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"flash_bwd_blocks_per_sm: CUDA error {err}")
    return n.value


@functools.lru_cache(maxsize=64)
def _dkv_tables(B, KV, G, T, causal, S, device):
    blocks, reduce, n_slots = dkv_schedule(B, KV, G, T, causal, S)
    rows = torch.tensor(blocks + reduce, dtype=torch.int32).reshape(-1, SCHEDULE_COLS)
    rows = rows.to(device)
    return rows[:len(blocks)], rows[len(blocks):], n_slots


def flash_bwd_dkv(q, k, v, key_valid, lse, delta, do, causal: bool = True):
    """The dkv kernel (CUDA tensors only): `(dk, dv)` [B, KV, T, d], summed
    over each kv head's query group; `delta` from `flash_bwd_dq`. The
    entry launches the blocks of `dkv_schedule` (S from `dkv_split`), then,
    where a key tile was cut into parts, the pass that sums their f32
    partials in slot order."""
    _check_backward_inputs(q, k, v, key_valid, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 \
            or not delta.is_contiguous() or delta.data_ptr() % 16:
        raise ValueError("delta must be contiguous, 16-byte aligned [B, H, T] f32, "
                         "as flash_bwd_dq writes it")
    B, H, T, d = q.shape
    KV = k.shape[1]
    causal = bool(causal)
    valid = _key_flags(key_valid, q)
    S = dkv_split(q, KV, causal)
    blocks, reduce, n_slots = _dkv_tables(B, KV, H // KV, T, causal, S, q.device)
    # f32 partial dK then dV tiles, [slot, DKV_BLOCK_K, d] each
    partial = torch.empty(2 * max(n_slots, 1) * DKV_BLOCK_K * d, dtype=torch.float32,
                          device=q.device)
    part_v = ctypes.c_void_p(partial.data_ptr() + partial.numel() // 2 * 4)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _DKV.launch(
        "flash_bwd_dkv_bf16", _DKV_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(lse), ptr(delta), ptr(do),
        ptr(dk), ptr(dv), B, H, KV, T, d, int(causal),
        ptr(blocks), blocks.shape[0], ptr(reduce), reduce.shape[0],
        ptr(partial), part_v, cuda_stream(q.device),
    )
    return dk, dv


def flash_attention_backward(q, k, v, key_valid, out, lse, do,
                             causal: bool = True):
    """Flash-attention backward from the forward's residuals: `(dq, dk, dv)`
    shaped like q, k, v. CUDA tensors go through the two Hopper kernels
    (a Δ pass and dQ, then dK/dV reduced over the GQA group); CPU
    tensors through `flash_attention_backward_reference`."""
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, key_valid, out, lse,
                                                  do, causal)
    dq, delta = flash_bwd_dq(q, k, v, key_valid, out, lse, do, causal)
    dk, dv = flash_bwd_dkv(q, k, v, key_valid, lse, delta, do, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX `custom_vjp` around the flash kernels: the forward saves
    (q, k, v, key_valid, out, lse), the backward runs the backward kernels
    on them (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, causal):
        out, lse = flash_attention_forward(q, k, v, key_valid, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, key_valid, out, lse,
                                              do.contiguous(), ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, key_valid, causal: bool = True):
    """Blockwise flash attention (the JAX `flash_attention` entry):
    [B, H, T, d], differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, key_valid, causal)
