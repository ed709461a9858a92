"""Causal GQA flash attention — the port of `nanorlhf_tpu/ops/attention.py`.

- `flash_attention_forward` wraps the Hopper kernel `csrc/flash_fwd.cu`
  (which replaces the Pallas `_flash_kernel`);
- `flash_attention_backward` wraps the two kernels of `csrc/flash_bwd.cu`
  (`_dq_kernel` and `_dkv_kernel`): dQ, then dK/dV already summed over each
  kv head's query group;
- `flash_attention` is the differentiable entry (the JAX `custom_vjp`
  becomes `_FlashAttention`, a `torch.autograd.Function`): forward = the
  forward kernel, saving (q, k, v, key_valid, out, lse); backward = the two
  backward kernels.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version for CPU tensors: `flash_attention_reference` and
`flash_attention_backward_reference`, which `chip_smoke.py` also holds the
kernels against on the card. So on the CPU the backward of
`flash_attention` is `flash_attention_backward_reference`, the FA2 formulas
written out, not autograd through `_reference`. The TPU tiling workarounds
(128-multiple T padding, sublane-broadcast mask, lane-expanded LSE) are not
copied: any T works and LSE is [B, H, T] f32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr

NEG_INF = -1e30

_FLASH = KERNELS["flash_fwd"]
_FLASH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DQ = KERNELS["flash_bwd_dq"]
_DKV = KERNELS["flash_bwd_dkv"]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_KERNEL_HEAD_DIMS = (64, 128)


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
    valid = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _FLASH.launch(
        "flash_fwd_bf16", _FLASH_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(out), ptr(lse),
        B, H, k.shape[1], T, d, int(bool(causal)), cuda_stream(q.device),
    )
    return out, lse


def _check_backward_inputs(q, k, v, key_valid, lse, do, **bf16):
    if not q.is_cuda:
        raise ValueError("the flash backward kernels run on CUDA tensors only")
    _check_cuda_inputs(q, k, v, key_valid)
    _check_contiguous_bf16(q, do=do, **bf16)
    B, H, T, _ = q.shape
    if any(t.device != q.device for t in (lse, do, *bf16.values())):
        raise ValueError(f"every flash backward input must be on {q.device}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [B, H, T] f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_bwd_dq(q, k, v, key_valid, out, lse, do, causal: bool = True):
    """The dq kernel (CUDA tensors only): `(dq [B, H, T, d], delta
    [B, H, T] f32)`, delta = Σ dO·O computed in the kernel's body."""
    _check_backward_inputs(q, k, v, key_valid, lse, do, out=out)
    B, H, T, d = q.shape
    valid = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _DQ.launch(
        "flash_bwd_dq_bf16", _BWD_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(out), ptr(lse), ptr(do),
        ptr(dq), ptr(delta), B, H, k.shape[1], T, d, int(bool(causal)),
        cuda_stream(q.device),
    )
    return dq, delta


def flash_bwd_dkv(q, k, v, key_valid, lse, delta, do, causal: bool = True):
    """The dkv kernel (CUDA tensors only): `(dk, dv)` [B, KV, T, d], summed
    over each kv head's query group; `delta` from `flash_bwd_dq`."""
    _check_backward_inputs(q, k, v, key_valid, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError("delta must be [B, H, T] f32, as flash_bwd_dq writes it")
    B, H, T, d = q.shape
    valid = key_valid.to(device=q.device, dtype=torch.uint8).contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _DKV.launch(
        "flash_bwd_dkv_bf16", _BWD_ARGS,
        ptr(q), ptr(k), ptr(v), ptr(valid), ptr(lse), ptr(delta), ptr(do),
        ptr(dk), ptr(dv), B, H, k.shape[1], T, d, int(bool(causal)),
        cuda_stream(q.device),
    )
    return dk, dv


def flash_attention_backward(q, k, v, key_valid, out, lse, do,
                             causal: bool = True):
    """Flash-attention backward from the forward's residuals: `(dq, dk, dv)`
    shaped like q, k, v. CUDA tensors go through the two Hopper kernels
    (dQ with Δ in its body, then dK/dV reduced over the GQA group); CPU
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
