"""Prefix-bounded decode attention — the port of
`nanorlhf_tpu/ops/decode_attention.py` (the contiguous single-token path).

`decode_attention` wraps the Hopper kernel `csrc/decode_attention.cu`
(which replaces the Pallas `_decode_kernel`): for a CUDA tensor it launches
the kernel, which reads only the cache slots [start, filled) of each row;
for a CPU tensor it runs `reference_decode_attention`, the plain masked
softmax over the whole cache (the JAX XLA oracle). The TPU's Gp = max(8, G)
query padding and the 128-multiple T padding are not copied.

The paged, verify and int8 variants (K5–K9) are off the rollout path and
not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr

NEG_INF = -1e30

_DECODE = KERNELS["decode_attention"]
_DECODE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_MAX_GROUP = 8


def reference_decode_attention(q, k_cache, v_cache, start, filled):
    """Masked softmax over the cache. q: [B, H, hd]; k/v: [B, KV, T, hd];
    start/filled: [B] int. Returns [B, H, hd]."""
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bkth->bkgt", qg, k_cache).float()
    s = s / math.sqrt(hd)
    pos = torch.arange(T, device=q.device)[None, :]
    valid = (pos >= start[:, None]) & (pos < filled[:, None])  # [B, T]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,bkth->bkgh", p, v_cache)
    return out.reshape(B, H, hd)


def decode_attention(q, k_cache, v_cache, start, filled):
    """Prefix-bounded decode attention over the contiguous cache: [B, H, hd].

    CUDA: the Hopper kernel (bf16, head_dim 64/128, at most 8 query heads
    per kv head); a row with no valid slot returns zeros, as the Pallas
    kernel does. CPU: `reference_decode_attention`."""
    if not q.is_cuda:
        return reference_decode_attention(q, k_cache, v_cache, start, filled)
    B, H, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v cache shapes differ")
    KV, T = k_cache.shape[1], k_cache.shape[2]
    if H % KV or H // KV > _KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel needs H % KV == 0 and H/KV <= "
                         f"{_KERNEL_MAX_GROUP}, got H={H}, KV={KV}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel head_dim {hd} not in {_KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode kernel takes bf16, got {name}.dtype={t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode kernel needs contiguous, 16-byte aligned {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    start = start.to(device=q.device, dtype=torch.int32).contiguous()
    filled = filled.to(device=q.device, dtype=torch.int32).contiguous()
    if start.shape != (B,) or filled.shape != (B,):
        raise ValueError("start/filled must be [B]")
    out = torch.empty_like(q)
    _DECODE.launch(
        "decode_attention_bf16", _DECODE_ARGS,
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(start), ptr(filled), ptr(out),
        B, H, KV, T, hd, cuda_stream(q.device),
    )
    return out
