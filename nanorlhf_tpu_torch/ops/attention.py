"""Causal GQA flash attention — the port of `nanorlhf_tpu/ops/attention.py`
(forward only).

`flash_attention_forward` is the wrapper around the Hopper kernel
`csrc/flash_fwd.cu` (which replaces the Pallas `_flash_kernel`): for a CUDA
tensor it launches the kernel or raises; for a CPU tensor it runs the plain
PyTorch version beside it (`flash_attention_reference`), which is also what
`chip_smoke.py` holds the kernel against on the card. The TPU tiling
workarounds (128-multiple T padding, sublane-broadcast mask, lane-expanded
LSE) are not copied: any T works and LSE comes back as [B, H, T] f32.

The backward kernels (`_dq_kernel`, `_dkv_kernel`) belong to the training
slice; until then a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr

NEG_INF = -1e30

_FLASH = KERNELS["flash_fwd"]
_FLASH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    mask = key_valid.bool()[:, None, None, None, :]
    if causal:
        tril = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        mask = mask & tril[None, None, None, :, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bkth->bkgqh", p, v)
    return out.reshape(B, H, T, d), lse.reshape(B, H, T)


def _check_cuda_inputs(q, k, v, key_valid):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention has no backward kernel yet: the flash backward "
            "(Pallas _dq_kernel/_dkv_kernel) is ported by the training slice")
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


def flash_attention(q, k, v, key_valid, causal: bool = True):
    """Blockwise flash attention (the JAX `flash_attention` entry): [B, H, T, d]."""
    return flash_attention_forward(q, k, v, key_valid, causal)[0]
