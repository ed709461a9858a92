"""Fused hidden→logprob scoring — the port of
`nanorlhf_tpu/ops/fused_logprob.py` (forward).

Per-token `log softmax(hidden @ W / T)[labels]` (+ entropy) without the
[rows, V] logits tensor:

- `fused_logprob_kernel` wraps the Hopper kernel `csrc/fused_logprob.cu`
  (which replaces the Pallas `_fused_kernel`): CUDA tensors only, bf16, the
  tied [V, D] weight read in place (`transposed=True`).
- `fused_logprob_chunked` is its plain PyTorch version, the JAX lax path:
  row chunks of `fused_chunk_rows` each recompute a [chunk, V] logits block
  and reduce it with the same helpers as the naive path.
- `fused_logprob_reference` is the naive full-logits oracle.

`fused_logprob(..., impl=)` routes: "auto" → the kernel for CUDA tensors and
the chunked path for CPU tensors; "pallas" → the kernel (a CPU tensor takes
its plain version); "lax" → the chunked path. `with_margin` needs the
chunked path (the kernel does not track top-2): on CUDA tensors it takes
`impl="lax"` and raises otherwise. The
backward (a chunked recompute in JAX) belongs to the training slice; a CUDA
input that requires grad raises until then.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr
from nanorlhf_tpu_torch.ops.masking import (
    entropy_from_logits,
    guard_temperature,
    logprobs_from_logits,
)

NEG_INF = -1e30

# Default device-memory budget for one recomputed logits chunk (see the JAX
# module): ~(itemsize + 4) bytes per vocab entry per row.
_FUSED_BYTES_BUDGET = 256 * 1024**2

_FUSED = KERNELS["fused_logprob"]
_FUSED_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
               + [ctypes.c_void_p])
_KERNEL_BLOCK_ROWS = 128
_KERNEL_BLOCK_VOCAB = 128
_KERNEL_DEPTH_STEP = 64


def fused_chunk_rows(vocab_size: int, total_rows: int, dtype_bytes: int = 2,
                     bytes_budget: int | None = None) -> int:
    """Rows per recomputed logits chunk: chunk × V stays ≈ the budget,
    rounded down to a multiple of 8, floored at 8, capped at total_rows."""
    budget = _FUSED_BYTES_BUDGET if bytes_budget is None else bytes_budget
    per_row = max(1, vocab_size) * (dtype_bytes + 4)
    rows = max(8, int(budget) // per_row)
    rows = max(8, (rows // 8) * 8)
    return int(min(rows, max(1, total_rows)))


def _head_matmul(h, w, transposed: bool):
    """`h @ w` ([D, V] weight) or `h @ wᵀ` ([V, D], `transposed`) — a
    transposed view, never a copy."""
    return h @ (w.t() if transposed else w)


def fused_logprob_reference(hidden, unembed, labels, temperature: float = 1.0,
                            with_entropy: bool = False, with_margin: bool = False,
                            transposed: bool = False):
    """Naive full-logits path (the parity oracle)."""
    logits = _head_matmul(hidden, unembed, transposed)
    t = guard_temperature(temperature)
    out = (logprobs_from_logits(logits, labels, temperature),)
    if with_entropy:
        out += (entropy_from_logits(logits.float() / t).detach(),)
    if with_margin:
        top2 = torch.topk(logits.float() / t, 2, dim=-1).values
        out += ((top2[..., 0] - top2[..., 1]).detach(),)
    return out[0] if len(out) == 1 else out


def fused_logprob_chunked(hidden, unembed, labels, temperature, chunk: int,
                          with_entropy: bool = False, with_margin: bool = False,
                          transposed: bool = False):
    """Plain version of the kernel over 2-D rows: one [chunk, V] logits
    block at a time. Returns a tuple `(lp[, ent][, margin])`, each [R] f32."""
    R = hidden.shape[0]
    t = guard_temperature(temperature)
    outs = []
    for i in range(0, R, chunk):
        z = _head_matmul(hidden[i:i + chunk], unembed, transposed)
        part = (logprobs_from_logits(z, labels[i:i + chunk], temperature),)
        if with_entropy:
            part += (entropy_from_logits(z.float() / t),)
        if with_margin:
            top2 = torch.topk(z.float() / t, 2, dim=-1).values
            part += (top2[..., 0] - top2[..., 1],)
        outs.append(part)
    return tuple(torch.cat(cols) for cols in zip(*outs))


def _kernel_splits(R: int, V: int, device) -> int:
    """Vocab splits per row tile: enough blocks for ~8 per SM, never more
    splits than vocab tiles."""
    n_rt = -(-R // _KERNEL_BLOCK_ROWS)
    n_vt = -(-V // _KERNEL_BLOCK_VOCAB)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_vt, -(-8 * sms // n_rt)))


def fused_logprob_kernel(hidden, unembed, labels, temperature: float = 1.0,
                         with_entropy: bool = False, transposed: bool = False):
    """The Hopper kernel over 2-D rows: `(lp [R] f32, ent [R] f32 | None)`.
    hidden [R, D] bf16, unembed [D, V] (or [V, D] when `transposed`) bf16,
    labels [R] int. CUDA tensors only."""
    if not hidden.is_cuda:
        raise ValueError("fused_logprob_kernel runs on CUDA tensors only")
    if hidden.requires_grad or unembed.requires_grad:
        raise NotImplementedError(
            "fused_logprob has no backward yet: its chunked-recompute "
            "backward is ported by the training slice")
    R, D = hidden.shape
    V = unembed.shape[0] if transposed else unembed.shape[1]
    if (unembed.shape[1] if transposed else unembed.shape[0]) != D:
        raise ValueError(f"unembed {tuple(unembed.shape)} does not match D={D} "
                         f"(transposed={transposed})")
    if labels.shape != (R,):
        raise ValueError(f"labels shape {tuple(labels.shape)} != {(R,)}")
    if D % _KERNEL_DEPTH_STEP:
        raise ValueError(f"fused_logprob kernel needs D % {_KERNEL_DEPTH_STEP} == 0, got {D}")
    if not transposed and V % 8:
        raise ValueError(f"fused_logprob kernel needs V % 8 == 0 for a [D, V] weight, got {V}")
    for name, t in (("hidden", hidden), ("unembed", unembed)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_logprob kernel takes bf16, got {name}.dtype={t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_logprob kernel needs contiguous, 16-byte aligned {name}")
        if t.device != hidden.device:
            raise ValueError(f"{name} is on {t.device}, hidden on {hidden.device}")
    labels = labels.to(device=hidden.device, dtype=torch.int32).contiguous()
    splits = _kernel_splits(R, V, hidden.device)
    part = torch.empty((splits, R, 4), dtype=torch.float32, device=hidden.device)
    lp = torch.empty((R,), dtype=torch.float32, device=hidden.device)
    ent = (torch.empty((R,), dtype=torch.float32, device=hidden.device)
           if with_entropy else None)
    _FUSED.launch(
        "fused_logprob_bf16", _FUSED_ARGS,
        ptr(hidden), ptr(unembed), ptr(labels), ptr(part), ptr(lp),
        ctypes.c_void_p(ent.data_ptr() if ent is not None else None),
        R, D, V, int(bool(transposed)), splits,
        1.0 / guard_temperature(temperature), cuda_stream(hidden.device),
    )
    return lp, ent


def _resolve_impl(impl: str, with_margin: bool, is_cuda: bool) -> str:
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(f"fused_logprob impl={impl!r}: auto | lax | pallas")
    if impl == "lax" or not is_cuda:
        return "chunked"
    if with_margin:
        # JAX quietly takes its lax path here; the port never swaps a CUDA
        # call's kernel for the plain version unless the caller asks
        raise NotImplementedError(
            "the fused_logprob kernel does not track the top-2 margin: "
            "pass impl='lax' for with_margin on CUDA tensors")
    return "kernel"


def fused_logprob(hidden, unembed, labels, temperature: float = 1.0, *,
                  chunk: int | None = None, impl: str = "auto",
                  with_entropy: bool = False, with_margin: bool = False,
                  bytes_budget: int | None = None, transposed: bool = False):
    """Per-token `log softmax(hidden @ unembed / T)[labels]` without the
    [..., V] logits tensor. Returns `logprobs` (f32, shaped like `labels`),
    or `(logprobs[, entropy][, margin])` when extras are requested."""
    lead = hidden.shape[:-1]
    D = hidden.shape[-1]
    V = unembed.shape[0] if transposed else unembed.shape[-1]
    if tuple(labels.shape) != tuple(lead):
        raise ValueError(f"labels shape {tuple(labels.shape)} != hidden[:-1] {tuple(lead)}")
    R = int(np.prod(lead)) if lead else 1
    h2 = hidden.reshape(R, D)
    l2 = labels.reshape(R)
    if _resolve_impl(impl, with_margin, hidden.is_cuda) == "kernel":
        lp, ent = fused_logprob_kernel(h2.contiguous(), unembed, l2, temperature,
                                       with_entropy=with_entropy,
                                       transposed=transposed)
        outs = (lp,) if ent is None else (lp, ent)
    else:
        if chunk is None:
            chunk = fused_chunk_rows(V, R, dtype_bytes=hidden.element_size(),
                                     bytes_budget=bytes_budget)
        chunk = max(1, min(int(chunk), R))
        outs = fused_logprob_chunked(h2, unembed, l2, temperature, chunk,
                                     with_entropy, with_margin, transposed)
    outs = tuple(o.reshape(lead) for o in outs)
    if not with_entropy and not with_margin:
        return outs[0]
    return outs
