"""Ring attention: exact attention over a sequence sharded across the ranks
of the sp group — the port of `nanorlhf_tpu/parallel/ring_attention.py`.

Each rank keeps its query shard; the K/V shards (and their key masks)
travel around the ring, one hop a step (`Transport.ring_start`: send to the
next rank, receive from the previous one), while each rank folds the
chunk it holds into its queries' partial. Chunk causality follows global
positions: the diagonal chunk (the rank's own) is causal, past chunks
attend fully, future chunks are skipped (JAX's three `lax.switch` branches).
The next chunk's exchange is posted before the current chunk is computed.

Both rings are one `torch.autograd.Function` over per-chunk operations:

  * `ring_attention_flash` runs K1 (`ops.attention.flash_attention_forward`)
    on each hop that is not in the future, floors each chunk's LSE at
    `_LSE_FLOOR` (a past chunk whose keys are all masked for a left-padded
    row comes back finite but unconstrained) and merges the (out, LSE)
    partials in f32 (`_merge_partials`); it saves the GLOBAL LSE. The
    backward runs K2/K3 (`ops.attention.flash_attention_backward`) on each
    hop against the global out and LSE, sums dQ locally and carries the
    chunk's dK/dV partial (f32) around the ring with it, so that after N
    hops each partial is home;
  * `ring_attention` (JAX's einsum ring) runs the same schedule with the
    plain per-chunk versions (`flash_attention_reference`,
    `flash_attention_backward_reference`) on every device.

On CPU tensors the kernel wrappers take their plain versions, as every
module of the port does, so there both rings compute the same numbers.
Any local width works (the port does not copy JAX's `block_and_pad`).
"""

from __future__ import annotations

import torch

from nanorlhf_tpu_torch.ops.attention import (
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_attention_reference,
)

_LSE_FLOOR = -1e30  # stands in for log(0): keeps exp(l - max) finite
_KV_TAG, _GRAD_TAG = 1, 2


def _merge_partials(o1, l1, o2, l2):
    """Combine two partials over the same queries, flash-decoding style:
    each is (normalized out f32, LSE); the merged pair reweights by
    exp(LSE − max)."""
    m = torch.maximum(l1, l2)
    w1 = torch.exp(l1 - m)
    w2 = torch.exp(l2 - m)
    den = w1 + w2                                     # ≥ 1 (max term is 1)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / den[..., None]
    return o, m + torch.log(den)


def _hop_branch(src: int, rank: int, causal: bool) -> str | None:
    """What a rank does with the chunk owned by `src`: "diag" (causal),
    "past" (full) or None (a future chunk, skipped)."""
    if not causal:
        return "past"
    if src == rank:
        return "diag"
    return "past" if src < rank else None


def ring_forward(q, k, v, key_valid, transport, causal: bool = True, flash: bool = True):
    """The ring's forward loop: `(out f32, lse f32)` of this rank's queries
    over the whole sequence — the LSE GLOBAL, the backward's residual. K1
    per hop (`flash`) or the plain chunk (the einsum ring)."""
    fwd = flash_attention_forward if flash else flash_attention_reference
    n, rank = transport.size, transport.rank
    valid = key_valid.to(torch.uint8)
    o_acc = l_acc = None
    cur = [k.contiguous(), v.contiguous(), valid]
    for s in range(n):
        src = (rank - s) % n
        hop = transport.ring_start(cur, _KV_TAG) if s < n - 1 else None
        branch = _hop_branch(src, rank, causal)
        if branch is not None:
            o_i, l_i = fwd(q, cur[0], cur[1], cur[2].bool(), branch == "diag")
            o_i, l_i = o_i.float(), torch.clamp_min(l_i.float(), _LSE_FLOOR)
            o_acc, l_acc = ((o_i, l_i) if o_acc is None
                            else _merge_partials(o_acc, l_acc, o_i, l_i))
        if hop is not None:
            cur = hop.wait()
    return o_acc, l_acc


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, transport, causal, flash):
        q = q.contiguous()
        o_acc, l_acc = ring_forward(q, k, v, key_valid, transport, causal, flash)
        out = o_acc.to(q.dtype)
        ctx.transport, ctx.causal, ctx.flash = transport, causal, flash
        # `out` in the returned dtype: the backward's Δ = Σ dO·O uses the
        # values the downstream gradients were computed from
        ctx.save_for_backward(q, k, v, key_valid.to(torch.uint8), out, l_acc)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, out, lse = ctx.saved_tensors
        transport, causal = ctx.transport, ctx.causal
        bwd = flash_attention_backward if ctx.flash else flash_attention_backward_reference
        n, rank = transport.size, transport.rank
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        cur = [k.contiguous(), v.contiguous(), valid]
        for s in range(n):
            src = (rank - s) % n
            hop = transport.ring_start(cur, _KV_TAG) if s < n - 1 else None
            branch = _hop_branch(src, rank, causal)
            if branch is not None:
                dq_i, dk_i, dv_i = bwd(q, cur[0], cur[1], cur[2].bool(), out, lse, do,
                                       branch == "diag")
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            # the chunk's gradient partials travel with it: after n hops
            # each is back at the chunk's owner
            dk, dv = transport.ring_start([dk, dv], _GRAD_TAG).wait()
            if hop is not None:
                cur = hop.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q, k, v, key_valid, transport, causal: bool = True):
    """The einsum ring: exact attention over the full (sharded) sequence
    with the plain per-chunk operations. q [B, H, T_local, d], k/v
    [B, KV, T_local, d], key_valid [B, T_local] (this rank's shards);
    returns [B, H, T_local, d], differentiable in q, k and v."""
    return _Ring.apply(q, k, v, key_valid, transport, causal, False)


def ring_attention_flash(q, k, v, key_valid, transport, causal: bool = True):
    """The flash ring: K1 per hop forward, K2/K3 per hop backward with the
    global out and LSE (module docstring). Same contract as
    `ring_attention`."""
    return _Ring.apply(q, k, v, key_valid, transport, causal, True)
