"""Prefix-bounded decode attention — the port of
`nanorlhf_tpu/ops/decode_attention.py`: the single-token decode over the
contiguous cache, the paged cache, and their int8 twins, and the k-query
speculative verify over the contiguous and the paged cache.

Each wrapper launches its Hopper kernel (`csrc/decode_attention.cu`: one
decode body with four ways to address a cache slot, one verify body with
two) for CUDA tensors, and runs its plain version for CPU tensors; on a
CUDA tensor it launches or raises, it never falls back. The decode kernels
read only the logical slots [start, filled) of each row:

- `decode_attention` (K4, Pallas `_decode_kernel`): cache [B, KV, T, hd];
- `paged_decode_attention` (K7, `_paged_decode_kernel`): pools
  [N, KV, P, hd] shared by all rows, logical block j of row b at page
  table[b, j]; a sentinel entry (>= N) clamps to page N - 1, as in JAX;
- `decode_attention_q8` (K5, `_decode_q8_kernel`) and
  `paged_decode_attention_q8` (K8, `_paged_decode_q8_kernel`): int8 values
  with one bf16 scale per (kv head, slot), scales [B, KV, T] / [N, KV, P].

The four decode kernels are one body: each row's window is cut into S
ranges of whole 32-key tiles, one block each, and the S blocks of a
(row, kv head) merge their partial softmax states through a thread-block
cluster. S depends on (B, KV, SMs) only (`decode_split_count`), so the four
split alike; `decode_attention_split_reference` is the split's plain
version. The plain versions are JAX's XLA oracles: a masked softmax over
the whole (gathered, dequantized) cache. The TPU's Gp = max(8, G) query
padding, its 128-multiple T padding and its [.., 8, T] sublane-expanded
scale layout are not copied: the port's scale tensors carry no 8-wide
axis.

The verify kernels take Tq candidate queries per head ([B, H, Tq, hd]):
Tq = spec_k + 1 in speculative decode, and any width for the serving
path's suffix prefill (`serving/radix.suffix_logits`: Tq up to the prompt
width) and prefill chunks (Tq = `prefill_chunk`). Candidate qi reads the
slots [start, fill + qi + 1) (the candidates' K/V already written at
[fill, fill + Tq)):

- `decode_verify_attention` (K6, `_verify_kernel`): cache [B, KV, T, hd];
- `paged_decode_verify_attention` (K9, `_paged_verify_kernel`): pools and
  table as K7; the key range is clamped to the table (nb·P), as the
  gathered view of the plain version is.

The two verify kernels are one body on the tensor cores: each row's key
range is cut into S ranges of whole VERIFY_TILE-key tiles (`verify_split_
bounds`), one block each, whose VERIFY_WARPS warps take the range's tiles
round-robin; the warps' and then the S blocks' partial softmax states merge
in one launch (a thread-block cluster). S depends on (B, KV, SMs) only
(`verify_split_count`), so K6 and K9 split alike;
`decode_verify_split_reference` is the decomposition's plain version.

The int8 cache has no verify kernel, in JAX as here: the model dequantizes
and runs the plain masked contraction (`core/model.py`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanorlhf_tpu_torch._build import KERNELS, cuda_stream, ptr

NEG_INF = -1e30

_DECODE = KERNELS["decode_attention"]
_PAGED = KERNELS["paged_decode_attention"]
_Q8 = KERNELS["decode_attention_q8"]
_PAGED_Q8 = KERNELS["paged_decode_attention_q8"]
_VERIFY = KERNELS["decode_verify_attention"]
_PAGED_VERIFY = KERNELS["paged_decode_verify_attention"]
_P, _I = ctypes.c_void_p, ctypes.c_int
_DECODE_ARGS = [_P] * 6 + [_I] * 5 + [_P]
_PAGED_ARGS = [_P] * 7 + [_I] * 7 + [_P]
_Q8_ARGS = [_P] * 8 + [_I] * 5 + [_P]
_PAGED_Q8_ARGS = [_P] * 9 + [_I] * 7 + [_P]
_VERIFY_ARGS = [_P] * 6 + [_I] * 6 + [_P]
_PAGED_VERIFY_ARGS = [_P] * 7 + [_I] * 8 + [_P]
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_MAX_GROUP = 8
_KERNEL_MAX_BLOCKS = 1024  # block-table entries per row the kernel keeps
# the decode kernels' split (csrc/decode_attention.cu MAX_SPLITS,
# DECODE_BLOCKS_PER_SM): at most the portable cluster size, and enough
# blocks for one wave of three a SM
DECODE_MAX_SPLITS = 8
DECODE_BLOCKS_PER_SM = 3
DECODE_TILE = 32           # keys of a tile; a split range is whole tiles
# the verify kernels' split (csrc/decode_attention.cu VMAX_SPLITS,
# VSPLIT_BLOCKS_PER_SM, VT, VWARPS): at most the portable cluster size, and
# at most one wave of one block a SM; ranges of whole 16-key tiles, which the
# block's 4 warps take round-robin
VERIFY_MAX_SPLITS = 8
VERIFY_BLOCKS_PER_SM = 1
VERIFY_TILE = 16
VERIFY_WARPS = 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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


def reference_decode_verify_attention(q, k_cache, v_cache, start, fill):
    """The k-query (speculative verify) oracle: query i of a row attends
    over the slots [start, fill + i + 1). q: [B, H, Tq, hd]; k/v:
    [B, KV, T, hd]; start/fill: [B] int. Returns [B, H, Tq, hd]."""
    B, H, Tq, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Tq, hd)
    s = torch.einsum("bkgqh,bkth->bkgqt", qg, k_cache).float()
    s = s / math.sqrt(hd)
    pos = torch.arange(T, device=q.device)[None, None, :]
    qi = torch.arange(Tq, device=q.device)[None, :, None]
    valid = (pos >= start[:, None, None]) & (pos < fill[:, None, None] + qi + 1)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqt,bkth->bkgqh", p, v_cache)
    return out.reshape(B, H, Tq, hd)


def decode_split_count(B: int, KV: int, sms: int) -> int:
    """S, the key-range splits of each (row, kv head) in the decode kernels
    (K4, K5, K7, K8): the fewest that give one wave of DECODE_BLOCKS_PER_SM
    blocks on each of `sms` SMs, within [1, DECODE_MAX_SPLITS]. It depends
    on the shape alone — never on T_max, nb·P or a row's length — so the
    four instances split alike (`csrc/decode_attention.cu` `split_count`)."""
    return max(1, min(DECODE_MAX_SPLITS, DECODE_BLOCKS_PER_SM * sms // (B * KV)))


def decode_split_bounds(start, filled, t_max: int, S: int):
    """The decode kernels' ranges: row b's window [max(start, 0),
    min(filled, t_max)) cut into S ranges of whole DECODE_TILE-key tiles
    counted from its start, range z = [s0 + z·c, s0 + (z+1)·c) ∩ window
    with c = the tile-rounded ceil(n / S). Returns (lo, hi), [S, B] int64."""
    s0 = start.long().clamp(min=0)
    s1 = torch.maximum(filled.long().clamp(max=t_max), s0)
    chunk = (s1 - s0 + S - 1) // S
    chunk = (chunk + DECODE_TILE - 1) // DECODE_TILE * DECODE_TILE
    z = torch.arange(S, device=s0.device)[:, None]
    lo = torch.minimum(s0 + z * chunk, s1)
    return lo, torch.minimum(lo + chunk, s1)


def decode_attention_split_reference(q, k_cache, v_cache, start, filled, S: int):
    """Plain version of the decode kernels' split (`decode_split_bounds`):
    one partial softmax state (m, l, acc) per range, in f32, merged in split
    order as the cluster's rank-0 block merges them. An empty window
    returns zeros, as the kernels do (the XLA oracle averages instead).
    q: [B, H, hd]; k/v: [B, KV, T, hd]; the paged and int8 caches go
    through `_gather_pool` / `dequantize_kv` first. Returns [B, H, hd] in
    q's dtype."""
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, hd)
    vf = v_cache.float()
    s = torch.einsum("bkgh,bkth->bkgt", qf, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(T, device=q.device)
    parts = []
    for lo, hi in zip(*decode_split_bounds(start, filled, T, S)):
        inside = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
        m = torch.where(inside, s, torch.full_like(s, NEG_INF)).amax(-1)
        p = torch.where(inside, torch.exp(s - m[..., None]), torch.zeros_like(s))
        parts.append((m, p.sum(-1), torch.einsum("bkgt,bkth->bkgh", p, vf)))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, lz, az in parts:
        f = torch.exp(m - mx)
        l = l + lz * f
        acc = acc + az * f[..., None]
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def verify_split_count(B: int, KV: int, sms: int) -> int:
    """S, the key-range splits of each (row, kv head) in the verify kernels
    (K6, K9): the most that fit one wave of VERIFY_BLOCKS_PER_SM blocks on
    each of `sms` SMs, within [1, VERIFY_MAX_SPLITS]. It depends on the
    shape alone, so K6 and K9 split alike (`csrc/decode_attention.cu`
    `verify_split_count`)."""
    return max(1, min(VERIFY_MAX_SPLITS, VERIFY_BLOCKS_PER_SM * sms // (B * KV)))


def verify_split_bounds(start, fill, Tq: int, t_max: int, S: int):
    """The verify kernels' ranges: row b's keys [max(start, 0),
    min(fill + Tq, t_max)) cut into S ranges of whole VERIFY_TILE-key tiles
    counted from its start. Returns (lo, hi), [S, B] int64."""
    s0 = start.long().clamp(min=0)
    s1 = torch.maximum((fill.long() + Tq).clamp(max=t_max), s0)
    chunk = (s1 - s0 + S - 1) // S
    chunk = (chunk + VERIFY_TILE - 1) // VERIFY_TILE * VERIFY_TILE
    z = torch.arange(S, device=s0.device)[:, None]
    lo = torch.minimum(s0 + z * chunk, s1)
    return lo, torch.minimum(lo + chunk, s1)


def decode_verify_split_reference(q, k_cache, v_cache, start, fill, S: int):
    """Plain version of the verify kernels' decomposition: each row's keys
    cut into S ranges (`verify_split_bounds`), a range's VERIFY_TILE-key
    tiles dealt round-robin to VERIFY_WARPS warps; one partial softmax state
    (m, l, acc) per (range, warp) in f32, each query row masked at its own
    bound fill + qi + 1; the warps' states merged in warp order into the
    range's, the ranges' in split order, as the kernels' blocks and their
    cluster merge them. An empty window returns zeros, as the kernels do
    (the XLA oracle averages instead). q: [B, H, Tq, hd]; k/v: [B, KV, T,
    hd]; the paged cache goes through `_gather_pool` first
    (`paged_decode_verify_split_reference`). Returns [B, H, Tq, hd] in q's
    dtype."""
    B, H, Tq, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Tq, hd)
    vf = v_cache.float()
    s = torch.einsum("bkgqh,bkth->bkgqt", qf, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(T, device=q.device)
    qi = torch.arange(Tq, device=q.device)
    below = pos[None, None, :] < fill.long()[:, None, None] + qi[None, :, None] + 1
    below = below[:, None, None]                                   # [B, 1, 1, Tq, T]

    def state(inside):                                             # inside: [B, T]
        keep = inside[:, None, None, None, :] & below
        m = torch.where(keep, s, torch.full_like(s, NEG_INF)).amax(-1)
        p = torch.where(keep, torch.exp(s - m[..., None]), torch.zeros_like(s))
        return m, p.sum(-1), torch.einsum("bkgqt,bkth->bkgqh", p, vf)

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
        for m, lz, az in parts:
            f = torch.exp(m - mx)
            l, acc = l + lz * f, acc + az * f[..., None]
        return mx, l, acc

    splits = []
    for lo, hi in zip(*verify_split_bounds(start, fill, Tq, T, S)):
        in_range = (pos >= lo[:, None]) & (pos < hi[:, None])
        warp = (pos[None, :] - lo[:, None]) // VERIFY_TILE % VERIFY_WARPS
        splits.append(merge([state(in_range & (warp == w)) for w in range(VERIFY_WARPS)]))
    _, l, acc = merge(splits)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, Tq, hd).to(q.dtype)


def paged_decode_verify_split_reference(q, k_pool, v_pool, table, start, fill,
                                        S: int):
    """`decode_verify_split_reference` over pages: gather to the
    row-contiguous view [B, KV, nb·P, hd] (the kernel's key range is
    clamped to the table, as that view ends at nb·P)."""
    return decode_verify_split_reference(
        q, _gather_pool(k_pool, table), _gather_pool(v_pool, table), start, fill, S)


def _gather_pool(pool, table):
    """Pool [N, KV, P, ...] + table [B, nb] → the row-contiguous view
    [B, KV, nb·P, ...] (values [.., hd] or scales). Sentinel entries clamp
    to page N - 1, as JAX's `_gather_pool` does; callers mask those slots."""
    N = pool.shape[0]
    g = pool[table.long().clamp(max=N - 1)]        # [B, nb, KV, P, ...]
    B, nb, KV, P = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KV, nb * P, *g.shape[4:])


def dequantize_kv(values, scales, dtype):
    """int8 [.., T, hd] × bf16 scales [.., T] → `dtype` (in f32, then
    rounded once)."""
    return (values.float() * scales[..., None].float()).to(dtype)


def reference_decode_attention_q8(q, k_q, k_s, v_q, v_s, start, filled):
    """The int8 oracle: dequantize to q's dtype, then the exact reference.
    k_q/v_q: [B, KV, T, hd] int8; k_s/v_s: [B, KV, T]."""
    return reference_decode_attention(
        q, dequantize_kv(k_q, k_s, q.dtype), dequantize_kv(v_q, v_s, q.dtype),
        start, filled)


def reference_paged_decode_attention(q, k_pool, v_pool, table, start, filled):
    """Gather the pages to a row-contiguous view, then the exact reference.
    pools: [N, KV, P, hd]; table: [B, nb]."""
    return reference_decode_attention(
        q, _gather_pool(k_pool, table), _gather_pool(v_pool, table),
        start, filled)


def reference_paged_decode_verify_attention(q, k_pool, v_pool, table, start,
                                            fill):
    """The k-query oracle over pages: gather to the row-contiguous view
    [B, KV, nb·P, hd], then `reference_decode_verify_attention`."""
    return reference_decode_verify_attention(
        q, _gather_pool(k_pool, table), _gather_pool(v_pool, table),
        start, fill)


def reference_paged_decode_attention_q8(q, kq_pool, ks_pool, vq_pool, vs_pool,
                                        table, start, filled):
    """Gather the int8 and scale pools ([N, KV, P]), dequantize, then the
    exact reference."""
    return reference_decode_attention_q8(
        q, _gather_pool(kq_pool, table), _gather_pool(ks_pool, table),
        _gather_pool(vq_pool, table), _gather_pool(vs_pool, table),
        start, filled)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_query(q, KV: int):
    B, H, hd = q.shape
    if H % KV or H // KV > _KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel needs H % KV == 0 and H/KV <= "
                         f"{_KERNEL_MAX_GROUP}, got H={H}, KV={KV}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel head_dim {hd} not in {_KERNEL_HEAD_DIMS}")
    return B, H, hd


def _check_tensor(name, t, q, dtype, align=16):
    """The kernel reads K rows as 16-byte (bf16) or 8-byte (int8) vectors
    and scales one by one."""
    if t.dtype != dtype:
        raise TypeError(f"decode kernel takes {dtype} {name}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"decode kernel needs contiguous, {align}-byte "
                         f"aligned {name}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _bounds(q, B, start, filled):
    start = start.to(device=q.device, dtype=torch.int32).contiguous()
    filled = filled.to(device=q.device, dtype=torch.int32).contiguous()
    if start.shape != (B,) or filled.shape != (B,):
        raise ValueError("start/filled must be [B]")
    return start, filled


def _check_cache(what, values, scales, q, B, hd, quantized):
    """Values [B|N, KV, T|P, hd]; scales [B|N, KV, T|P] when quantized."""
    if values.dim() != 4 or values.shape[3] != hd:
        raise ValueError(f"{what} shape {tuple(values.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if quantized:
        _check_tensor(what, values, q, torch.int8, align=8)
        if scales.shape != values.shape[:3]:
            raise ValueError(f"{what} scales {tuple(scales.shape)} must be "
                             f"{tuple(values.shape[:3])}")
        _check_tensor(f"{what} scales", scales, q, torch.bfloat16, align=2)
    else:
        _check_tensor(what, values, q, torch.bfloat16)


def _check_table(table, q, B, N):
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"block table {tuple(table.shape)} must be [B={B}, nb]")
    if table.shape[1] > _KERNEL_MAX_BLOCKS:
        raise ValueError(f"paged decode kernel keeps at most "
                         f"{_KERNEL_MAX_BLOCKS} blocks per row, got {table.shape[1]}")
    if N < 1:
        raise ValueError("empty page pool")
    return table.to(device=q.device, dtype=torch.int32).contiguous()


def decode_attention(q, k_cache, v_cache, start, filled):
    """K4: prefix-bounded decode attention over the contiguous cache
    [B, KV, T, hd]. Returns [B, H, hd].

    CUDA: the Hopper kernel (bf16, head_dim 64/128, at most 8 query heads
    per kv head); a row with no valid slot returns zeros, as the Pallas
    kernel does. CPU: `reference_decode_attention`."""
    if not q.is_cuda:
        return reference_decode_attention(q, k_cache, v_cache, start, filled)
    KV = k_cache.shape[1]
    B, H, hd = _check_query(q, KV)
    _check_tensor("q", q, q, torch.bfloat16)
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_cache(name, c, None, q, B, hd, False)
        if c.shape[0] != B:
            raise ValueError(f"{name} has {c.shape[0]} rows, q {B}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v cache shapes differ")
    start, filled = _bounds(q, B, start, filled)
    out = torch.empty_like(q)
    _DECODE.launch(
        "decode_attention_bf16", _DECODE_ARGS,
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(start), ptr(filled), ptr(out),
        B, H, KV, k_cache.shape[2], hd, cuda_stream(q.device),
    )
    return out


def paged_decode_attention(q, k_pool, v_pool, table, start, filled):
    """K7: decode attention over the paged cache. q [B, H, hd]; pools
    [N, KV, P, hd] bf16; table [B, nb] int (sentinel N: unallocated);
    start/filled [B] logical slots. Returns [B, H, hd].

    CUDA: the Hopper kernel (any page size, at most 1024 blocks per row);
    CPU: `reference_paged_decode_attention`."""
    if not q.is_cuda:
        return reference_paged_decode_attention(q, k_pool, v_pool, table,
                                                start, filled)
    N, KV, P = k_pool.shape[:3]
    B, H, hd = _check_query(q, KV)
    _check_tensor("q", q, q, torch.bfloat16)
    _check_cache("k_pool", k_pool, None, q, B, hd, False)
    _check_cache("v_pool", v_pool, None, q, B, hd, False)
    if v_pool.shape != k_pool.shape:
        raise ValueError("k/v pool shapes differ")
    table = _check_table(table, q, B, N)
    start, filled = _bounds(q, B, start, filled)
    out = torch.empty_like(q)
    _PAGED.launch(
        "paged_decode_attention_bf16", _PAGED_ARGS,
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(start), ptr(filled),
        ptr(out), B, H, KV, N, P, table.shape[1], hd, cuda_stream(q.device),
    )
    return out


def decode_attention_q8(q, k_q, k_s, v_q, v_s, start, filled):
    """K5: decode attention over the int8 contiguous cache. k_q/v_q
    [B, KV, T, hd] int8, k_s/v_s [B, KV, T] bf16. Returns [B, H, hd].

    CUDA: the Hopper kernel; CPU: `reference_decode_attention_q8`."""
    if not q.is_cuda:
        return reference_decode_attention_q8(q, k_q, k_s, v_q, v_s, start, filled)
    KV = k_q.shape[1]
    B, H, hd = _check_query(q, KV)
    _check_tensor("q", q, q, torch.bfloat16)
    _check_cache("k_q", k_q, k_s, q, B, hd, True)
    _check_cache("v_q", v_q, v_s, q, B, hd, True)
    if v_q.shape != k_q.shape or k_q.shape[0] != B:
        raise ValueError(f"int8 caches {tuple(k_q.shape)}/{tuple(v_q.shape)} "
                         f"do not match q {tuple(q.shape)}")
    start, filled = _bounds(q, B, start, filled)
    out = torch.empty_like(q)
    _Q8.launch(
        "decode_attention_q8", _Q8_ARGS,
        ptr(q), ptr(k_q), ptr(k_s), ptr(v_q), ptr(v_s), ptr(start), ptr(filled),
        ptr(out), B, H, KV, k_q.shape[2], hd, cuda_stream(q.device),
    )
    return out


def paged_decode_attention_q8(q, kq_pool, ks_pool, vq_pool, vs_pool, table,
                              start, filled):
    """K8: decode attention over the int8 paged cache. int8 pools
    [N, KV, P, hd], scale pools [N, KV, P] bf16, table [B, nb]. Returns
    [B, H, hd].

    CUDA: the Hopper kernel; CPU: `reference_paged_decode_attention_q8`."""
    if not q.is_cuda:
        return reference_paged_decode_attention_q8(
            q, kq_pool, ks_pool, vq_pool, vs_pool, table, start, filled)
    N, KV, P = kq_pool.shape[:3]
    B, H, hd = _check_query(q, KV)
    _check_tensor("q", q, q, torch.bfloat16)
    _check_cache("kq_pool", kq_pool, ks_pool, q, B, hd, True)
    _check_cache("vq_pool", vq_pool, vs_pool, q, B, hd, True)
    if vq_pool.shape != kq_pool.shape:
        raise ValueError("k/v pool shapes differ")
    table = _check_table(table, q, B, N)
    start, filled = _bounds(q, B, start, filled)
    out = torch.empty_like(q)
    _PAGED_Q8.launch(
        "paged_decode_attention_q8", _PAGED_Q8_ARGS,
        ptr(q), ptr(kq_pool), ptr(ks_pool), ptr(vq_pool), ptr(vs_pool),
        ptr(table), ptr(start), ptr(filled), ptr(out),
        B, H, KV, N, P, table.shape[1], hd, cuda_stream(q.device),
    )
    return out


def decode_split_count_on_card(B: int, KV: int) -> int:
    """The S the decode kernels' C entries compute for B rows of KV kv
    heads on the current CUDA device (their own copy of
    `decode_split_count`'s rule; `chip_smoke.py` holds the two equal)."""
    S = _DECODE.function("decode_split_count", [_I, _I])(B, KV)
    if S < 1:
        raise RuntimeError(f"decode_split_count({B}, {KV}) failed: {S}")
    return S


def verify_split_count_on_card(B: int, KV: int) -> int:
    """The S the verify kernels' C entries compute for B rows of KV kv
    heads on the current CUDA device (their own copy of
    `verify_split_count`'s rule; `chip_smoke.py` holds the two equal)."""
    S = _VERIFY.function("decode_verify_split_count", [_I, _I])(B, KV)
    if S < 1:
        raise RuntimeError(f"decode_verify_split_count({B}, {KV}) failed: {S}")
    return S


def _check_verify_query(q, KV: int):
    if q.dim() != 4:
        raise ValueError(f"verify kernel takes q [B, H, Tq, hd], got {tuple(q.shape)}")
    B, H, Tq, hd = q.shape
    _check_query(q[:, :, 0], KV)
    if Tq < 1:
        raise ValueError(f"verify kernel takes Tq >= 1 queries, got {Tq}")
    _check_tensor("q", q, q, torch.bfloat16)
    return B, H, Tq, hd


def decode_verify_attention(q, k_cache, v_cache, start, fill):
    """K6: k-query verify attention over the contiguous cache. q
    [B, H, Tq, hd] (candidate i of each head reads [start, fill + i + 1)),
    k/v [B, KV, T, hd], start/fill [B]. Returns [B, H, Tq, hd].

    CUDA: the Hopper kernel (bf16, head_dim 64/128, H/KV <= 8, any Tq: a
    kv head's G·Tq query rows go to ceil(G·Tq / 32) row groups, one block
    each); a candidate with no valid slot returns zeros, as the Pallas kernel does.
    CPU: `reference_decode_verify_attention`."""
    if not q.is_cuda:
        return reference_decode_verify_attention(q, k_cache, v_cache, start, fill)
    KV = k_cache.shape[1]
    B, H, Tq, hd = _check_verify_query(q, KV)
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_cache(name, c, None, q, B, hd, False)
        if c.shape[0] != B:
            raise ValueError(f"{name} has {c.shape[0]} rows, q {B}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v cache shapes differ")
    start, fill = _bounds(q, B, start, fill)
    out = torch.empty_like(q)
    _VERIFY.launch(
        "decode_verify_attention_bf16", _VERIFY_ARGS,
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(start), ptr(fill), ptr(out),
        B, H, KV, k_cache.shape[2], Tq, hd, cuda_stream(q.device),
    )
    return out


def paged_decode_verify_attention(q, k_pool, v_pool, table, start, fill):
    """K9: k-query verify attention over the paged cache. q [B, H, Tq, hd];
    pools [N, KV, P, hd] bf16; table [B, nb] (sentinel N); start/fill [B]
    logical slots. Keys past the table (nb·P) are not read. Returns
    [B, H, Tq, hd].

    CUDA: the Hopper kernel (K6's body through the table); CPU:
    `reference_paged_decode_verify_attention`."""
    if not q.is_cuda:
        return reference_paged_decode_verify_attention(q, k_pool, v_pool, table,
                                                       start, fill)
    N, KV, P = k_pool.shape[:3]
    B, H, Tq, hd = _check_verify_query(q, KV)
    _check_cache("k_pool", k_pool, None, q, B, hd, False)
    _check_cache("v_pool", v_pool, None, q, B, hd, False)
    if v_pool.shape != k_pool.shape:
        raise ValueError("k/v pool shapes differ")
    table = _check_table(table, q, B, N)
    start, fill = _bounds(q, B, start, fill)
    out = torch.empty_like(q)
    _PAGED_VERIFY.launch(
        "paged_decode_verify_attention_bf16", _PAGED_VERIFY_ARGS,
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(start), ptr(fill),
        ptr(out), B, H, KV, N, P, table.shape[1], Tq, hd, cuda_stream(q.device),
    )
    return out
