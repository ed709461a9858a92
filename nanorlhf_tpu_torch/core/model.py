"""Qwen2-family decoder over a stacked-layer parameter dict — the port of
`nanorlhf_tpu/core/model.py` (contiguous and paged KV caches, exact or
int8, the k-token speculative verify, int8 weight-only projections, and
both remat policies of the training forward).

Parameters keep the JAX tree's names and its stacked `[L, ...]` layout, in
torch's nn.Linear orientation: every projection `kernel` is `[L, out, in]`
(`F.linear(x, W)`), `lm_head` is `[V, D]`, LoRA `a`/`b` are `[L, r, in]` /
`[L, out, r]`. `bridge.py` converts a JAX tree (kernels `[in, out]`) both
ways. bf16 weights, f32 softmax / norm statistics / rotary tables, as in
JAX.

Attention routing (`ModelConfig.attention_impl`): "xla" is the plain
masked einsum path everywhere; "pallas" sends prefill/scoring to the flash
kernel, single-token decode to the decode kernel of the cache's layout
(K4 contiguous, K7 paged, K5 int8, K8 int8 paged — never K4 over a gathered
or dequantized copy) and the speculative verify of an exact cache to K6
(contiguous) or K9 (paged); "auto" does the same for CUDA tensors and takes
the plain path for CPU tensors. The verify over the int8 cache dequantizes
and runs the plain masked contraction on every route, as JAX does (it has
no q8 k-query kernel).

Unlike JAX's functional cache, `prefill`/`decode_step`/`decode_verify`
write the KV cache IN PLACE (saving a [L, B, KV, T_max, hd] copy per
step) and return the same tensors.

Caches (`init_kv_cache`, `init_paged_kv_cache`): exact `(k, v)` or, with
`kv_cache_quant="int8"`, `(k_q, k_s, v_q, v_s)` — int8 values and one
bf16 scale per (kv head, slot). The scales are `[L, B, KV, T]` /
`[L, N, KV, P]`: JAX's `[.., 8, T]` sublane expansion was a TPU tiling
workaround and would multiply the scale stream by 8.

The paged layout: a pool of pages `[L, N + 1, KV, P, hd]` shared by all
rows and a block table `[B, nb]` (logical slot t of row b at page
table[b, t // P], offset t % P; sentinel N = unallocated). JAX drops a
write to a sentinel page or past the table with `mode="drop"`; torch's
`index_put_` has no such mode, so the pool carries ONE SCRATCH PAGE at
index N that absorbs those writes. Readers see only pages [0, N): the
kernels and the gathered view clamp sentinel entries to N - 1, as JAX
does, so the scratch page is never read.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.ops.attention import flash_attention
from nanorlhf_tpu_torch.ops.decode_attention import (
    _gather_pool,
    decode_attention,
    decode_attention_q8,
    decode_verify_attention,
    dequantize_kv,
    paged_decode_attention,
    paged_decode_attention_q8,
    paged_decode_verify_attention,
)

NEG_INF = -2.0**30  # large-but-finite mask value, as in JAX

_IMPLS = ("xla", "pallas", "auto")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Random-init a full parameter tree from `seed` (the offline demo model).

    Same distributions as the JAX `init_params` (whose bits a torch
    generator cannot reproduce): embeddings and lm_head N(0, 0.02²), every
    stacked projection N(0, 1/L) — the JAX init scales by the first axis of
    the stacked [L, in, out] shape — zero biases, unit norms."""
    hd = config.actual_head_dim
    D, F_, V = config.hidden_size, config.intermediate_size, config.vocab_size
    H, KV, L = config.num_attention_heads, config.num_key_value_heads, config.num_hidden_layers
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    def stacked(out_f, in_f):
        return normal((L, out_f, in_f), 1.0 / math.sqrt(L))

    def qkv(out_f):
        entry = {"kernel": stacked(out_f, D)}
        if config.attention_bias:
            entry["bias"] = torch.zeros((L, out_f), dtype=dtype, device=device)
        return entry

    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)  # noqa: E731
    params = {
        "embed_tokens": normal((V, D), 0.02),
        "layers": {
            "input_layernorm": ones(L, D),
            "q_proj": qkv(H * hd),
            "k_proj": qkv(KV * hd),
            "v_proj": qkv(KV * hd),
            "o_proj": {"kernel": stacked(D, H * hd)},
            "post_attention_layernorm": ones(L, D),
            "gate_proj": {"kernel": stacked(F_, D)},
            "up_proj": {"kernel": stacked(F_, D)},
            "down_proj": {"kernel": stacked(D, F_)},
        },
        "norm": ones(D),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = normal((V, D), 0.02)
    return params


def _unstack(tree):
    """{name: [L, ...]} (nested) → L per-layer dicts of views."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [B, T, hd] for the given absolute positions (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)  # HF rotate_half layout
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, hd]; cos/sin: [B, T, hd] (HF rotate-half convention)."""
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"attention_impl={impl!r}: must be one of {_IMPLS}")


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Route attention on `x` through the Hopper kernels (flash for T > 1,
    prefix-bounded decode for T == 1)? The JAX package's separate
    `use_flash`/`use_decode_kernel` differ only in TPU length thresholds,
    which the port does not carry over."""
    _check_impl(impl)
    return impl == "pallas" or (impl == "auto" and x.is_cuda)


def gqa_attention(q, k, v, mask, impl: str = "xla",
                  mask_is_causal_x_keyvalid: bool = False):
    """q [B, H, Tq, hd], k/v [B, KV, Tk, hd], mask [B, 1, Tq, Tk] bool.
    `mask_is_causal_x_keyvalid` asserts mask = causal & key_valid[B, Tk],
    which the flash path needs (it rebuilds the causal part itself)."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    if use_kernel(impl, q) and mask_is_causal_x_keyvalid and Tq == Tk and Tq > 1:
        key_valid = mask[:, 0, -1, :]  # the last query row: causal is all-True
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               key_valid, causal=True)
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, Tq, hd)
    scores = torch.einsum("bkgqh,bkth->bkgqt", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bkth->bkgqh", probs, v)
    return out.reshape(B, H, Tq, hd)


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def _proj(h, layer, lora_layer, name, lora_scale):
    """x @ Wᵀ (+ bias) (+ LoRA ((x @ Aᵀ) @ Bᵀ) · scale).

    The int8 weight-only form (`kernel_q` [out, in] + `kernel_scale`
    [1, out], core/quant.py) in JAX's order: the upcast int8 kernel feeds
    the product, the per-output-channel scale multiplies its f32 output,
    then bias and LoRA."""
    p = layer[name]
    if "kernel_q" in p:
        y = F.linear(h, p["kernel_q"].to(h.dtype))
        y = (y.float() * p["kernel_scale"]).to(h.dtype)
    else:
        y = F.linear(h, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    if lora_layer is not None and name in lora_layer:
        ab = lora_layer[name]
        y = y + F.linear(F.linear(h, ab["a"]), ab["b"]) * lora_scale
    return y


def _row_index(cache_index, B: int, device) -> torch.Tensor:
    """A write's first cache slot per row, [B] int64: `cache_index` is an
    int or a one-element device tensor shared by every row (the compiled
    decode loop's slot: no host read), or a per-row [B] tensor
    (continuous-batching rows sit at different depths)."""
    idx = torch.as_tensor(cache_index, device=device).to(torch.int64)
    return idx.reshape(-1).expand(B)


def _slots(cache_index, B: int, T: int, device):
    """Logical cache slots [B, T] of a write of T tokens starting at
    `cache_index` (see `_row_index`)."""
    return (_row_index(cache_index, B, device)[:, None]
            + torch.arange(T, device=device)[None, :])


def _cache_update(cache, new, idx):
    """Write `new` [B, KV, T, ...] into `cache` [B, KV, T_max, ...] at slot
    `idx` (int, one-element or per-row [B] tensor), in place. Values carry
    a trailing hd axis, int8 scales do not."""
    if isinstance(idx, int):
        cache[:, :, idx:idx + new.shape[2]] = new
        return cache
    B, T = new.shape[0], new.shape[2]
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, :, _slots(idx, B, T, cache.device)] = new.transpose(1, 2)
    return cache


def _paged_pages(num_pages: int, table, slots, page_size: int):
    """Resolve logical slots [B, T] to (physical page, offset). Slots past
    the table and sentinel entries both map to the scratch page
    `num_pages`, the counterpart of JAX's `mode="drop"`."""
    nb = table.shape[1]
    lb = slots // page_size
    page = torch.where(
        lb < nb,
        torch.gather(table.long(), 1, lb.clamp(0, nb - 1)).clamp(max=num_pages),
        torch.full_like(lb, num_pages))
    return page, slots % page_size


def _paged_cache_update(pool, new, dest):
    """Write `new` [B, KV, T, ...] into the pool [N + 1, KV, P, ...] in
    place (values [.., hd] or int8 scales) at `dest` = (page, offset), each
    [B, T], from `_paged_pages`."""
    page, off = dest
    pool[page, :, off] = new.transpose(1, 2)
    return pool


def live_pages(pool):
    """The readable pages [0, N) of a pool (the scratch page dropped)."""
    return pool[:-1]


def _paged_view(pool, table, width: int):
    """The row-contiguous [B, KV, width, ...] view gathered through the
    table (the plain read path): sentinel entries clamp to page N - 1, whose
    values sit in slots the mask excludes, so this view gives the same
    attention as the contiguous cache under the same mask."""
    return _gather_pool(live_pages(pool), table)[:, :, :width]


def quantize_kv(x):
    """[B, KV, T, hd] → (int8 [B, KV, T, hd], bf16 scales [B, KV, T]): the
    scale absmax/127 is rounded to bf16 first and the values are divided by
    the ROUNDED scale (round half to even, clip ±127), as JAX's
    `_quantize_kv` does, so dequantization is exact with respect to what
    the cache holds."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    q = torch.round(xf / scale.float()[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _write_kv(kv_cache, k, v, cache_index, paged):
    """Write the layer's new K/V (quantized for the int8 cache) into the
    cache tuple, in place, through the table when paged."""
    if len(kv_cache) == 4:
        # K and V quantized in one call: the same per-(slot, head) math,
        # half the launches
        values, scales = quantize_kv(torch.stack((k, v)))
        new = (values[0], scales[0], values[1], scales[1])
    else:
        new = (k, v)
    for cache, n in zip(kv_cache, new):
        if paged is not None:
            _paged_cache_update(cache, n, paged[2])
        else:
            _cache_update(cache, n, cache_index)


def _decode_kernel_attention(q, kv_cache, paged, decode_bounds):
    """Single-token decode through the kernel of the cache's layout:
    K4 (contiguous), K7 (paged), K5 (int8), K8 (int8 paged)."""
    q1 = q[:, :, 0, :].contiguous()
    start, filled = decode_bounds
    if paged is not None:
        table = paged[0]
        pools = tuple(live_pages(c) for c in kv_cache)
        if len(kv_cache) == 4:
            out = paged_decode_attention_q8(q1, *pools, table, start, filled)
        else:
            out = paged_decode_attention(q1, *pools, table, start, filled)
    elif len(kv_cache) == 4:
        out = decode_attention_q8(q1, *kv_cache, start, filled)
    else:
        out = decode_attention(q1, *kv_cache, start, filled)
    return out[:, :, None, :]


def _verify_kernel_attention(q, kv_cache, paged, verify_bounds):
    """The k-query verify through the kernel of the exact cache's layout:
    K6 (contiguous) or K9 (paged)."""
    start, fill = verify_bounds
    q = q.contiguous()
    if paged is not None:
        pools = tuple(live_pages(c) for c in kv_cache)
        return paged_decode_verify_attention(q, *pools, paged[0], start, fill)
    return decode_verify_attention(q, *kv_cache, start, fill)


def _cache_views(kv_cache, paged, width: int, dtype):
    """(k, v) row-contiguous, dequantized views of the cache for the plain
    masked attention."""
    if paged is not None:
        parts = tuple(_paged_view(c, paged[0], width) for c in kv_cache)
    else:
        parts = kv_cache
    if len(parts) == 4:
        return (dequantize_kv(parts[0], parts[1], dtype),
                dequantize_kv(parts[2], parts[3], dtype))
    return parts


def _layer_body(config: ModelConfig, x, layer, cos, sin, mask, kv_cache,
                cache_index, lora_layer=None, lora_scale=1.0,
                decode_bounds=None, paged=None, verify_bounds=None):
    """One decoder layer. kv_cache: the layer's cache tuple — exact (k, v)
    or int8 (k_q, k_s, v_q, v_s), contiguous [B, KV, T_max, ...] or paged
    pools [N + 1, KV, P, ...] with `paged=(table [B, nb], page_size,
    (page, offset) of this write)` — or None. Returns the layer output
    (the cache is updated in place).

    With a cache: prefill (T > 1) attends over the layer's own exact K/V
    (through the flash kernel on the kernel route; the slots beyond T are
    masked anyway) and writes the (quantized) K/V; decode (T == 1) reads the
    cache through its layout's kernel, or, on the plain route, through a
    gathered, dequantized view under the same mask as the contiguous cache
    (the CPU tests pin paged == contiguous bit for bit). `verify_bounds =
    (start, fill)` marks the speculative verify (T = Tq candidates written at
    per-row slots [fill, fill + Tq)): K6/K9 over an exact cache on the
    kernel route; otherwise — the plain route, and the int8 cache on every
    route, as in JAX — the masked contraction over the cache views."""
    hd = config.actual_head_dim
    H, KV = config.num_attention_heads, config.num_key_value_heads
    B, T, _ = x.shape
    impl = config.attention_impl

    h = rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
    q = _proj(h, layer, lora_layer, "q_proj", lora_scale)
    k = _proj(h, layer, lora_layer, "k_proj", lora_scale)
    v = _proj(h, layer, lora_layer, "v_proj", lora_scale)
    q = q.reshape(B, T, H, hd).transpose(1, 2)
    k = k.reshape(B, T, KV, hd).transpose(1, 2)
    v = v.reshape(B, T, KV, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        _write_kv(kv_cache, k, v, cache_index, paged)
        quantized = len(kv_cache) == 4
        if verify_bounds is not None:
            if use_kernel(impl, q) and not quantized:
                out = _verify_kernel_attention(q, kv_cache, paged, verify_bounds)
            else:
                kd, vd = _cache_views(kv_cache, paged, mask.shape[-1], q.dtype)
                out = gqa_attention(q, kd, vd, mask)
        elif T > 1 and use_kernel(impl, q):
            # prefill: slots beyond T are masked anyway, so attend over the
            # local K/V through the flash kernel
            out = gqa_attention(q, k, v, mask[..., :T], impl="pallas",
                                mask_is_causal_x_keyvalid=True)
        elif T > 1 and quantized:
            # the plain int8 prefill attends over the local exact K/V, as
            # JAX's int8 branch does (the cache holds the quantized copy)
            out = gqa_attention(q, k, v, mask[..., :T])
        elif T == 1 and decode_bounds is not None and use_kernel(impl, q):
            out = _decode_kernel_attention(q, kv_cache, paged, decode_bounds)
        else:
            kd, vd = _cache_views(kv_cache, paged, mask.shape[-1], q.dtype)
            out = gqa_attention(q, kd, vd, mask)
    else:
        out = gqa_attention(q, k, v, mask, impl=impl,
                            mask_is_causal_x_keyvalid=True)
    out = out.transpose(1, 2).reshape(B, T, H * hd)
    x = x + _proj(out, layer, lora_layer, "o_proj", lora_scale)

    h = rms_norm(x, layer["post_attention_layernorm"], config.rms_norm_eps)
    gate = _proj(h, layer, lora_layer, "gate_proj", lora_scale)
    up = _proj(h, layer, lora_layer, "up_proj", lora_scale)
    ff = _proj(F.silu(gate.float()).to(h.dtype) * up, layer, lora_layer,
               "down_proj", lora_scale)
    return x + ff


_GEMMS_2D = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for remat_policy="dots": keep the
    output of every 2-D GEMM — the base projections and both LoRA products
    (`F.linear` over [B, T, in] folds to `mm`) — and recompute the rest.
    That is JAX's `dots_with_no_batch_dims_saveable`: the attention's
    batched products (`bmm`, from the plain route's einsums) are not kept,
    and neither is the flash kernel, which no aten op launches."""
    if op in _GEMMS_2D:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str) -> dict:
    """`checkpoint`'s keyword arguments for a remat policy."""
    if policy == "full":
        return {}
    if policy == "dots":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)}
    raise ValueError(f"remat_policy={policy!r}: must be 'full' or 'dots'")


def _run_layers(config, params, x, cos, sin, mask, kv_caches=None,
                cache_index=0, lora_scale=1.0, decode_bounds=None,
                remat: bool = False, paged=None, verify_bounds=None):
    """Run the stacked layers in order. kv_caches: the stacked cache tuple
    ((k, v) or (k_q, k_s, v_q, v_s), each [L, ...], updated in place) or
    None; `paged=(table, page_size)` when it is a page pool.

    `remat=True` (the training path, `gradient_checkpointing`) checkpoints
    each layer (`torch.utils.checkpoint`, non-reentrant), the counterpart
    of JAX's `jax.checkpoint` around the scan body. `remat_policy="full"`
    keeps only the layer's input, and the backward re-runs its forward;
    `"dots"` also keeps the outputs of its 2-D GEMMs (`_remat_context`).
    Either changes memory, not values."""
    remat_kw = _remat_context(config.remat_policy) if remat else {}
    if paged is not None and kv_caches is not None:
        # where this forward's K/V land in the pool: resolved once, not
        # per layer and cache
        table, page_size = paged
        slots = _slots(cache_index, x.shape[0], x.shape[1], x.device)
        paged = (table, page_size, _paged_pages(kv_caches[0].shape[1] - 1,
                                                table, slots, page_size))
    layers = _unstack(params["layers"])
    lora = params.get("lora")
    lora_layers = _unstack(lora["layers"]) if lora else [None] * len(layers)
    for i, (layer, lora_layer) in enumerate(zip(layers, lora_layers)):
        kv = None if kv_caches is None else tuple(c[i] for c in kv_caches)
        if remat and kv is None:
            x = checkpoint(_layer_body, config, x, layer, cos, sin, mask, None,
                           cache_index, lora_layer, lora_scale,
                           use_reentrant=False, **remat_kw)
        else:
            x = _layer_body(config, x, layer, cos, sin, mask, kv, cache_index,
                            lora_layer, lora_scale, decode_bounds=decode_bounds,
                            paged=paged, verify_bounds=verify_bounds)
    return x


def unembedding(config: ModelConfig, params: dict):
    """`(weight, transposed)` for the fused hidden→logprob op: the vocab-
    major `[V, D]` weight with `transposed=True` — `embed_tokens` when tied,
    `lm_head` (stored [V, D] in this port) otherwise. Never a transposed
    copy."""
    if config.tie_word_embeddings:
        return params["embed_tokens"], True
    return params["lm_head"], True


def unembedding_weight(config: ModelConfig, params: dict) -> torch.Tensor:
    """The [D, V] unembedding matrix as a transposed view."""
    return unembedding(config, params)[0].t()


def _logits(config: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    return F.linear(x, unembedding(config, params)[0])


# ---------------------------------------------------------------------------
# Public entrypoints
# ---------------------------------------------------------------------------

def padding_inputs(query_responses: torch.Tensor, pad_token_id: int):
    """(input_ids, attention_mask, position_ids) from padded token ids:
    mask = ids != pad, positions = cumsum(mask) - mask, pads zeroed."""
    attention_mask = query_responses != pad_token_id
    m = attention_mask.to(torch.int64)
    position_ids = torch.cumsum(m, dim=1) - m
    input_ids = torch.where(attention_mask, query_responses,
                            torch.zeros_like(query_responses))
    return input_ids, attention_mask, position_ids


def _hidden_from_inputs(params, config, input_ids, attention_mask, position_ids,
                        lora_scale, remat: bool = False):
    """embed → rope → causal+padding mask → layers."""
    attention_mask = attention_mask.bool()
    x = params["embed_tokens"][input_ids]
    T = input_ids.shape[1]
    cos, sin = rope_tables(position_ids, config.actual_head_dim, config.rope_theta)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    mask = causal[None, None, :, :] & attention_mask[:, None, None, :]
    return _run_layers(config, params, x, cos, sin, mask, lora_scale=lora_scale,
                       remat=remat)


def _padded_hidden(params, config, query_responses, pad_token_id, lora_scale=1.0,
                   remat: bool = False):
    input_ids, attention_mask, position_ids = padding_inputs(
        query_responses, pad_token_id)
    return _hidden_from_inputs(params, config, input_ids, attention_mask,
                               position_ids, lora_scale, remat)


def padded_forward_logits(params, config, query_responses, pad_token_id,
                          lora_scale: float = 1.0,
                          response_context_length: int | None = None,
                          remat: bool = False):
    """Padding-robust forward → logits [B, T, V]. With
    `response_context_length=ctx`, next-token logits for the response
    positions only (hidden sliced [ctx-1:-1] before the head). `remat`
    checkpoints each layer (the training path)."""
    x = _padded_hidden(params, config, query_responses, pad_token_id, lora_scale,
                       remat)
    if response_context_length is not None:
        x = x[:, response_context_length - 1 : -1]
    return _logits(config, params, x)


def padded_forward_hidden(params, config, query_responses, pad_token_id,
                          lora_scale: float = 1.0,
                          response_context_length: int | None = None,
                          remat: bool = False):
    """`padded_forward_logits` minus the vocab projection: final-normed
    hidden states [B, T', D], the fused logprob op's input."""
    x = _padded_hidden(params, config, query_responses, pad_token_id, lora_scale,
                       remat)
    if response_context_length is not None:
        x = x[:, response_context_length - 1 : -1]
    return rms_norm(x, params["norm"], config.rms_norm_eps)


def init_score_head(config: ModelConfig, generator: torch.Generator,
                    num_labels: int = 1, dtype=torch.bfloat16) -> torch.Tensor:
    """Score head [D, num_labels] ~ N(0, 1/D): a value model is the decoder
    with this head in place of lm_head. Kept [D, num_labels], the JAX
    layout (`bridge.py` passes it through unchanged), drawn on the
    generator's device."""
    D = config.hidden_size
    w = torch.randn((D, num_labels), generator=generator, dtype=torch.float32,
                    device=generator.device) / math.sqrt(D)
    return w.to(dtype)


def score_forward(params, config, query_responses, pad_token_id,
                  lora_scale: float = 1.0, remat: bool = False) -> torch.Tensor:
    """Per-position scores [B, T, num_labels] f32 of a tree carrying
    "score": the final-normed hidden states of `_padded_hidden` (the flash
    route on the card) times the head, in f32. The head is a [D, 1]
    product, a plain matmul as in JAX."""
    x = _padded_hidden(params, config, query_responses, pad_token_id, lora_scale,
                       remat)
    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    return torch.matmul(x.float(), params["score"].float())


def _check_quant(config: ModelConfig) -> bool:
    if config.kv_cache_quant not in ("none", "int8"):
        raise ValueError(f"kv_cache_quant={config.kv_cache_quant!r}: must be "
                         "'none' or 'int8'")
    return config.kv_cache_quant == "int8"


def _cache_tuple(config, lead: tuple, dtype, device):
    """(k, v) [L, *lead, hd] of `dtype`, or the int8 4-tuple (k_q, k_s,
    v_q, v_s): int8 values [L, *lead, hd] and bf16 scales [L, *lead]
    (initialised to ones, as JAX does)."""
    shape = (config.num_hidden_layers, *lead, config.actual_head_dim)
    if _check_quant(config):
        def scales():
            return torch.ones(shape[:-1], dtype=torch.bfloat16, device=device)

        return (torch.zeros(shape, dtype=torch.int8, device=device), scales(),
                torch.zeros(shape, dtype=torch.int8, device=device), scales())
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache(config: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Stacked contiguous KV cache: (k, v), each [L, B, KV, max_len, hd];
    with `kv_cache_quant="int8"` (k_q, k_s, v_q, v_s): int8 [L, B, KV,
    max_len, hd] and bf16 scales [L, B, KV, max_len]."""
    return _cache_tuple(config, (batch, config.num_key_value_heads, max_len),
                        dtype, device)


def init_paged_kv_cache(config: ModelConfig, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, device="cuda"):
    """Paged KV cache: pools shared by every row, addressed through a block
    table [B, nb] that is NOT part of the tuple. Exact: (k, v) each
    [L, num_pages + 1, KV, page_size, hd]; int8: (k_q, k_s, v_q, v_s) with
    scale pools [L, num_pages + 1, KV, page_size]. The extra page at index
    num_pages is the scratch page that absorbs dropped writes (module
    docstring); `live_pages` is the readable part."""
    return _cache_tuple(
        config, (num_pages + 1, config.num_key_value_heads, page_size),
        dtype, device)


def prefill(params, config, input_ids, attention_mask, kv_caches,
            lora_scale: float = 1.0, page_table=None, page_size: int = 0,
            logical_len: int = 0):
    """Prompt ingestion (prompts left-padded): fills the KV cache slots
    [0, T) in place, returns (last-position logits [B, V], caches).
    `page_table` [B, nb] + `page_size` write through the table into a paged
    pool; `logical_len` is then the logical cache width T_max (the mask
    width, which the contiguous run takes from its cache)."""
    B, T = input_ids.shape
    paged = None
    if page_table is not None:
        T_max = logical_len or page_table.shape[1] * page_size
        paged = (page_table, page_size)
    else:
        T_max = kv_caches[0].shape[3]
    attention_mask = attention_mask.bool()
    m = attention_mask.to(torch.int64)
    position_ids = torch.cumsum(m, dim=1) - m
    x = params["embed_tokens"][torch.where(attention_mask, input_ids,
                                           torch.zeros_like(input_ids))]
    cos, sin = rope_tables(position_ids, config.actual_head_dim, config.rope_theta)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    mask = causal[None, None, :, :] & attention_mask[:, None, None, :]
    mask_full = torch.zeros((B, 1, T, T_max), dtype=torch.bool, device=x.device)
    mask_full[:, :, :, :T] = mask
    x = _run_layers(config, params, x, cos, sin, mask_full, kv_caches=kv_caches,
                    cache_index=0, lora_scale=lora_scale, paged=paged)
    logits = _logits(config, params, x[:, -1:, :])[:, 0, :]
    return logits, kv_caches


def decode_step(params, config, token, position, cache_index, key_mask,
                kv_caches, lora_scale: float = 1.0, page_table=None,
                page_size: int = 0):
    """One autoregressive decode step: token [B], position [B], the cache
    slot `cache_index` (an int or a one-element device tensor shared by
    every row, or a per-row [B] tensor — continuous-batching rows sit at
    different depths), key_mask [B, T_max] (valid slots incl. this one).
    `page_table` [B, nb] + `page_size`: the paged layout. Reads nothing
    back to the host, so the compiled decode loop (`sampler/graph.py`)
    captures it. Returns (logits [B, V], caches updated in place)."""
    B = token.shape[0]
    paged = (page_table, page_size) if page_table is not None else None
    x = params["embed_tokens"][token][:, None, :]
    cos, sin = rope_tables(position[:, None], config.actual_head_dim, config.rope_theta)
    mask = key_mask[:, None, None, :]
    # the valid slots form the contiguous range [start, cache_index + 1):
    # the bounds the prefix-reading decode kernels need
    start = key_mask.to(torch.uint8).argmax(dim=1).to(torch.int32)
    filled = (_row_index(cache_index, B, x.device) + 1).to(torch.int32)
    x = _run_layers(config, params, x, cos, sin, mask, kv_caches=kv_caches,
                    cache_index=cache_index, lora_scale=lora_scale,
                    decode_bounds=(start, filled), paged=paged)
    logits = _logits(config, params, x)[:, 0, :]
    return logits, kv_caches


def decode_verify(params, config, tokens, positions, fill, key_mask, kv_caches,
                  lora_scale: float = 1.0, page_table=None, page_size: int = 0,
                  want_logits: bool = True):
    """Batched k-token verification for speculative decode
    (`sampler/speculative.py`): one causal forward over Tq = k + 1
    candidates per row — tokens [B, Tq] at positions [B, Tq] — against the
    cache. The candidates' K/V are written in place at the per-row slots
    [fill, fill + Tq); query i attends to `key_mask` [B, T_max] (the valid
    slots BEFORE this call) plus candidates 0..i. Rejected candidates leave
    K/V in slots the caller never marks valid; the next verify overwrites
    them. On the paged layout a write past the row's table lands on the
    scratch page (JAX drops it). Returns (logits [B, Tq, V], caches):
    logits[:, i] is the next-token distribution after candidates 0..i, or
    None with `want_logits=False` (the writes only)."""
    B, Tq = tokens.shape
    T_max = key_mask.shape[1]
    paged = (page_table, page_size) if page_table is not None else None
    key_mask = key_mask.bool()
    x = params["embed_tokens"][tokens]
    cos, sin = rope_tables(positions, config.actual_head_dim, config.rope_theta)
    fill = torch.as_tensor(fill, device=x.device).to(torch.int64)
    slot = torch.arange(T_max, device=x.device)[None, None, :]
    qi = torch.arange(Tq, device=x.device)[None, :, None]
    cand = (slot >= fill[:, None, None]) & (slot <= fill[:, None, None] + qi)
    mask = (key_mask[:, None, :] | cand)[:, None, :, :]    # [B, 1, Tq, T_max]
    # the kernels read [start, fill + qi + 1): a row with no valid slot
    # before this call (a cold suffix prefill, a first prefill chunk) starts
    # at its candidates. JAX's argmax alone gives 0 there, where the plain
    # masked route still sees only the candidates but a kernel would read
    # the row's pad slots
    start = torch.where(key_mask.any(dim=1),
                        key_mask.to(torch.uint8).argmax(dim=1),
                        fill).to(torch.int32)
    x = _run_layers(config, params, x, cos, sin, mask, kv_caches=kv_caches,
                    cache_index=fill, lora_scale=lora_scale,
                    verify_bounds=(start, fill.to(torch.int32)), paged=paged)
    if not want_logits:
        return None, kv_caches
    return _logits(config, params, x), kv_caches
