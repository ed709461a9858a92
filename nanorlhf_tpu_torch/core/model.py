"""Qwen2-family decoder over a stacked-layer parameter dict — the port of
`nanorlhf_tpu/core/model.py` (contiguous KV cache; no paged layout, no
speculative verify, no int8 weights or cache yet).

Parameters keep the JAX tree's names and its stacked `[L, ...]` layout, in
torch's nn.Linear orientation: every projection `kernel` is `[L, out, in]`
(`F.linear(x, W)`), `lm_head` is `[V, D]`, LoRA `a`/`b` are `[L, r, in]` /
`[L, out, r]`. `bridge.py` converts a JAX tree (kernels `[in, out]`) both
ways. bf16 weights, f32 softmax / norm statistics / rotary tables, as in
JAX.

Attention routing (`ModelConfig.attention_impl`): "xla" is the plain
masked einsum path everywhere; "pallas" sends prefill/scoring to the flash
kernel and single-token decode to the prefix-bounded decode kernel; "auto"
does the same for CUDA tensors and takes the plain path for CPU tensors.

Unlike JAX's functional cache, `prefill`/`decode_step` write the KV cache
IN PLACE (saving a [L, B, KV, T_max, hd] copy per step) and return the same
tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.ops.attention import flash_attention
from nanorlhf_tpu_torch.ops.decode_attention import decode_attention

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
    """x @ Wᵀ (+ bias) (+ LoRA ((x @ Aᵀ) @ Bᵀ) · scale)."""
    p = layer[name]
    if "kernel_q" in p:
        raise NotImplementedError(
            "int8 weight-only projections (kernel_q) are not ported yet")
    y = F.linear(h, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    if lora_layer is not None and name in lora_layer:
        ab = lora_layer[name]
        y = y + F.linear(F.linear(h, ab["a"]), ab["b"]) * lora_scale
    return y


def _cache_update(cache, new, idx: int):
    """Write `new` [B, KV, T, hd] into `cache` [B, KV, T_max, hd] at slot
    `idx`, in place."""
    cache[:, :, idx:idx + new.shape[2]] = new
    return cache


def _layer_body(config: ModelConfig, x, layer, cos, sin, mask, kv_cache,
                cache_index, lora_layer=None, lora_scale=1.0,
                decode_bounds=None):
    """One decoder layer. kv_cache: (k, v) each [B, KV, T_max, hd] or None.
    Returns the layer output (the cache is updated in place)."""
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
        k_cache, v_cache = kv_cache
        _cache_update(k_cache, k, cache_index)
        _cache_update(v_cache, v, cache_index)
        if T > 1 and use_kernel(impl, q):
            # prefill: slots beyond T are masked anyway, so attend over the
            # local K/V through the flash kernel
            out = gqa_attention(q, k, v, mask[..., :T], impl="pallas",
                                mask_is_causal_x_keyvalid=True)
        elif T == 1 and decode_bounds is not None and use_kernel(impl, q):
            # decode: the kernel reads only the filled cache range
            out = decode_attention(q[:, :, 0, :].contiguous(), k_cache, v_cache,
                                   *decode_bounds)[:, :, None, :]
        else:
            out = gqa_attention(q, k_cache, v_cache, mask)
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


def _run_layers(config, params, x, cos, sin, mask, kv_caches=None,
                cache_index=0, lora_scale=1.0, decode_bounds=None,
                remat: bool = False):
    """Run the stacked layers in order. kv_caches: (k, v) each
    [L, B, KV, T_max, hd] (updated in place) or None.

    `remat=True` (the training path, `gradient_checkpointing`) checkpoints
    each layer: only its input is kept for the backward, which re-runs the
    layer's forward (`torch.utils.checkpoint`, non-reentrant) — the
    counterpart of JAX's `jax.checkpoint` around the scan body with
    `remat_policy="full"`. It changes memory, not values."""
    if remat:
        if config.remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' (keep the weight-projection outputs) is "
                "not ported yet: use remat_policy='full'")
        if config.remat_policy != "full":
            raise ValueError(f"remat_policy={config.remat_policy!r}: must be "
                             "'full' or 'dots'")
    layers = _unstack(params["layers"])
    lora = params.get("lora")
    lora_layers = _unstack(lora["layers"]) if lora else [None] * len(layers)
    for i, (layer, lora_layer) in enumerate(zip(layers, lora_layers)):
        kv = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        if remat and kv is None:
            x = checkpoint(_layer_body, config, x, layer, cos, sin, mask, None,
                           cache_index, lora_layer, lora_scale,
                           use_reentrant=False)
        else:
            x = _layer_body(config, x, layer, cos, sin, mask, kv, cache_index,
                            lora_layer, lora_scale, decode_bounds=decode_bounds)
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


def init_kv_cache(config: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Stacked contiguous KV cache: (k, v), each [L, B, KV, max_len, hd]."""
    if config.kv_cache_quant != "none":
        raise NotImplementedError(
            f"kv_cache_quant={config.kv_cache_quant!r}: the int8 KV cache "
            "(and its q8 decode kernels) is not ported yet")
    shape = (config.num_hidden_layers, batch, config.num_key_value_heads,
             max_len, config.actual_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill(params, config, input_ids, attention_mask, kv_caches,
            lora_scale: float = 1.0):
    """Prompt ingestion (prompts left-padded): fills the KV cache slots
    [0, T) in place, returns (last-position logits [B, V], caches)."""
    B, T = input_ids.shape
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
                    cache_index=0, lora_scale=lora_scale)
    logits = _logits(config, params, x[:, -1:, :])[:, 0, :]
    return logits, kv_caches


def decode_step(params, config, token, position, cache_index: int, key_mask,
                kv_caches, lora_scale: float = 1.0):
    """One autoregressive decode step: token [B], position [B], the shared
    cache slot `cache_index`, key_mask [B, T_max] (valid slots incl. this
    one). Returns (logits [B, V], caches updated in place)."""
    B = token.shape[0]
    x = params["embed_tokens"][token][:, None, :]
    cos, sin = rope_tables(position[:, None], config.actual_head_dim, config.rope_theta)
    mask = key_mask[:, None, None, :]
    # the valid slots form the contiguous range [start, cache_index + 1):
    # the bounds the prefix-reading decode kernel needs
    start = key_mask.to(torch.uint8).argmax(dim=1).to(torch.int32)
    filled = torch.full((B,), cache_index + 1, dtype=torch.int32, device=x.device)
    x = _run_layers(config, params, x, cos, sin, mask, kv_caches=kv_caches,
                    cache_index=cache_index, lora_scale=lora_scale,
                    decode_bounds=(start, filled))
    logits = _logits(config, params, x)[:, 0, :]
    return logits, kv_caches
