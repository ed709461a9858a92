"""LoRA adapters applied in-graph — the port of `nanorlhf_tpu/core/lora.py`.

Layout mirrors the stacked layer tree in torch's nn.Linear orientation:
`lora["layers"][proj] = {"a": [L, r, in], "b": [L, out, r]}` (the JAX tree
holds `a: [L, in, r]`, `b: [L, r, out]`; `bridge.py` transposes). The
contribution is `(x @ Aᵀ) @ Bᵀ · (alpha / r)`; B starts at zero, so step 0
is exactly the base model.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nanorlhf_tpu_torch.core.config import ModelConfig

ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: int = 16
    targets: tuple[str, ...] = ALL_TARGETS
    train_embed: bool = True
    train_lm_head: bool = True

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _proj_dims(config: ModelConfig, name: str) -> tuple[int, int]:
    hd = config.actual_head_dim
    D, F = config.hidden_size, config.intermediate_size
    H, KV = config.num_attention_heads, config.num_key_value_heads
    return {
        "q_proj": (D, H * hd),
        "k_proj": (D, KV * hd),
        "v_proj": (D, KV * hd),
        "o_proj": (H * hd, D),
        "gate_proj": (D, F),
        "up_proj": (D, F),
        "down_proj": (F, D),
    }[name]


def init_lora_params(config: ModelConfig, lora: LoraConfig,
                     generator: torch.Generator, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    """A ~ N(0, 1/r), B = 0 → the adapter starts as the identity."""
    L = config.num_hidden_layers
    layers = {}
    for name in lora.targets:
        d_in, d_out = _proj_dims(config, name)
        a = torch.randn((L, lora.r, d_in), generator=generator,
                        dtype=torch.float32, device=device) / math.sqrt(lora.r)
        layers[name] = {
            "a": a.to(dtype),
            "b": torch.zeros((L, d_out, lora.r), dtype=dtype, device=device),
        }
    return {"layers": layers}


@torch.no_grad()
def merge_lora(params: dict, lora_scale: float) -> dict:
    """Fold the adapter into the base kernels (checkpoint export only): each
    kernel [L, out, in] gains `lora_scale · B·A`, computed in f32 and cast
    back to the kernel's dtype, one layer at a time. Returns a new tree
    without "lora"; the leaves it does not change are shared."""
    if "lora" not in params:
        return params
    merged = {k: v for k, v in params.items() if k != "lora"}
    layers = dict(params["layers"])
    for name, ab in params["lora"]["layers"].items():
        kernel = layers[name]["kernel"]
        out = torch.empty_like(kernel)
        for i in range(kernel.shape[0]):
            delta = torch.matmul(ab["b"][i].float(), ab["a"][i].float())
            out[i] = kernel[i].float() + lora_scale * delta
        layers[name] = {**layers[name], "kernel": out}
    merged["layers"] = layers
    return merged


def trainable_mask(params: dict, lora: LoraConfig | None) -> dict:
    """Nested bool dict: which leaves the optimizer updates (the JAX
    `trainable_mask`). Full fine-tuning (lora=None): everything. LoRA: the
    adapter leaves plus, as PEFT's `modules_to_save`, `embed_tokens` /
    `lm_head` when `train_embed` / `train_lm_head`."""

    def walk(tree, top):
        if isinstance(tree, dict):
            return {k: walk(v, top if top is not None else k)
                    for k, v in tree.items()}
        if lora is None or top == "lora":
            return True
        if top == "embed_tokens":
            return lora.train_embed
        if top == "lm_head":
            return lora.train_lm_head
        return False

    return walk(params, None)


def value_trainable_mask(value_params: dict, lora: LoraConfig | None) -> dict:
    """`trainable_mask` of a value tree: under LoRA the score head trains
    too (the reference's `value_modules_to_save`), beside the adapters and
    the embeddings."""
    mask = trainable_mask(value_params, lora)
    if lora is not None:
        mask["score"] = True
    return mask
