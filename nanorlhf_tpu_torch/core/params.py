"""HF checkpoint ⇄ the port's stacked parameter tree — the port of
`nanorlhf_tpu/core/params.py`.

The port keeps HF's own `nn.Linear` layout, `[out, in]`, stacked on a
leading `[L, ...]` axis (`bridge.py`), so loading is a stack with no
transpose; `lm_head` stays `[V, D]` and exists only when the weights are
untied. Each stacked leaf is allocated on the target device and filled one
layer slice at a time from the reader's memory-mapped views, so no host copy
of the whole model is made (a 1.5B model in f32 would be 6 GB of host
memory). Bias presence is read off the state dict: Qwen2 q/k/v carry biases,
Llama none.

The export writes the inverse state dict, bf16 or f32 per leaf, with the
`config.json` / `generation_config.json` contract of the JAX exporter.
"""

from __future__ import annotations

import json
import os

import torch

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.core.lora import merge_lora
from nanorlhf_tpu_torch.core.safetensors_io import read_state_dict, write_safetensors

_LINEAR_KEYS = (
    ("q_proj", "self_attn.q_proj"),
    ("k_proj", "self_attn.k_proj"),
    ("v_proj", "self_attn.v_proj"),
    ("o_proj", "self_attn.o_proj"),
    ("gate_proj", "mlp.gate_proj"),
    ("up_proj", "mlp.up_proj"),
    ("down_proj", "mlp.down_proj"),
)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@torch.no_grad()
def params_from_hf_state_dict(config: ModelConfig, state_dict: dict,
                              dtype=torch.bfloat16, device="cuda") -> dict:
    """An HF Qwen2/Llama state dict (name → tensor, any device) → the port's
    tree on `device` in `dtype`, each stacked leaf filled layer by layer."""
    L = config.num_hidden_layers

    def leaf(name):
        return state_dict[name].to(device=device, dtype=dtype).contiguous()

    def stacked(fmt):
        first = state_dict[fmt.format(0)]
        out = torch.empty((L, *first.shape), dtype=dtype, device=device)
        for i in range(L):
            out[i].copy_(state_dict[fmt.format(i)])
        return out

    layers: dict = {
        "input_layernorm": stacked("model.layers.{}.input_layernorm.weight"),
        "post_attention_layernorm": stacked(
            "model.layers.{}.post_attention_layernorm.weight"),
    }
    for ours, theirs in _LINEAR_KEYS:
        entry = {"kernel": stacked(f"model.layers.{{}}.{theirs}.weight")}
        if f"model.layers.0.{theirs}.bias" in state_dict:
            entry["bias"] = stacked(f"model.layers.{{}}.{theirs}.bias")
        layers[ours] = entry
    params = {"embed_tokens": leaf("model.embed_tokens.weight"), "layers": layers,
              "norm": leaf("model.norm.weight")}
    if not config.tie_word_embeddings:
        # some HF checkpoints omit lm_head when tied; require it when untied
        params["lm_head"] = leaf("lm_head.weight")
    return params


def hf_state_dict_from_params(config: ModelConfig, params: dict,
                              dtype=torch.float32) -> dict:
    """Inverse of `params_from_hf_state_dict`: the flat HF state dict, each
    tensor cast to `dtype` on the params' device when it is written
    (views where no cast is needed). LoRA is not folded here: pass a
    `merge_lora`'d tree."""
    layers = params["layers"]
    sd: dict = {}

    def put(name, t):
        sd[name] = t.detach().to(dtype)

    for i in range(config.num_hidden_layers):
        put(f"model.layers.{i}.input_layernorm.weight", layers["input_layernorm"][i])
        put(f"model.layers.{i}.post_attention_layernorm.weight",
            layers["post_attention_layernorm"][i])
        for ours, theirs in _LINEAR_KEYS:
            put(f"model.layers.{i}.{theirs}.weight", layers[ours]["kernel"][i])
            if "bias" in layers[ours]:
                put(f"model.layers.{i}.{theirs}.bias", layers[ours]["bias"][i])
    put("model.embed_tokens.weight", params["embed_tokens"])
    put("model.norm.weight", params["norm"])
    if not config.tie_word_embeddings:
        put("lm_head.weight", params["lm_head"])
    return sd


def write_hf_config(config: ModelConfig, out_dir: str, dtype: str = "bfloat16",
                    eos_token_id: int | None = None, bos_token_id: int | None = None,
                    pad_token_id: int | None = None) -> None:
    """`config.json` and `generation_config.json`, as the JAX exporter
    writes them. The family is echoed only for the two families this
    exporter emits faithfully (an unknown slug would make transformers apply
    that family's defaults to keys never written); otherwise, and for
    random-init configs, it follows `attention_bias`."""
    family = config.model_type if config.model_type in ("qwen2", "llama") \
        else ("qwen2" if config.attention_bias else "llama")
    arch = {"qwen2": "Qwen2ForCausalLM", "llama": "LlamaForCausalLM"}[family]
    hf_config = {
        "architectures": [arch],
        "model_type": family,
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "num_key_value_heads": config.num_key_value_heads,
        "head_dim": config.actual_head_dim,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps,
        "tie_word_embeddings": config.tie_word_embeddings,
        "max_position_embeddings": config.max_position_embeddings,
        "attention_bias": config.attention_bias,
        "hidden_act": "silu",
        "torch_dtype": dtype,
    }
    gen_config = {"_from_model_config": True}
    for key, val in (("eos_token_id", eos_token_id), ("bos_token_id", bos_token_id),
                     ("pad_token_id", pad_token_id)):
        if val is not None:
            hf_config[key] = int(val)
            gen_config[key] = int(val)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    with open(os.path.join(out_dir, "generation_config.json"), "w") as f:
        json.dump(gen_config, f, indent=2)


def export_hf_checkpoint(config: ModelConfig, params: dict, out_dir: str,
                         lora_scale: float | None = None, dtype: str = "bfloat16",
                         tokenizer=None, eos_token_id: int | None = None,
                         bos_token_id: int | None = None,
                         pad_token_id: int | None = None) -> str:
    """Write an HF checkpoint directory (`config.json`,
    `generation_config.json`, `model.safetensors`) that transformers and
    `load_hf_checkpoint` accept. `lora_scale` folds a `params["lora"]`
    subtree into the base kernels first. A `tokenizer` with
    `save_pretrained` is saved beside the weights, and its eos/bos/pad ids
    fill the ones not given."""
    if lora_scale is not None and "lora" in params:
        params = merge_lora(params, lora_scale)
    params = {k: v for k, v in params.items() if k != "lora"}
    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"),
                      hf_state_dict_from_params(config, params, _DTYPES[dtype]))
    if tokenizer is not None:
        if eos_token_id is None:
            eos_token_id = getattr(tokenizer, "eos_token_id", None)
        if bos_token_id is None:
            bos_token_id = getattr(tokenizer, "bos_token_id", None)
        if pad_token_id is None:
            pad_token_id = getattr(tokenizer, "pad_token_id", None)
        if hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(out_dir)
    write_hf_config(config, out_dir, dtype, eos_token_id, bos_token_id, pad_token_id)
    return out_dir


def load_hf_checkpoint(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """(ModelConfig, params on `device`) of an HF model directory:
    `config.json` and every `*.safetensors` file in sorted order, else
    `pytorch_model.bin`."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = ModelConfig.from_hf_config(json.load(f))
    return config, params_from_hf_state_dict(config, read_state_dict(model_dir),
                                             dtype, device)
