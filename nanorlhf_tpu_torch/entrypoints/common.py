"""Shared launcher plumbing — the port of `nanorlhf_tpu/entrypoints/common.py`
(the offline branches: random-init demo model, toy tokenizer, synthetic
prompts, the rule-based stand-in reward).

`run_rollout` is this slice's counterpart of the JAX `run`: it builds
everything from a launcher config and runs the rollout-and-score half of
one GRPO update (the training half comes with the next slice). It runs on
`cuda` unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.core.lora import LoraConfig, init_lora_params
from nanorlhf_tpu_torch.core.model import init_params
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.rewards.builders import make_rule_reward
from nanorlhf_tpu_torch.trainer.bucketing import shape_menu
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.rollout import rollout_and_score, rollout_generator

# seed stream of the LoRA init (the JAX trainer splits its key for it)
_LORA_STREAM = 0x10AA


def resolve_model(sft_model_path: str, seed: int = 0, attention_impl: str = "auto",
                  device="cuda", dtype=torch.bfloat16):
    """(ModelConfig, params, tokenizer): the offline demo model — random-init
    weights in the geometry the path names (1.5B-shaped unless it says
    'tiny'; Llama family when it says 'llama') and the toy tokenizer.
    Loading an HF checkpoint directory comes with a later slice."""
    if sft_model_path and os.path.isdir(sft_model_path):
        raise NotImplementedError(
            f"'{sft_model_path}' is a checkpoint directory: HF weight loading "
            "(core/params.py) is not ported to nanorlhf_tpu_torch yet")
    print(f"[offline demo] '{sft_model_path}' not found locally — "
          "random-init model + toy tokenizer")
    path = (sft_model_path or "").lower()
    llama = "llama" in path
    if "tiny" in path:
        config = ModelConfig.qwen2_tiny(vocab_size=4096)
        if llama:
            config = dataclasses.replace(config, attention_bias=False,
                                         rope_theta=500_000.0)
    elif llama:
        config = ModelConfig.llama3_2_1b()
    else:
        config = ModelConfig.qwen2_1_5b()
    tokenizer = ToyTokenizer(vocab_size=min(4096, config.vocab_size))
    params = init_params(config, seed, dtype, device)
    if attention_impl != config.attention_impl:
        config = dataclasses.replace(config, attention_impl=attention_impl)
    return config, params, tokenizer


def resolve_dataset(cfg: RLConfig, tokenizer, max_prompt_len: int = 256):
    """The synthetic corpus (the HF loader is not ported yet)."""
    if not cfg.train_dataset_name.startswith("synthetic"):
        print(f"[offline demo] dataset '{cfg.train_dataset_name}' unavailable "
              "(not ported) — synthetic prompts")
    name = (cfg.train_dataset_name if cfg.train_dataset_name.startswith("synthetic")
            else "synthetic:512")
    return load_prompt_dataset(name, tokenizer, max_prompt_len=max_prompt_len)


def resolve_rm_reward(reward_model_path: str, batch_size: int = 16):
    """The rule-based stand-in reward (the torch RM needs its checkpoint)."""
    if reward_model_path and os.path.isdir(reward_model_path):
        raise NotImplementedError(
            "the host-side torch reward model is not ported to "
            "nanorlhf_tpu_torch yet")
    print(f"[offline demo] reward model '{reward_model_path}' not found — "
          "rule-based stand-in reward")

    def fn(s: str, eos_token: str) -> float:
        has_eos = 1.0 if eos_token in s else 0.0
        words = s.split()
        return has_eos + 0.05 * min(len(set(words)) / max(len(words), 1), 1.0)

    return make_rule_reward(fn)


def build_policy(cfg: RLConfig, mcfg: ModelConfig, params: dict, device):
    """(policy params with a fresh LoRA subtree, ref params, lora_scale):
    the trainer's LoRA/ref setup. The ref tree shares the frozen base
    tensors (nothing trains in this slice, so no copy is needed)."""
    if not cfg.use_lora:
        return params, dict(params), 1.0
    lora = LoraConfig(r=cfg.lora_r, alpha=cfg.lora_alpha)
    seed = np.random.SeedSequence([cfg.seed, _LORA_STREAM]).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    policy = {**params, "lora": init_lora_params(
        mcfg, lora, gen, dtype=params["embed_tokens"].dtype, device=device)}
    return policy, dict(params), lora.scale


def run_rollout(cfg: RLConfig, *, device="cuda", num_prompts: int | None = None,
                rollout_index: int = 0, timings: dict | None = None) -> dict:
    """Build model, data and reward from `cfg` and run one rollout-and-score
    (`trainer/rollout.py`) on `num_prompts` prompts (default: the config's
    batch size). Returns the rollout dict plus `mcfg` and `params`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_rollout: device='cuda' but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    if cfg.batch_size == 0:
        cfg.finalize(1)
    mcfg, params, tokenizer = resolve_model(
        cfg.sft_model_path, cfg.seed, attention_impl=cfg.attention_impl,
        device=device)
    dataset = resolve_dataset(cfg, tokenizer)
    reward_func = resolve_rm_reward(cfg.reward_model_path)
    policy, ref, lora_scale = build_policy(cfg, mcfg, params, device)
    kl_free = not (cfg.score_ref_logprobs if cfg.score_ref_logprobs is not None
                   else cfg.kl_coef != 0.0)
    batch = num_prompts or cfg.batch_size
    queries = next(dataset.loader(batch, cfg.seed))
    out = rollout_and_score(
        policy, None if kl_free else ref, mcfg, cfg, tokenizer, queries,
        reward_func, rollout_generator(cfg.seed, rollout_index, device),
        lora_scale, ctx_menu=shape_menu(dataset.input_ids.shape[1], min_value=16),
        timings=timings)
    out.update(mcfg=mcfg, params=policy, ref_params=ref, tokenizer=tokenizer,
               lora_scale=lora_scale)
    return out
