"""Shared launcher plumbing — the port of `nanorlhf_tpu/entrypoints/common.py`
(the offline branches: random-init demo model, toy tokenizer, synthetic
prompts, the rule-based stand-in reward).

`run` is the counterpart of the JAX `run`: it builds model, data, reward
and `RLTrainer` from a launcher config and trains. `run_rollout` builds the
same pieces and runs only the rollout-and-score half of one update. Both
run on `cuda` unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.core.model import init_params
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.rewards.builders import make_rule_reward
from nanorlhf_tpu_torch.trainer.bucketing import shape_menu
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM,
    rollout_and_score,
    rollout_generator,
    stream_generator,
)
from nanorlhf_tpu_torch.trainer.trainer import RLTrainer, build_policy


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


def _device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device='cuda' but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def _resolve_all(cfg: RLConfig, device):
    """(mcfg, params, tokenizer, dataset, reward_func) of a launcher config."""
    mcfg, params, tokenizer = resolve_model(
        cfg.sft_model_path, cfg.seed, attention_impl=cfg.attention_impl,
        device=device)
    return (mcfg, params, tokenizer, resolve_dataset(cfg, tokenizer),
            resolve_rm_reward(cfg.reward_model_path))


def build_trainer(cfg: RLConfig, *, device="cuda") -> RLTrainer:
    """Model, data, reward and the `RLTrainer` over them, on `device`."""
    mcfg, params, tokenizer, dataset, reward_func = _resolve_all(
        cfg, _device(device, "build_trainer"))
    return RLTrainer(cfg, mcfg, tokenizer, params, dataset, reward_func)


def run(cfg: RLConfig, *, device="cuda", num_updates: int | None = None) -> dict:
    """Build everything and train — the tail of every launcher. Returns the
    trainer state ({episode, global_step, opt_steps, rollouts})."""
    trainer = build_trainer(cfg, device=device)
    try:
        return trainer.train(num_updates)
    finally:
        trainer.close()


def run_rollout(cfg: RLConfig, *, device="cuda", num_prompts: int | None = None,
                rollout_index: int = 0, timings: dict | None = None) -> dict:
    """Build model, data and reward from `cfg` and run one rollout-and-score
    (`trainer/rollout.py`) on `num_prompts` prompts (default: the config's
    batch size). Returns the rollout dict plus `mcfg` and `params`."""
    device = _device(device, "run_rollout")
    if cfg.batch_size == 0:
        cfg.finalize(1)
    mcfg, params, tokenizer, dataset, reward_func = _resolve_all(cfg, device)
    policy, ref, _, lora_scale = build_policy(cfg, mcfg, params)
    kl_free = not (cfg.score_ref_logprobs if cfg.score_ref_logprobs is not None
                   else cfg.kl_coef != 0.0)
    batch = num_prompts or cfg.batch_size
    queries = next(dataset.loader(batch, cfg.seed))
    out = rollout_and_score(
        policy, None if kl_free else ref, mcfg, cfg, tokenizer, queries,
        reward_func, rollout_generator(cfg.seed, rollout_index, device),
        lora_scale, stream_generator(cfg.seed, KEEP_STREAM, rollout_index),
        ctx_menu=shape_menu(dataset.input_ids.shape[1], min_value=16),
        timings=timings)
    out.update(mcfg=mcfg, params=policy, ref_params=ref, tokenizer=tokenizer,
               lora_scale=lora_scale)
    return out
