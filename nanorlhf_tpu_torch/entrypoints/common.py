"""Shared launcher plumbing — the port of `nanorlhf_tpu/entrypoints/common.py`:
an HF checkpoint directory when one is on disk (its weights, its
tokenizer), the HF dataset when it loads, the torch RM when its directory
exists; otherwise the offline demo's random-init model, toy tokenizer,
synthetic prompts and rule-based stand-in reward. These are JAX's own
host-side fallbacks; none of them stands in for the card or a kernel.

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
from nanorlhf_tpu_torch.core.params import load_hf_checkpoint
from nanorlhf_tpu_torch.core.quant import quantize_layers, rollout_view
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer, load_tokenizer
from nanorlhf_tpu_torch.parallel.distributed import initialize_multihost, rank_device
from nanorlhf_tpu_torch.rewards.builders import make_rule_reward, make_torch_rm_reward
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
    """(ModelConfig, params on `device`, tokenizer): an HF checkpoint
    directory is loaded (weights and tokenizer); any other path gives the
    offline demo model — random-init weights in the geometry the path names
    (1.5B-shaped unless it says 'tiny'; Llama family when it says 'llama')
    and the toy tokenizer."""
    if sft_model_path and os.path.isdir(sft_model_path):
        config, params = load_hf_checkpoint(sft_model_path, dtype, device)
        tokenizer = load_tokenizer(sft_model_path)
    else:
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
    """The configured dataset when it loads (the local HF cache or a local
    directory; `dataset_cache_dir` turns on the token cache); the synthetic
    corpus otherwise."""
    name = cfg.train_dataset_name
    try:
        return load_prompt_dataset(name, tokenizer, split=cfg.train_dataset_split,
                                   max_prompt_len=max_prompt_len,
                                   cache_dir=cfg.dataset_cache_dir)
    except Exception as e:  # no local copy, no `datasets`: the offline demo
        print(f"[offline demo] dataset '{name}' unavailable ({type(e).__name__}) — "
              "synthetic prompts")
        return load_prompt_dataset("synthetic:512", tokenizer,
                                   max_prompt_len=max_prompt_len)


def resolve_rm_reward(reward_model_path: str, batch_size: int = 16, device="cuda"):
    """The torch RM on `device` (the trainer's: the card unless `--device
    cpu`) when its directory exists (the reference's deberta path);
    otherwise a rule-based stand-in so the loop still runs offline."""
    if reward_model_path and os.path.isdir(reward_model_path):
        return make_torch_rm_reward(reward_model_path, batch_size, device=device)
    print(f"[offline demo] reward model '{reward_model_path}' not found — "
          "rule-based stand-in reward")

    def fn(s: str, eos_token: str) -> float:
        has_eos = 1.0 if eos_token in s else 0.0
        words = s.split()
        return has_eos + 0.05 * min(len(set(words)) / max(len(words), 1), 1.0)

    return make_rule_reward(fn)


def device_arg(what: str) -> str:
    """The `--device` of a launcher's command line: cuda unless it says
    cpu."""
    import argparse

    ap = argparse.ArgumentParser(description=what)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args().device


def _device(device, who: str) -> torch.device:
    """The device to build on. Under `torchrun --nproc-per-node N` (a world
    of N: the config's mesh, data = N by default) the process group comes up here
    (`parallel.distributed.initialize_multihost`: NCCL where each rank owns
    a card, gloo where they share one or on the CPU) and each rank takes
    its card; a world of 1 changes nothing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device='cuda' but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    initialize_multihost(device=device)
    return rank_device(device)


def _resolve_all(cfg: RLConfig, device):
    """(mcfg, params, tokenizer, dataset, reward_func) of a launcher config."""
    mcfg, params, tokenizer = resolve_model(
        cfg.sft_model_path, cfg.seed, attention_impl=cfg.attention_impl,
        device=device)
    return (mcfg, params, tokenizer, resolve_dataset(cfg, tokenizer),
            resolve_rm_reward(cfg.reward_model_path, device=device))


def build_trainer(cfg: RLConfig, *, device="cuda", value_params_fn=None,
                  post_build=None) -> RLTrainer:
    """Model, data, reward and the `RLTrainer` over them, on `device`.
    `value_params_fn(mcfg, params) -> tree` builds the value model from the
    freshly resolved policy (PPO); `post_build(trainer, dataset,
    reward_func)` runs once the trainer is built (PPO's value
    initializer)."""
    mcfg, params, tokenizer, dataset, reward_func = _resolve_all(
        cfg, _device(device, "build_trainer"))
    value_params = value_params_fn(mcfg, params) if value_params_fn else None
    trainer = RLTrainer(cfg, mcfg, tokenizer, params, dataset, reward_func,
                        value_params=value_params)
    if post_build is not None:
        post_build(trainer, dataset, reward_func)
    return trainer


def run(cfg: RLConfig, *, device="cuda", num_updates: int | None = None,
        value_params_fn=None, post_build=None) -> dict:
    """Build everything and train — the tail of every launcher (the hooks
    as `build_trainer`'s). Returns the trainer state ({episode,
    global_step, opt_steps, rollouts})."""
    trainer = build_trainer(cfg, device=device, value_params_fn=value_params_fn,
                            post_build=post_build)
    try:
        return trainer.train(num_updates)
    finally:
        trainer.close()


def run_rollout(cfg: RLConfig, *, device="cuda", num_prompts: int | None = None,
                rollout_index: int = 0, timings: dict | None = None) -> dict:
    """Build model, data and reward from `cfg` and run one rollout-and-score
    (`trainer/rollout.py`) on `num_prompts` prompts (default: the config's
    batch size). Returns the rollout dict plus `mcfg`, `params` and the
    int8 view generation sampled from (`rollout_params`, None unless
    `rollout_quant="int8"`)."""
    device = _device(device, "run_rollout")
    if cfg.batch_size == 0:
        cfg.finalize(1)
    mcfg, params, tokenizer, dataset, reward_func = _resolve_all(cfg, device)
    policy, ref, _, lora_scale = build_policy(cfg, mcfg, params)
    kl_free = not (cfg.score_ref_logprobs if cfg.score_ref_logprobs is not None
                   else cfg.kl_coef != 0.0)
    batch = num_prompts or cfg.batch_size
    queries = next(dataset.loader(batch, cfg.seed))
    rollout_params = None
    if cfg.rollout_quant == "int8":
        rollout_params = rollout_view(policy, quantize_layers(policy["layers"]))
    out = rollout_and_score(
        policy, None if kl_free else ref, mcfg, cfg, tokenizer, queries,
        reward_func, rollout_generator(cfg.seed, rollout_index, device),
        lora_scale, stream_generator(cfg.seed, KEEP_STREAM, rollout_index),
        ctx_menu=shape_menu(dataset.input_ids.shape[1], min_value=16),
        timings=timings, rollout_params=rollout_params)
    out.update(mcfg=mcfg, params=policy, ref_params=ref, tokenizer=tokenizer,
               lora_scale=lora_scale, rollout_params=rollout_params)
    return out
