"""The port's RL loop optimizes: `tests/test_learning.py`'s learnable task
on the port. The same tiny f32 model (the JAX package's init at
PRNGKey(0), bridged), tokenizer, dataset, reward, config and bar: over 12
GRPO updates the mean reward of the last 3 must beat the mean of the first
2 by 0.2. The trainer is built through the launcher's
`common.build_trainer(..., device="cpu")`, its model/data/reward
resolution pointed at those pieces. The JAX test's batch of 16 prompts an
update comes from 8 devices × 1 × 2 minibatches; on one device it is
per_device_train_batch_size=8 × 2 minibatches."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import closes_trainers, port_config  # noqa: F401 (autouse)
from nanorlhf_tpu.core import ModelConfig as JaxModelConfig
from nanorlhf_tpu.core import init_params as jax_init_params
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig

torch.set_num_threads(1)


def reward(pmt_and_responses, eos_token):
    """The fraction of the response taken by its most frequent token
    (`tests/test_learning.py`'s dense, learnable reward)."""
    out = []
    for s in pmt_and_responses:
        words = s.split("<assistant>")[-1].split()
        if not words:
            out.append(0.0)
            continue
        _, top = max(((w, words.count(w)) for w in set(words)), key=lambda kv: kv[1])
        out.append(top / len(words))
    return np.asarray(out, np.float32)


def test_grpo_reward_improves(tmp_path, monkeypatch):
    jcfg = JaxModelConfig.qwen2_tiny(vocab_size=128)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                    jnp.float32))
    params = params_from_numpy(tree, "cpu", torch.float32)
    tok = ToyTokenizer(128)
    dataset = load_prompt_dataset("synthetic:64", tok, max_prompt_len=10)
    monkeypatch.setattr(common, "_resolve_all", lambda cfg, device: (
        port_config(jcfg), params, tok, dataset, reward))
    cfg = RLConfig(
        algo=AlgoName.GRPO,
        output_dir=str(tmp_path / "learn"),
        response_length=8,
        temperature=1.0,
        sample_n=4,
        kl_coef=0.0,                 # pure reward maximization
        total_episodes=12 * 16,      # 12 updates × batch 16
        per_device_train_batch_size=8,
        gradient_accumulation_steps=1,
        num_mini_batches=2,
        num_ppo_epochs=1,
        learning_rate=5e-2,          # aggressive: tiny fp32 model, 24 steps
        logging_steps=1,
        num_printed_samples=0,
        use_lora=False,              # full fine-tune for fastest movement
        gradient_checkpointing=False,
        save_steps=0,
        load_best_model_at_end=False,
    )
    trainer = common.build_trainer(cfg, device="cpu")
    assert trainer.cfg.batch_size == 16
    trainer.train()
    trainer.close()

    lines = [json.loads(line) for line in open(tmp_path / "learn" / "metrics.jsonl")
             if "samples" not in line]
    rewards = [row["eval_objective/rlhf_reward_old"] for row in lines]
    assert len(rewards) == 12
    early = float(np.mean(rewards[:2]))
    late = float(np.mean(rewards[-3:]))
    assert late > early + 0.2, f"no learning: first2={early:.3f}, last3={late:.3f}, all={rewards}"
