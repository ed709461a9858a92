"""Resume and export through the port's trainer on the CPU (tiny random
model, plain versions of every kernel): two straight updates against one
update, a resume in a fresh trainer and one more update, bit for bit, for
GRPO and PPO; a resume from an earlier step abandoning the newer
checkpoints (a fault the port had: `latest_step()` still named the
abandoned trajectory); a corrupt newest checkpoint resumed from the older
one; and `export_hf_dir` at the end of `train()`, loaded by the JAX
package to JAX's `merge_lora` of the bridged tree."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.core.lora import merge_lora as jax_merge_lora
from nanorlhf_tpu.core.params import load_hf_checkpoint as jax_load_hf_checkpoint
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.entrypoints import common, ppo
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)


def _cfg(algo, out, **over):
    cfg = one_card_cut(ppo.build_ppo_config() if algo == "ppo" else build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.train_dataset_name = "synthetic:64"
    cfg.output_dir = str(out)
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 64
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.value_lora_r, cfg.value_lora_alpha = 4, 8
    cfg.learning_rate = 1e-2
    cfg.ckpt_retry_backoff = 0.0
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(algo, out, **over):
    hooks = dict(value_params_fn=ppo.make_value_params) if algo == "ppo" else {}
    tr = common.build_trainer(_cfg(algo, out, **over), device="cpu", **hooks)
    tr.reward_func = _varied_reward
    return tr


def _moments(tr):
    return {(g, m, p): t for g, st in tr.opt_state.items() for m in ("mu", "nu")
            for p, t in flatten(getattr(st, m)).items()}


@pytest.mark.parametrize("algo", ["grpo", "ppo"])
def test_resume_continues_the_straight_run_bit_for_bit(tmp_path, algo):
    straight = _trainer(algo, tmp_path / "straight")
    straight.train(num_updates=2)
    straight.close()

    first = _trainer(algo, tmp_path / "resumed")
    first.train(num_updates=1)
    first.close()
    second = _trainer(algo, tmp_path / "resumed")
    assert second.resume_from_checkpoint()["global_step"] == 1
    second.train(num_updates=1)
    second.close()

    assert second.state == straight.state
    trees = [(straight.trainable, second.trainable)]
    if algo == "ppo":
        trees.append((straight.value_trainable, second.value_trainable))
    for a, b in trees:
        fa, fb = flatten(a), flatten(b)
        assert fa.keys() == fb.keys()
        for p in fa:
            assert torch.equal(fa[p].detach(), fb[p].detach()), p
    ma, mb = _moments(straight), _moments(second)
    assert ma.keys() == mb.keys()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert {g: s.count for g, s in straight.opt_state.items()} == \
        {g: s.count for g, s in second.opt_state.items()}
    # the last update's rows: the same tokens sampled, the same rewards
    rows = [open(os.path.join(t.cfg.output_dir, "metrics.jsonl")).read().splitlines()[-1]
            for t in (straight, second)]
    drop = ("sec_per_episode", "time", "t_mono", "perf/", "mem/peak")

    def stable(line):
        return {k: v for k, v in json.loads(line).items() if not k.startswith(drop)}

    assert stable(rows[0]) == stable(rows[1])


@pytest.mark.parametrize("entry", ["resume_from_checkpoint", "restore_checkpoint"])
def test_resume_from_an_earlier_step_truncates_newer_checkpoints(tmp_path, entry):
    tr = _trainer("grpo", tmp_path / "run")
    tr.train(num_updates=3)
    tr.close()
    again = _trainer("grpo", tmp_path / "run")
    getattr(again, entry)(1)
    assert again.state["global_step"] == 1
    assert again.ckpt.latest_step() == 1
    assert not any(os.path.isdir(os.path.join(tr.cfg.output_dir, f"checkpoint-{s}"))
                   for s in (2, 3))
    assert again.ckpt.best_step() in (None, 1)
    again.train(num_updates=1)
    assert again.ckpt.latest_step() == 2 and again.state["global_step"] == 2
    again.close()


def test_resume_falls_back_from_a_corrupt_checkpoint(tmp_path):
    tr = _trainer("grpo", tmp_path / "run")
    tr.train(num_updates=2)
    tr.close()
    tree = os.path.join(tr.cfg.output_dir, "checkpoint-2", "tree.pt")
    with open(tree, "r+b") as f:
        f.truncate(os.path.getsize(tree) // 3)
    again = _trainer("grpo", tmp_path / "run")
    assert again.resume_from_checkpoint()["global_step"] == 1
    assert again.ckpt.fallback_count == 1 and again.ckpt.last_restored_step == 1
    # the corrupt newer trajectory is dropped with the adopted step
    assert again.ckpt.latest_step() == 1
    again.close()


def test_export_hf_dir_at_the_end_of_train(tmp_path):
    out = str(tmp_path / "hf")
    tr = _trainer("grpo", tmp_path / "run", export_hf_dir=out, total_episodes=8)
    tr.train()
    tr.close()
    assert tr.state["global_step"] == 1
    _, exported = jax_load_hf_checkpoint(out, dtype=jnp.float32)
    want = jax_merge_lora(jax.tree.map(jnp.asarray, params_to_numpy(tr.params)),
                          tr.lora_scale)
    got_leaves = jax.tree_util.tree_leaves_with_path(exported)
    want_tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
                             want)
    assert jax.tree.structure(exported) == jax.tree.structure(want_tree)
    for (path, got), w in zip(got_leaves, jax.tree.leaves(want_tree)):
        # the export is bf16: one bf16 rounding of the f32 merge (the
        # merge's f32 sums may differ from JAX's in the last place)
        np.testing.assert_allclose(np.asarray(got), w, rtol=2.0**-8, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
