"""The port's GRPO trainer end to end on the CPU (tiny random model, plain
versions of every kernel): one whole update through the launcher's entry
points, the checkpoint it writes and restores, the metrics rows, the two
faults this slice repaired (scoring every sample instead of the kept one;
a ref model that moved with the policy when LoRA was off), checkpoint
rotation against the JAX `CheckpointManager`, and the knobs that raise."""

import json
import os

import numpy as np
import pytest
import torch

from nanorlhf_tpu.trainer.checkpoint import CheckpointManager as JaxCheckpointManager
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
from nanorlhf_tpu_torch.trainer.optim import flatten
from nanorlhf_tpu_torch.trainer.trainer import check_trainer_supported

torch.set_num_threads(1)


def _tiny_cfg(tmp_path, **over):
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "run")
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 16
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.learning_rate = 1e-3
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    """A reward with variance inside every group, so the GRPO advantages
    (and the gradients) are not all zero on a random model."""
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(tmp_path, **over):
    tr = common.build_trainer(_tiny_cfg(tmp_path, **over), device="cpu")
    tr.reward_func = _varied_reward
    return tr


def _snapshot(tree):
    return {p: t.detach().clone() for p, t in flatten(tree).items()}


def test_one_update_on_cpu_trains_saves_and_restores(tmp_path):
    tr = _trainer(tmp_path)
    base, ref = _snapshot(tr.params), _snapshot(tr.ref_params)
    trained = set(flatten(tr.trainable))
    state = tr.train(num_updates=1)
    assert state == {"episode": tr.cfg.batch_size, "global_step": 1,
                     "opt_steps": tr.cfg.num_mini_batches, "rollouts": 1}
    after = flatten(tr.params)
    assert any(not torch.equal(after[p].detach(), base[p])
               for p in trained if p[0] == "lora" and p[-1] == "b")
    assert all(torch.equal(after[p], base[p]) for p in base if p not in trained)
    assert all(torch.equal(t, ref[p]) for p, t in flatten(tr.ref_params).items())
    # the update half ran no kernel: CPU tensors take the plain versions
    assert tr.last_launches["update"] == {n: 0 for n in _build.KERNELS}

    rows = [json.loads(line) for line in open(os.path.join(tr.cfg.output_dir, "metrics.jsonl"))]
    assert len(rows) == 1
    for key in ("policy/approxkl_avg_new", "policy/clipfrac_avg_new",
                "policy/entropy_avg_new", "loss/policy_avg_new", "val/ratio_new",
                "policy/grad_norm_new", "objective/kl_old", "eval_objective/scores_old",
                "lr", "episode"):
        assert np.isfinite(rows[0][key]), key
    assert rows[0]["policy/grad_norm_new"] > 0
    assert rows[0]["lr"] == pytest.approx(tr.cfg.learning_rate)

    # a fresh trainer restores the trained leaves, the moments and the cursor
    tr2 = _trainer(tmp_path)
    assert tr2.restore_checkpoint() == 1
    for p, t in flatten(tr.trainable).items():
        assert torch.equal(flatten(tr2.trainable)[p].detach(), t.detach())
    for m in ("mu", "nu"):
        for p, t in flatten(getattr(tr.opt_state["policy"], m)).items():
            assert torch.equal(flatten(getattr(tr2.opt_state["policy"], m))[p], t)
    assert tr2.opt_state["policy"].count == tr.opt_state["policy"].count == 2
    assert tr2.state == tr.state


def test_run_is_the_launcher_tail(tmp_path):
    state = common.run(_tiny_cfg(tmp_path), device="cpu", num_updates=1)
    assert state["global_step"] == 1
    assert os.path.isfile(os.path.join(str(tmp_path / "run"), "checkpoint-1", "tree.pt"))


def test_run_needs_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        common.run(_tiny_cfg(tmp_path))


def test_grpo_scores_only_the_kept_rows(monkeypatch):
    """Keep-1-of-N happens BEFORE the logprob pass, as in JAX: the scorer
    sees one row per prompt, never all B·N samples."""
    scored = []
    real = trollout.score_chunk

    def spy(params, ref, mcfg, cfg, rows, *args, **kw):
        scored.append(rows.shape[0])
        return real(params, ref, mcfg, cfg, rows, *args, **kw)

    monkeypatch.setattr(trollout, "score_chunk", spy)
    cfg = build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.response_length = 4
    out = common.run_rollout(cfg, device="cpu", num_prompts=3)
    assert sum(scored) == 3 and out["logprobs"].shape == (3, 4)
    assert out["scores"].shape == (3 * cfg.sample_n,)


def test_ref_stays_frozen_without_lora(tmp_path):
    """With use_lora=False every leaf trains; the ref is a copy, not the
    policy's tensors, so it does not move when the policy steps."""
    tr = _trainer(tmp_path, use_lora=False)
    ref = _snapshot(tr.ref_params)
    pol = flatten(tr.params)
    assert all(t is not pol[p] for p, t in flatten(tr.ref_params).items())
    before = _snapshot(tr.params)
    tr.train(num_updates=1)
    assert any(not torch.equal(t.detach(), before[p]) for p, t in flatten(tr.params).items())
    assert all(torch.equal(t, ref[p]) for p, t in flatten(tr.ref_params).items())


def test_checkpoint_rotation_matches_jax(tmp_path):
    """save_total_limit rotation under the `_old` convention: a metric
    arriving with save k scores save k−1; the best and the newest are
    never rotated away — the same survivors and best step as JAX's."""
    metrics = [None, 0.5, 0.9, 0.1, 0.2, 0.3]
    port = CheckpointManager(str(tmp_path / "port"), save_total_limit=2)
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), save_total_limit=2,
                                   async_save=False)
    for step, m in enumerate(metrics, start=1):
        port.save(step, {"w": torch.full((2,), float(step))}, metric_old=m)
        jax_mgr.save(step, {"w": np.full((2,), float(step))}, metric_old=m)
    jax_mgr.close()
    survivors = [int(d.rsplit("-", 1)[1]) for d in port._existing()]
    assert survivors == [int(d.rsplit("-", 1)[1]) for d in jax_mgr._existing()]
    assert port.best_step() == jax_mgr.best_step() == 2
    assert 2 in survivors and port.latest_step() == 6
    assert torch.equal(port.restore(2)["params"]["w"], torch.full((2,), 2.0))
    # a successor manager reads the history back
    again = CheckpointManager(str(tmp_path / "port"), save_total_limit=2)
    assert again.best_step() == 2 and again.latest_step() == 6


@pytest.mark.parametrize("knob,value", [
    ("telemetry", True), ("lineage", True), ("fault_spec", "update.step:at=1"),
    ("status_port", -1), ("profile_at_step", 1),
    ("rollout_ahead", True),
])
def test_unported_trainer_knobs_raise(knob, value):
    cfg = build_config()
    setattr(cfg, knob, value)
    with pytest.raises(NotImplementedError):
        check_trainer_supported(cfg)


def test_naive_update_branch_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="fused_logprob=False"):
        _trainer(tmp_path, fused_logprob=False)


def test_remat_dots_policy_raises_and_full_keeps_values():
    mcfg = ModelConfig.qwen2_tiny(vocab_size=64)
    params = tm.init_params(mcfg, seed=0, dtype=torch.float32, device="cpu")
    ids = torch.randint(1, 64, (2, 9))
    plain = tm.padded_forward_hidden(params, mcfg, ids, 0)
    torch.testing.assert_close(tm.padded_forward_hidden(params, mcfg, ids, 0, remat=True),
                               plain, atol=0, rtol=0)
    import dataclasses

    dots = dataclasses.replace(mcfg, remat_policy="dots")
    with pytest.raises(NotImplementedError, match="dots"):
        tm.padded_forward_hidden(params, dots, ids, 0, remat=True)
