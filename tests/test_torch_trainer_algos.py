"""The port's RLOO, ReMax, REINFORCE, RAFT and PPO launchers end to end on
the CPU (tiny random model, plain versions of every kernel): two updates
each through `common.build_trainer` with the launcher's config, the metric
rows the JAX trainer writes for each algorithm and their identities, PPO's
value tree in its checkpoint, ReMax's greedy baseline against the JAX
package's greedy stream, RLOO over the paged cache, the launchers' literals
against the JAX launchers', and no run without a card unless asked for the
CPU."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    LORA,
    closes_trainers,
    jax_config,
    make_params,
    port_config,
)
from nanorlhf_tpu.entrypoints import ppo as jax_ppo
from nanorlhf_tpu.entrypoints import raft as jax_raft
from nanorlhf_tpu.entrypoints import reinforce as jax_reinforce
from nanorlhf_tpu.entrypoints import remax as jax_remax
from nanorlhf_tpu.entrypoints import rloo as jax_rloo
from nanorlhf_tpu.sampler import SamplingParams as JaxSamplingParams
from nanorlhf_tpu.sampler import generate as jax_generate
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common, ppo, raft, reinforce, remax, rloo
from nanorlhf_tpu_torch.entrypoints.grpo import one_card_cut
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer.optim import flatten
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM, rollout_and_score, rollout_generator, stream_generator)
from nanorlhf_tpu_torch.trainer.value_init import ValueInitConfig

torch.set_num_threads(1)

LAUNCHERS = {
    "rloo": (rloo.build_rloo_config, jax_rloo.build_rloo_config),
    "remax": (remax.build_remax_config, jax_remax.build_remax_config),
    "reinforce": (reinforce.build_reinforce_config, jax_reinforce.build_reinforce_config),
    "raft": (raft.build_raft_config, jax_raft.build_raft_config),
    "ppo": (ppo.build_ppo_config, jax_ppo.build_ppo_config),
}
# every key the JAX trainer smoke test asks of each algorithm
METRIC_KEYS = (
    "objective/kl_old", "objective/kl_rollout_old", "objective/entropy_old",
    "objective/non_score_reward_old", "eval_objective/scores_old",
    "eval_objective/rlhf_reward_old", "policy/approxkl_avg_new",
    "policy/clipfrac_avg_new", "policy/entropy_avg_new", "loss/policy_avg_new",
    "val/ratio_new", "val/ratio_var_new", "val/num_eos_tokens_old", "lr", "eps",
    "episode", "policy/grad_norm_new",
)
SMALL_VALUE_INIT = ValueInitConfig(train_data_size=8, num_train_epochs=2,
                                   per_device_train_batch_size=2)


def _tiny_cfg(algo, tmp_path, **over):
    cfg = one_card_cut(LAUNCHERS[algo][0]())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / algo)
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 64
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.value_lora_r, cfg.value_lora_alpha = 4, 8
    cfg.learning_rate = 1e-2
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(algo, tmp_path, **over):
    cfg = _tiny_cfg(algo, tmp_path, **over)
    hooks = {}
    if algo == "ppo":
        hooks = dict(value_params_fn=ppo.make_value_params,
                     post_build=ppo.value_init_phase(cfg, True, SMALL_VALUE_INIT))
    tr = common.build_trainer(cfg, device="cpu", **hooks)
    tr.reward_func = _varied_reward
    return tr


def _snapshot(tree):
    return {p: t.detach().clone() for p, t in flatten(tree).items()}


@pytest.mark.parametrize("algo", sorted(LAUNCHERS))
def test_launcher_trains_two_updates_on_cpu(algo, tmp_path):
    tr = _trainer(algo, tmp_path)
    cfg = tr.cfg
    base, ref = _snapshot(tr.params), _snapshot(tr.ref_params)
    trained = set(flatten(tr.trainable))
    value0 = _snapshot(tr.value_params) if algo == "ppo" else None
    state = tr.train(num_updates=2)
    assert state["global_step"] == 2 and state["opt_steps"] == 2 * cfg.num_mini_batches
    after = flatten(tr.params)
    assert any(not torch.equal(after[p].detach(), base[p])
               for p in trained if p[0] == "lora" and p[-1] == "b")
    assert all(torch.equal(after[p], base[p]) for p in base if p not in trained)
    assert all(torch.equal(t, ref[p]) for p, t in flatten(tr.ref_params).items())
    # the update half ran no kernel: CPU tensors take the plain versions
    assert not any(tr.last_launches["update"].values())
    rows = [json.loads(line) for line in open(os.path.join(cfg.output_dir, "metrics.jsonl"))]
    assert len(rows) == 2
    for m in rows:
        for key in METRIC_KEYS:
            assert key in m and np.isfinite(m[key]), key
        assert m["policy/entropy_avg_new"] > 0 and m["lr"] > 0
        assert m["policy/grad_norm_new"] > 0
        np.testing.assert_allclose(m["objective/non_score_reward_old"],
                                   -cfg.kl_coef * m["objective/kl_rollout_old"],
                                   rtol=1e-5, atol=1e-9)
    # the second rollout's policy has moved off the ref: a live KL term
    assert rows[1]["objective/kl_rollout_old"] != 0.0
    if algo == "ppo":
        for key in ("loss/value_avg_new", "val/clipfrac_avg_new"):
            assert np.isfinite(rows[1][key]), key
        vafter = flatten(tr.value_params)
        vtrained = set(flatten(tr.value_trainable))
        assert {("score",), ("embed_tokens",)} <= vtrained
        assert all(not torch.equal(vafter[p].detach(), value0[p]) for p in vtrained
                   if p[0] != "lora" or p[-1] == "b")
        assert all(torch.equal(vafter[p].detach(), value0[p])
                   for p in value0 if p not in vtrained)
    else:
        assert "loss/value_avg_new" not in rows[1]
    tr.close()


def test_rloo_and_raft_score_every_sample(monkeypatch, tmp_path):
    """RLOO and RAFT hand all B·N rows to the scorer, then keep one per
    prompt: the update's batch holds B rows."""
    scored = []
    real = trollout.score_chunk

    def spy(params, ref, mcfg, cfg, rows, *args, **kw):
        scored.append(rows.shape[0])
        return real(params, ref, mcfg, cfg, rows, *args, **kw)

    monkeypatch.setattr(trollout, "score_chunk", spy)
    for algo in ("rloo", "raft"):
        scored.clear()
        tr = _trainer(algo, tmp_path)
        tr.train(num_updates=1)
        assert sum(scored) == tr.cfg.batch_size * tr.cfg.sample_n
        assert tr.last_stats
        tr.close()


def test_ppo_checkpoint_holds_the_value_tree(tmp_path):
    tr = _trainer("ppo", tmp_path)
    tr.train(num_updates=1)
    saved = tr.ckpt.restore(1)
    assert set(saved) == {"params", "opt_state", "value"}
    assert set(saved["opt_state"]) == {"policy", "value"}
    assert flatten(saved["value"]).keys() == flatten(tr.value_trainable).keys()
    tr2 = _trainer("ppo", tmp_path / "again")
    tr2.cfg.output_dir = tr.cfg.output_dir
    tr2.ckpt = tr.ckpt
    assert tr2.restore_checkpoint() == 1
    for a, b in ((tr.trainable, tr2.trainable), (tr.value_trainable, tr2.value_trainable)):
        for p, t in flatten(a).items():
            assert torch.equal(flatten(b)[p].detach(), t.detach()), p
    for g in ("policy", "value"):
        assert tr2.opt_state[g].count == tr.opt_state[g].count == tr.cfg.num_mini_batches
        for m in ("mu", "nu"):
            for p, t in flatten(getattr(tr.opt_state[g], m)).items():
                assert torch.equal(flatten(getattr(tr2.opt_state[g], m))[p], t)
    tr.close()
    tr2.close()


def test_ppo_main_runs_value_init_then_trains(tmp_path, capsys):
    state = ppo.main(value_init_cfg=SMALL_VALUE_INIT, cfg=_tiny_cfg("ppo", tmp_path),
                     device="cpu", num_updates=1)
    assert state["global_step"] == 1
    assert "[value-init] epoch 1" in capsys.readouterr().out


def test_remax_greedy_baseline_matches_jax(monkeypatch):
    """ReMax's second generate is greedy (`SamplingParams(greedy=True,
    max_tokens=response_length)`): token for token the JAX package's
    greedy stream on the bridged weights, and its rewards are the
    baseline."""
    jcfg = jax_config("qwen_tied", vocab_size=4096)
    mcfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=21)
    cfg = remax.build_remax_config()
    cfg.response_length = 8
    tok = ToyTokenizer(4096)
    from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset

    queries = next(load_prompt_dataset("synthetic:64", tok).loader(4, cfg.seed))
    calls = []
    real = trollout.generate

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args[5], out.clone()))
        return out

    monkeypatch.setattr(trollout, "generate", spy)
    out = rollout_and_score(
        tparams, None, mcfg, cfg, tok, queries, _varied_reward,
        rollout_generator(cfg.seed, 0, "cpu"), LORA.scale,
        stream_generator(cfg.seed, KEEP_STREAM, 0))
    assert len(calls) == 2 and calls[1][0].greedy and not calls[0][0].greedy
    assert calls[1][0].max_tokens == cfg.response_length
    greedy = calls[1][1].numpy()
    want = np.asarray(jax_generate(
        jparams, jcfg, jnp.asarray(queries), jnp.asarray(queries != 0),
        jax.random.PRNGKey(0), JaxSamplingParams(greedy=True, max_tokens=8),
        eos_token_id=tok.eos_token_id, pad_token_id=0, lora_scale=LORA.scale))
    np.testing.assert_array_equal(greedy, want)
    questions = [q.replace(tok.pad_token, "") for q in tok.batch_decode(queries)]
    np.testing.assert_array_equal(
        out["greedy_scores"],
        _varied_reward([q + r for q, r in zip(questions, tok.batch_decode(greedy))], ""))
    assert out["keep"] is None and out["responses"].shape == (4, 8)


def test_rloo_over_the_paged_cache_trains(tmp_path):
    tr = _trainer("rloo", tmp_path, rollout_page_size=4, rollout_decode_rows=8)
    base = _snapshot(tr.trainable)
    assert tr.train(num_updates=1)["global_step"] == 1
    assert tr.pages_status is not None and tr.session_status is not None
    assert any(not torch.equal(t.detach(), base[p]) for p, t in flatten(tr.trainable).items())
    tr.close()


@pytest.mark.parametrize("algo", sorted(LAUNCHERS))
def test_launcher_config_matches_jax(algo):
    def norm(cfg):
        d = dataclasses.asdict(cfg)
        d["algo"] = cfg.algo.value
        return d

    port, ref = LAUNCHERS[algo]
    assert norm(port()) == norm(ref())


@pytest.mark.parametrize("algo", sorted(LAUNCHERS))
def test_launcher_needs_a_card_unless_asked_for_cpu(algo, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg(algo, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        if algo == "ppo":
            ppo.main(cfg=cfg, num_updates=1)
        else:
            common.run(cfg, num_updates=1)
