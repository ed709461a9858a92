"""Each algorithm's batch assembly in the port (`rollout.assemble_batch`)
against the JAX trainer's `_assemble_batch` on the same rollout: the
KL-shaped rewards, RLOO's leave-one-out advantage and keep, RAFT's
best-of-K (and its random mode), PPO's value pass (bridged value params),
GAE and returns, REINFORCE's and ReMax's discounted returns, GRPO's
broadcast z-score, with `whiten_rewards` and `advantage_whiten` on and
off. The JAX side's random keep is patched to the port's draw."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, make_params, port_config
from nanorlhf_tpu.algos.advantages import remax_advantage as jax_remax_advantage
from nanorlhf_tpu.ops.masking import INVALID_LOGPROB as JAX_INVALID
from nanorlhf_tpu.ops.masking import first_true_indices, response_padding_masks, truncate_response
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import trainer as jax_trainer
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.rollout import assemble_batch
from nanorlhf_tpu_torch.trainer.scoring import value_pass

torch.set_num_threads(1)

PAD, EOS = 0, 1
B, TQ, R = 3, 5, 7


def _rollout(algo, n, seed):
    """A port-side rollout result over B prompts × n samples."""
    rng = np.random.default_rng(seed)
    rows = B if algo == "grpo" else B * n
    queries = rng.integers(3, 128, (B, TQ)).astype(np.int32)
    queries[1, :2] = PAD
    responses = rng.integers(3, 128, (rows, R)).astype(np.int32)
    for i in range(0, rows, 2):
        responses[i, 1 + i % (R - 1)] = EOS          # stops early
    responses[-1, 3:] = PAD                          # ran out without EOS
    lp = (rng.standard_normal((rows, R)) * 0.5 - 3).astype(np.float32)
    ro = {"queries": queries, "responses": responses,
          "scores": rng.standard_normal(B * n).astype(np.float32),
          "logprobs": lp, "ref_logprobs": (lp + rng.standard_normal((rows, R)) * 0.2
                                           ).astype(np.float32),
          "keep": None, "context_length": TQ}
    if algo == "grpo":
        ro["keep"] = rng.integers(0, n, B)
        ro["advantages"] = rng.standard_normal(B).astype(np.float32)
    if algo == "remax":
        ro["greedy_scores"] = rng.standard_normal(B).astype(np.float32)
    return ro


def _jax_inputs(ro, algo, cfg):
    """What the JAX trainer hands `_assemble_batch`, computed with the JAX
    package's own masking ops."""
    responses = jnp.asarray(ro["responses"])
    post = truncate_response(EOS, PAD, responses)
    seq_lengths = np.asarray(first_true_indices(post == PAD) - 1)
    pm, pm1 = (np.asarray(m) for m in response_padding_masks(np.asarray(post),
                                                             jnp.asarray(seq_lengths)))
    logprobs = np.where(pm, JAX_INVALID, ro["logprobs"])
    ref_logprobs = np.where(pm, JAX_INVALID, ro["ref_logprobs"])
    if algo == "grpo":
        scores = ro["advantages"]
    elif algo == "remax":
        scores = np.asarray(jax_remax_advantage(jnp.asarray(ro["scores"]),
                                                jnp.asarray(ro["greedy_scores"])))
    else:
        scores = ro["scores"]
    if cfg.missing_eos_penalty is not None:
        scores = scores.copy()
        scores[~(np.asarray(post) == EOS).any(axis=1)] -= cfg.missing_eos_penalty
    n = ro["responses"].shape[0] // B
    qr = np.concatenate([np.repeat(ro["queries"], n, axis=0), ro["responses"]], axis=1)
    return (scores, logprobs, ref_logprobs, pm, pm1, seq_lengths, qr, ro["responses"],
            TQ, B, cfg.sample_n)


CASES = {
    # name: (algo, whiten_rewards, advantage_whiten, extra knobs)
    "grpo": ("grpo", False, False, {}),
    "grpo_whiten": ("grpo", True, True, {}),
    "rloo": ("rloo", False, False, {}),
    "rloo_whiten": ("rloo", True, True, {}),
    "raft_best": ("raft", False, False, {}),
    "raft_best_whiten": ("raft", True, False, {"missing_eos_penalty": 1.0}),
    "raft_random": ("raft", False, False, {"raft_selection": "random"}),
    "reinforce": ("reinforce", False, True, {"gamma": 0.9}),
    "reinforce_whiten": ("reinforce", True, False, {}),
    "remax": ("remax", False, False, {"missing_eos_penalty": 0.5}),
    "remax_whiten": ("remax", True, True, {}),
    "ppo": ("ppo", False, False, {"gamma": 0.95, "lam": 0.9}),
    "ppo_whiten": ("ppo", True, True, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_batch_matches_jax(case, monkeypatch, tmp_path):
    algo, whiten_r, whiten_a, extra = CASES[case]
    n = 1 if algo in ("ppo", "reinforce", "remax") else 3
    knobs = dict(sample_n=n, kl_coef=0.07, whiten_rewards=whiten_r,
                 advantage_whiten=whiten_a, **extra)
    cfg = RLConfig(algo=algo, **knobs)
    jcfg = JaxRLConfig(algo=JaxAlgoName(algo), **knobs)
    ro = _rollout(algo, n, seed=len(case))

    value_fn = None
    fake = types.SimpleNamespace(cfg=jcfg, algo=JaxAlgoName(algo), key=jax.random.PRNGKey(0))
    if algo == "ppo":
        jmodel = jax_config("qwen_tied")
        jparams, _ = make_params(jmodel, seed=3, lora=False)
        vtree = jax.tree.map(np.asarray, {k: v for k, v in jparams.items()})
        vtree["score"] = np.random.default_rng(1).standard_normal(
            (jmodel.hidden_size, 1)).astype(np.float32)
        fake.mcfg, fake.value_lora_scale = jmodel, 1.0
        fake.value_params = jax.tree.map(jnp.asarray, vtree)
        fake.tokenizer = types.SimpleNamespace(pad_token_id=PAD)
        fake._sp_on = lambda: False
        fake._value_pass = lambda qr, ctx: jax_trainer.RLTrainer._value_pass(fake, qr, ctx)
        tvalue = params_from_numpy(vtree)
        value_fn = lambda qr: value_pass(tvalue, port_config(jmodel), qr, TQ, PAD)  # noqa: E731

    batch, info = assemble_batch(ro, cfg, EOS, PAD, EOS,
                                 keep_generator=torch.Generator().manual_seed(7),
                                 value_fn=value_fn)
    port_keep = info["keep"]
    monkeypatch.setattr(jax_trainer, "keep_one_of_n_indices",
                        lambda key, b, n_: jnp.asarray(port_keep))
    real_best = jax_trainer.best_of_k_indices
    monkeypatch.setattr(jax_trainer, "best_of_k_indices",
                        lambda r, k, key=None: real_best(r, k) if key is None
                        else jnp.asarray(port_keep))
    jbatch, jkeep, jinfo = jax_trainer.RLTrainer._assemble_batch(
        fake, *_jax_inputs(ro, algo, jcfg))

    if algo in ("rloo", "raft"):
        np.testing.assert_array_equal(port_keep, np.asarray(jkeep))
    else:
        assert jkeep is None
    assert set(batch) == set(jbatch)
    for k, want in jbatch.items():
        want = np.asarray(want)
        assert batch[k].shape == want.shape, k
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(batch[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(batch[k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    for k, v in jinfo.items():
        np.testing.assert_allclose(info[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    if algo != "grpo":
        # non_score_reward is the KL penalty alone: −kl_coef × the rollout KL
        pm = info["padding_mask"]
        kl = np.where(pm, 0.0, info["logprobs"] - info["ref_logprobs"]).sum(1).mean()
        np.testing.assert_allclose(info["non_score_reward_old"], -0.07 * kl, rtol=1e-5)
