"""Two optimizer steps of the port's update (trainer/update.py,
trainer/optim.py) for RLOO, RAFT, REINFORCE, ReMax and PPO against the JAX
trainer's jitted `_update_fn` on a tiny single-device `RLTrainer` of that
algorithm, in f32, with `tests/test_torch_update.py`'s tolerances. PPO
holds the value tree's trainable leaves (its LoRA, score head and
embeddings) and both groups' Adam moments too; its `max_grad_norm` case
clips each group by its own norm, which a joint clip over both groups
would not match."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    LORA,
    closes_trainers,
    jax_config,
    make_params,
    port_config,
)
from nanorlhf_tpu.core.lora import init_lora_params as jax_init_lora_params
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.data import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nanorlhf_tpu_torch.core.lora import LoraConfig, trainable_mask, value_trainable_mask
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.optim import MultiAdamW, build_optimizer, flatten, unflatten
from nanorlhf_tpu_torch.trainer.trainer import _trainable_leaves
from nanorlhf_tpu_torch.trainer.update import update_minibatch

torch.set_num_threads(1)

# as tests/test_torch_update.py (adam_eps 1e-5 keeps m / (√v + eps) smooth
# where a gradient is tiny)
KNOBS = dict(
    response_length=6, temperature=0.8, total_episodes=64,
    per_device_train_batch_size=2, gradient_accumulation_steps=2, num_mini_batches=2,
    num_ppo_epochs=1, learning_rate=1e-3, value_learning_rate=3e-3, min_lr_rate=0.1,
    adam_eps=1e-5, weight_decay=0.01, kl_coef=0.05, cliprange=0.2, cliprange_value=0.2,
    vf_coef=0.1, use_lora=True, lora_r=LORA.r, lora_alpha=LORA.alpha,
    value_lora_r=LORA.r, value_lora_alpha=LORA.alpha, save_steps=0, report_to="none",
    fused_logprob_chunk=5, gradient_checkpointing=True,
)
CTX = 7
PAD = 0
VOCAB = 64


def _minibatch(algo, seed, rows):
    rng = np.random.default_rng(seed)
    T = KNOBS["response_length"]
    q = rng.integers(3, VOCAB, (rows, CTX)).astype(np.int32)
    q[1, :3] = PAD
    r = rng.integers(3, VOCAB, (rows, T)).astype(np.int32)
    pm = np.zeros((rows, T), bool)
    pm[2, 4:] = True
    pm1 = np.zeros((rows, T), bool)
    pm1[2, 5:] = True
    r[pm] = PAD
    old = (rng.standard_normal((rows, T)) * 0.3 - 4).astype(np.float32)
    mb = {
        "query_responses": np.concatenate([q, r], 1),
        "responses": r,
        "logprobs": np.where(pm, 1.0, old).astype(np.float32),
        "padding_mask": pm,
        "padding_mask_p1": pm1,
    }
    adv = np.where(pm, 0.0, rng.standard_normal((rows, T))).astype(np.float32)
    if algo == "rloo":
        mb["advantages_seq"] = rng.standard_normal(rows).astype(np.float32)
    elif algo != "raft":
        mb["advantages"] = adv
    if algo == "ppo":
        mb["values"] = np.where(pm1, 0.0, rng.standard_normal((rows, T)) * 0.3
                                ).astype(np.float32)
        mb["returns"] = rng.standard_normal((rows, T)).astype(np.float32)
    return mb


def _adam_states(opt_state):
    """Each group's ScaleByAdamState inside the trainer's multi_transform,
    in group order (policy, value)."""
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState) and jax.tree_util.tree_leaves(s.mu)]


def _drop_none(tree):
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _value_tree(jcfg, jparams):
    """A JAX value tree: the backbone, a random score head, a LoRA subtree
    with B away from zero (so the JAX trainer inits none of its own)."""
    tree = jax.tree.map(np.asarray, {k: v for k, v in jparams.items()
                                     if k not in ("lm_head", "lora")})
    rng = np.random.default_rng(5)
    tree["score"] = (rng.standard_normal((jcfg.hidden_size, 1)) * 0.1).astype(np.float32)
    lora = jax.tree.map(np.asarray, jax_init_lora_params(
        jcfg, LORA, jax.random.PRNGKey(9), dtype=jnp.float32))
    for ab in lora["layers"].values():
        ab["b"] = rng.normal(0, 0.02, ab["b"].shape).astype(np.float32)
    tree["lora"] = lora
    return tree


def _jax_steps(algo, jcfg_rl, jmodel, jparams, jvalue, mbs):
    tok = JaxToyTokenizer(vocab_size=VOCAB)
    jtr = JaxRLTrainer(jcfg_rl, jmodel, tok, jparams, jax_load_dataset("synthetic:64", tok),
                       lambda texts, eos: np.zeros(len(texts), np.float32),
                       value_params=None if jvalue is None else jax.tree.map(jnp.asarray, jvalue),
                       mesh=make_mesh(jcfg_rl.mesh, devices=jax.devices()[:1]))
    try:
        trainable, frozen = jtr._partition(jtr._train_tree(jtr.params, jtr.value_params))
        opt_state = jtr.opt_state
        stats = []
        for mb in mbs:
            trainable, opt_state, st = jtr._update_fn(
                trainable, frozen, opt_state, {k: jnp.asarray(v) for k, v in mb.items()},
                CTX)
            stats.append(jax.device_get(st))
    finally:
        jtr.close()
    return jax.tree.map(np.asarray, trainable), opt_state, stats


def _port_groups(tparams, value):
    lcfg = LoraConfig(r=LORA.r, alpha=LORA.alpha)
    groups = {"policy": _trainable_leaves(tparams, trainable_mask(tparams, lcfg))}
    if value is not None:
        groups["value"] = _trainable_leaves(value, value_trainable_mask(value, lcfg))
    for t in flatten(groups).values():
        t.requires_grad_(True)
    return groups


def _port_steps(optimizer, groups, tparams, value, mcfg, cfg, mbs):
    state = optimizer.init(groups)
    stats = []
    for mb in mbs:
        state, st = update_minibatch(tparams, groups, optimizer, state,
                                     {k: torch.as_tensor(v) for k, v in mb.items()},
                                     mcfg, cfg, CTX, PAD, LORA.scale,
                                     value=value, value_lora_scale=LORA.scale)
        stats.append(st)
    return state, stats


CASES = {
    # name: (algo, max_grad_norm)
    "rloo": ("rloo", None),
    "raft": ("raft", None),
    "reinforce": ("reinforce", None),
    "remax": ("remax", None),
    "ppo": ("ppo", None),
    "ppo_clip": ("ppo", 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_minibatch_matches_jax_update_fn(case, tmp_path):
    algo, clip = CASES[case]
    knobs = {**KNOBS, "algo": algo, "max_grad_norm": clip,
             "sample_n": 1 if algo in ("ppo", "reinforce", "remax") else 2}
    jcfg_rl = JaxRLConfig(**{**knobs, "algo": JaxAlgoName(algo)}, output_dir=str(tmp_path),
                          mesh=JaxMeshConfig(1, 1, 1))
    cfg = RLConfig(**knobs, output_dir=str(tmp_path)).finalize(1)
    jmodel = jax_config("qwen_tied", vocab_size=VOCAB)
    mcfg = port_config(jmodel)
    jparams, tparams = make_params(jmodel, seed=11)
    jvalue = _value_tree(jmodel, jparams) if algo == "ppo" else None
    value = params_from_numpy(jvalue) if jvalue is not None else None
    mbs = [_minibatch(algo, s, cfg.local_mini_batch_size) for s in (1, 2)]

    jtrain, jopt, jstats = _jax_steps(algo, jcfg_rl, jmodel, jparams, jvalue, mbs)
    groups = _port_groups(tparams, value)
    before = {p: t.detach().clone() for p, t in flatten(groups).items()}
    state, stats = _port_steps(build_optimizer(cfg), groups, tparams, value, mcfg, cfg, mbs)

    adams = _adam_states(jopt)
    assert len(adams) == len(groups)
    for (name, group), adam in zip(groups.items(), adams):
        want_params = _drop_none(jtrain[name])
        got_params = params_to_numpy(group)
        assert flatten(got_params).keys() == flatten(want_params).keys()
        assert int(adam.count) == state[name].count == 2
        # the GRPO test's tolerances, and for the moments, whose entries
        # include gradients that cancel (the tied embedding's, the
        # sequence-level ratio's), no tighter than 3e-5 of each leaf's
        # largest moment: f32 with the two stacks' own summation orders
        for got, want, base, scale in (
                (got_params, want_params, 1e-5, 0.0),
                (params_to_numpy(state[name].mu), _drop_none(adam.mu[name]), 1e-6, 3e-5),
                (params_to_numpy(state[name].nu), _drop_none(adam.nu[name]), 1e-9, 3e-5)):
            want = flatten(jax.tree.map(np.asarray, want))
            for path, g in flatten(got).items():
                atol = max(base, scale * float(np.abs(want[path]).max()))
                np.testing.assert_allclose(g, want[path], atol=atol, rtol=1e-4,
                                           err_msg=f"{name}/" + "/".join(path))
    for st, jst in zip(stats, jstats):
        assert set(st) == set(jst)
        for k in jst:
            np.testing.assert_allclose(st[k], float(jst[k]), atol=1e-6, rtol=1e-5, err_msg=k)
    assert stats[0]["grad_norm"] > 0
    after = flatten(groups)
    assert any(not torch.equal(after[p].detach(), before[p])
               for p in after if p[0] == "policy" and p[-1] == "b")
    if algo == "ppo":
        for leaf in (("value", "score"), ("value", "embed_tokens")):
            assert not torch.equal(after[leaf].detach(), before[leaf])
        assert {"vf_loss", "vf_clipfrac"} <= set(stats[0])

    if clip:
        # one AdamW over both groups, clipped by their joint norm, at each
        # group's learning rate: a different result that the held one is not
        _, tparams2 = make_params(jmodel, seed=11)
        value2 = params_from_numpy(jvalue)
        groups2 = _port_groups(tparams2, value2)
        per_group = build_optimizer(cfg)
        joint = _JointClip(per_group, clip)
        _port_steps(joint, groups2, tparams2, value2, mcfg, cfg, mbs)
        got = params_to_numpy(groups2["value"])
        want = flatten(_drop_none(jtrain["value"]))
        assert any(not np.allclose(g, want[p], atol=1e-5, rtol=1e-4)
                   for p, g in flatten(got).items())


class _JointClip(MultiAdamW):
    """The groups' AdamWs without their own clips, behind one
    clip_by_global_norm over every group's gradients."""

    def __init__(self, inner: MultiAdamW, max_norm: float):
        for opt in inner.groups.values():
            opt.max_grad_norm = None
        super().__init__(inner.groups)
        self.max_norm = max_norm

    def step(self, trainable, grads, state, norms=None):
        # `norms` (the groups' own) go unused: the groups do not clip
        norm = float(torch.sqrt(sum(g.float().pow(2).sum()
                                    for g in flatten(grads).values())))
        if norm >= self.max_norm:
            grads = {k: {p: g / norm * self.max_norm for p, g in flatten(v).items()}
                     for k, v in grads.items()}
            grads = {k: unflatten(v) for k, v in grads.items()}
        return super().step(trainable, grads, state)
