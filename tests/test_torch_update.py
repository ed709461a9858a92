"""One optimizer step of the port's GRPO update (trainer/update.py,
trainer/optim.py) against the JAX trainer's jitted `_update_fn` on a tiny
single-device `RLTrainer`, in f32: the same bridged weights and LoRA init,
the same hand-made minibatch, two consecutive steps (bias correction and
the schedule's second value). Held: the new trainable leaves (LoRA and the
embeddings, which `LoraConfig` trains by default), the Adam moments, the
grad norm and the loss stats; with and without gradient checkpointing, and
through the flash-attention route (the Pallas kernels in interpret mode
against the port's autograd Function with its plain backward). Plus the
learning-rate schedule against optax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import LORA, jax_config, make_params, port_config
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.data import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.core.lora import LoraConfig, trainable_mask
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.optim import build_optimizer, flatten, lr_schedule
from nanorlhf_tpu_torch.trainer.trainer import _trainable_leaves
from nanorlhf_tpu_torch.trainer.update import update_minibatch

torch.set_num_threads(1)

# f32 both sides; adam_eps is raised to 1e-5 so that m / (√v + eps) at the
# first step is smooth in the gradient where |g| is tiny (at eps = 1e-8 a
# 1e-9 disagreement in a near-zero gradient would move that element's
# update by ~lr)
KNOBS = dict(
    algo="grpo", response_length=6, temperature=0.8, sample_n=2, total_episodes=64,
    per_device_train_batch_size=2, gradient_accumulation_steps=2, num_mini_batches=2,
    num_ppo_epochs=1, learning_rate=1e-3, min_lr_rate=0.1, adam_eps=1e-5,
    weight_decay=0.01, kl_coef=0.05, cliprange=0.2, use_lora=True,
    lora_r=LORA.r, lora_alpha=LORA.alpha, save_steps=0, report_to="none",
    fused_logprob_chunk=5,
)
CTX = 7
PAD = 0


def _configs(tmp_path, **over):
    knobs = {**KNOBS, **over}
    jcfg = JaxRLConfig(**{**knobs, "algo": JaxAlgoName.GRPO}, output_dir=str(tmp_path),
                       mesh=JaxMeshConfig(1, 1, 1))
    cfg = RLConfig(**knobs, output_dir=str(tmp_path))
    return jcfg, cfg.finalize(1)


def _minibatch(seed, rows, vocab):
    rng = np.random.default_rng(seed)
    T = KNOBS["response_length"]
    q = rng.integers(3, vocab, (rows, CTX)).astype(np.int32)
    q[1, :3] = PAD  # left padding
    r = rng.integers(3, vocab, (rows, T)).astype(np.int32)
    pm = np.zeros((rows, T), bool)
    pm[2, 4:] = True
    r[pm] = PAD
    old = (rng.standard_normal((rows, T)) * 0.3 - 4).astype(np.float32)
    return {
        "query_responses": np.concatenate([q, r], 1),
        "responses": r,
        "logprobs": np.where(pm, 1.0, old).astype(np.float32),
        "ref_logprobs": np.where(pm, 1.0, old + 0.1).astype(np.float32),
        "advantages": np.where(pm, 0.0, rng.standard_normal((rows, T))).astype(np.float32),
        "padding_mask": pm,
        "padding_mask_p1": pm,
    }


def _adam_states(opt_state):
    """The ScaleByAdamState of the policy group inside the trainer's
    multi_transform (the value group's holds no arrays on a GRPO run)."""
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState) and jax.tree_util.tree_leaves(s.mu)]


def _drop_none(tree):
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


CASES = {
    # name: (model kind, attention_impl, gradient_checkpointing, max_grad_norm)
    "tied_remat": ("qwen_tied", "xla", True, None),
    "tied_no_remat_clip": ("qwen_tied", "xla", False, 0.05),
    "untied_remat": ("llama_untied", "xla", True, None),
    "tied_remat_flash": ("qwen_tied", "pallas", True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_minibatch_matches_jax_update_fn(case, tmp_path):
    kind, impl, remat, clip = CASES[case]
    jcfg, cfg = _configs(tmp_path, gradient_checkpointing=remat, max_grad_norm=clip)
    jmodel = jax_config(kind, vocab_size=64, attention_impl=impl)
    mcfg = port_config(jmodel)
    jparams, tparams = make_params(jmodel, seed=11)
    tok = JaxToyTokenizer(vocab_size=64)
    jtr = JaxRLTrainer(jcfg, jmodel, tok, jparams, jax_load_dataset("synthetic:64", tok),
                       lambda texts, eos: np.zeros(len(texts), np.float32),
                       mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    rows = cfg.local_mini_batch_size
    mbs = [_minibatch(s, rows, 64) for s in (1, 2)]

    try:
        trainable, frozen = jtr._partition(jtr._train_tree(jtr.params, None))
        opt_state = jtr.opt_state
        jstats = []
        for mb in mbs:
            trainable, opt_state, st = jtr._update_fn(
                trainable, frozen, opt_state, {k: jnp.asarray(v) for k, v in mb.items()},
                CTX)
            jstats.append(jax.device_get(st))
    finally:
        jtr.close()  # uninstalls its SIGTERM guard, flushes its files

    port_train = _trainable_leaves(
        tparams, trainable_mask(tparams, LoraConfig(r=LORA.r, alpha=LORA.alpha)))
    before = {p: t.clone() for p, t in flatten(port_train).items()}
    for t in flatten(port_train).values():
        t.requires_grad_(True)
    opt = build_optimizer(cfg)
    state = opt.init(port_train)
    stats = []
    for mb in mbs:
        state, st = update_minibatch(tparams, port_train, opt, state,
                                     {k: torch.as_tensor(v) for k, v in mb.items()},
                                     mcfg, cfg, CTX, PAD, LORA.scale)
        stats.append(st)

    want_params = _drop_none(jax.tree.map(np.asarray, trainable)["policy"])
    got_params = params_to_numpy(port_train)
    assert flatten(got_params).keys() == flatten(want_params).keys()
    (adam,) = _adam_states(opt_state)
    assert int(adam.count) == state.count == 2
    for got, want, atol in ((got_params, want_params, 1e-5),
                            (params_to_numpy(state.mu), _drop_none(adam.mu["policy"]), 1e-6),
                            (params_to_numpy(state.nu), _drop_none(adam.nu["policy"]), 1e-9)):
        want = flatten(jax.tree.map(np.asarray, want))
        for path, g in flatten(got).items():
            np.testing.assert_allclose(g, want[path], atol=atol, rtol=1e-4,
                                       err_msg="/".join(path))
    for st, jst in zip(stats, jstats):
        assert set(st) == set(jst)
        for k in jst:
            np.testing.assert_allclose(st[k], float(jst[k]), atol=1e-6, rtol=1e-5,
                                       err_msg=k)
    assert stats[0]["grad_norm"] > 0
    assert all(not torch.equal(t.detach(), before[p])
               for p, t in flatten(port_train).items() if p[-1] == "b")


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    total, lr, alpha = 20, 6e-6, 0.1
    sched = lr_schedule(lr, total, alpha, warmup)
    if warmup:
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, lr * alpha)
    else:
        ref = optax.cosine_decay_schedule(lr, total, alpha=alpha)
    for step in range(total + 3):
        np.testing.assert_allclose(sched(step), float(ref(step)), rtol=1e-6, atol=0)


def test_adamw_matches_optax_on_random_leaves():
    """Three AdamW steps with weight decay and global-norm clipping on bf16
    leaves (the card's dtype): optax promotes the moments to f32 after the
    first update, the port keeps them f32 from the start."""
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), leaves)
             for _ in range(3)]
    sched = lr_schedule(1e-2, 10, 0.1)
    from nanorlhf_tpu_torch.trainer.optim import AdamW

    opt = AdamW(sched, eps=1e-6, weight_decay=0.1, max_grad_norm=1.0)
    params = jax.tree.map(lambda x: torch.as_tensor(x).to(torch.bfloat16), leaves)
    state = opt.init(params)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(1e-2, 10, alpha=0.1),
                                 eps=1e-6, weight_decay=0.1))
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), leaves)
    jstate = tx.init(jparams)
    for g in grads:
        state = opt.step(params, jax.tree.map(torch.as_tensor, g), state)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for path, t in flatten(params).items():
        want = np.asarray(flatten(jparams)[path].astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), want, atol=0, rtol=0,
                                   err_msg="/".join(path))
    assert dataclasses.is_dataclass(state) and state.count == 3
