"""One optimizer step of the port's GRPO update (trainer/update.py,
trainer/optim.py) against the JAX trainer's jitted `_update_fn` on a tiny
single-device `RLTrainer`, in f32: the same bridged weights and LoRA init,
the same hand-made minibatch, two consecutive steps (bias correction and
the schedule's second value). Held: the new trainable leaves (LoRA and the
embeddings, which `LoraConfig` trains by default), the Adam moments, the
grad norm and the loss stats; with and without gradient checkpointing, and
through the flash-attention route (the Pallas kernels in interpret mode
against the port's autograd Function with its plain backward); under
remat_policy="dots" (selective checkpointing) and on the naive update
branch (`fused_logprob=False`: full logits, `chunked_entropy`), each held
to the same tolerances. Plus the learning-rate schedule against optax."""

import collections
import dataclasses

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
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.data import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.core.lora import LoraConfig, trainable_mask
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.optim import build_optimizer, flatten, lr_schedule
from nanorlhf_tpu_torch.trainer import update as tupdate
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


def _minibatch(seed, rows, vocab, loss_mask=False):
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
    } | ({"loss_mask": _obs_spans(rows, T)} if loss_mask == "spans"
         else {"loss_mask": rng.random((rows, T)) >= 0.3} if loss_mask == "random"
         else {})


def _obs_spans(rows, T):
    """An env loss mask: False on one observation span of each row, as the
    episode driver writes them (two tokens, after the first turn's two)."""
    mask = np.ones((rows, T), bool)
    for i in range(rows):
        mask[i, 2 + i % 2:4 + i % 2] = False
    return mask


def _to_dtype(tree, dtype):
    """`tree` with its floating tensors in `dtype` (`Tensor.to`), the rest as is."""
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


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
# the update's other routes, each a case: (model kind, attention_impl,
# gradient_checkpointing, the RLConfig knobs of the route)
ROUTES = {
    "dots_tied": ("qwen_tied", "xla", True, dict(remat_policy="dots")),
    "dots_untied": ("llama_untied", "xla", True, dict(remat_policy="dots")),
    "dots_flash": ("qwen_tied", "pallas", True, dict(remat_policy="dots")),
    "naive_tied_remat": ("qwen_tied", "xla", True, dict(fused_logprob=False)),
    "naive_untied_no_remat": ("llama_untied", "xla", False, dict(fused_logprob=False)),
    "naive_dots_flash": ("qwen_tied", "pallas", True,
                         dict(fused_logprob=False, remat_policy="dots")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_minibatch_matches_jax_update_fn(case, tmp_path):
    kind, impl, remat, clip = CASES[case]
    _check_update_against_jax(tmp_path, kind, impl, gradient_checkpointing=remat,
                              max_grad_norm=clip)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_update_routes_match_jax_update_fn(route, tmp_path, monkeypatch):
    kind, impl, remat, knobs = ROUTES[route]
    # f32 on the CPU cannot tell the routes apart by their values: count
    # which branch and which policy the port's update took
    calls = collections.Counter()

    def counting(name, fn):
        return lambda *a, **k: calls.update([name]) or fn(*a, **k)

    monkeypatch.setattr(tupdate, "chunked_entropy",
                        counting("naive", tupdate.chunked_entropy))
    monkeypatch.setattr(tupdate, "fused_response_logprobs",
                        counting("fused", tupdate.fused_response_logprobs))
    monkeypatch.setattr(tm, "_dots_policy", counting("dots", tm._dots_policy))
    _check_update_against_jax(tmp_path, kind, impl, gradient_checkpointing=remat,
                              **knobs)
    naive = not knobs.get("fused_logprob", True)
    assert (calls["naive"] > 0, calls["fused"] > 0) == (naive, not naive)
    assert (calls["dots"] > 0) == (knobs.get("remat_policy") == "dots")


@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
def test_update_with_env_loss_mask_matches_jax_update_fn(kind, tmp_path):
    """A multi-turn environment's `loss_mask` (False on observation tokens)
    in the minibatch: the port's update joins it to the pad mask as JAX's
    `_update_fn` does."""
    _check_update_against_jax(tmp_path, kind, "xla", gradient_checkpointing=True,
                              loss_mask="spans")


# a random loss mask (30% of the tokens off): the port's f32 update misses
# the shared rtol on one second moment of qwen_tied's embedding (rel 1.42e-4,
# 4.27326e-5 against JAX's 4.27387e-5). The port's own update in f64 lands
# at 4.27376e-5 there: 1.16e-4 from its f32 result (the port's f32 rounding,
# the same code) and 2.6e-5 from JAX's. So the port's update is held in f64
# at the shared tolerances, and in f32 with the second moments at this
# rtol (the two readings' sum, rounded up)
RANDOM_MASK_NU_RTOL = 2e-4


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
def test_update_with_random_loss_mask_matches_jax_update_fn(kind, precision, tmp_path,
                                                            monkeypatch):
    """A random `loss_mask` against JAX's `_update_fn` (RANDOM_MASK_NU_RTOL):
    in f64 (the port's `.float()` upcasts leave f64 as it is) at the shared
    tolerances, in f32 with the second moments at RANDOM_MASK_NU_RTOL."""
    if precision == "f64":
        upcast = torch.Tensor.float
        monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
            t if t.dtype == torch.float64 else upcast(t, *a, **k)))
    _check_update_against_jax(
        tmp_path, kind, "xla", gradient_checkpointing=True, loss_mask="random",
        port_dtype=torch.float64 if precision == "f64" else torch.float32,
        nu_rtol=1e-4 if precision == "f64" else RANDOM_MASK_NU_RTOL)


def _check_update_against_jax(tmp_path, kind, impl, loss_mask=False,
                              port_dtype=torch.float32, nu_rtol=1e-4, **knobs):
    """Two `update_minibatch` steps against two steps of the JAX trainer's
    `_update_fn` on the same bridged weights and minibatches (with an env
    `loss_mask`, "spans" or "random", when asked), the port's weights and
    minibatches in `port_dtype`."""
    jcfg, cfg = _configs(tmp_path, **knobs)
    jmodel = jax_config(kind, vocab_size=64, attention_impl=impl)
    # the trainer gives the model its run's remat policy (both packages)
    mcfg = dataclasses.replace(port_config(jmodel), remat_policy=cfg.remat_policy)
    jparams, tparams = make_params(jmodel, seed=11)
    tparams = _to_dtype(tparams, port_dtype)
    tok = JaxToyTokenizer(vocab_size=64)
    jtr = JaxRLTrainer(jcfg, jmodel, tok, jparams, jax_load_dataset("synthetic:64", tok),
                       lambda texts, eos: np.zeros(len(texts), np.float32),
                       mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]))
    rows = cfg.local_mini_batch_size
    mbs = [_minibatch(s, rows, 64, loss_mask) for s in (1, 2)]

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
    groups = opt.init({"policy": port_train})
    stats = []
    for mb in mbs:
        groups, st = update_minibatch(tparams, {"policy": port_train}, opt, groups,
                                      _to_dtype({k: torch.as_tensor(v) for k, v in mb.items()},
                                                port_dtype),
                                      mcfg, cfg, CTX, PAD, LORA.scale)
        stats.append(st)
    state = groups["policy"]

    want_params = _drop_none(jax.tree.map(np.asarray, trainable)["policy"])
    got_params = params_to_numpy(port_train)
    assert flatten(got_params).keys() == flatten(want_params).keys()
    (adam,) = _adam_states(opt_state)
    assert int(adam.count) == state.count == 2
    for got, want, atol in ((got_params, want_params, 1e-5),
                            (params_to_numpy(state.mu), _drop_none(adam.mu["policy"]), 1e-6),
                            (params_to_numpy(state.nu), _drop_none(adam.nu["policy"]), 1e-9)):
        want = flatten(jax.tree.map(np.asarray, want))
        rtol = nu_rtol if atol == 1e-9 else 1e-4
        for path, g in flatten(got).items():
            np.testing.assert_allclose(g, want[path], atol=atol, rtol=rtol,
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
