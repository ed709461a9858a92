"""PPO's value model in the port against the JAX package, on the tiny f32
models: `score_forward` through the plain route and through the flash
route (the JAX Pallas kernel in interpret mode against the port's
autograd Function with its plain backward), the value tree and its
trainable mask against `make_value_params` + the trainer's mask (a copy
that shares no storage with the policy), the score head's [D, 1] layout
through the bridge, and `finetune_value_model` against JAX's on the same
fixed responses."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    KINDS,
    LORA,
    closes_trainers,
    jax_config,
    make_params,
    port_config,
)
from nanorlhf_tpu.core.lora import init_lora_params as jax_init_lora_params
from nanorlhf_tpu.core.lora import trainable_mask as jax_trainable_mask
from nanorlhf_tpu.core.model import score_forward as jax_score_forward
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.data import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.entrypoints.ppo import make_value_params as jax_make_value_params
from nanorlhf_tpu.trainer import value_init as jax_value_init
from nanorlhf_tpu.trainer.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.core.lora import LoraConfig, value_trainable_mask
from nanorlhf_tpu_torch.data.datasets import load_prompt_dataset
from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
from nanorlhf_tpu_torch.entrypoints import common, ppo
from nanorlhf_tpu_torch.entrypoints.grpo import one_card_cut
from nanorlhf_tpu_torch.trainer import value_init
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)

PAD, EOS = 0, 1


def _value_tree(jcfg, seed):
    """A JAX-layout numpy value tree: the tiny policy's backbone, a random
    [D, 1] score head and a LoRA subtree with B away from zero."""
    jparams, _ = make_params(jcfg, seed=seed, lora=False)
    tree = jax.tree.map(np.asarray, {k: v for k, v in jparams.items() if k != "lm_head"})
    rng = np.random.default_rng(seed + 7)
    tree["score"] = (rng.standard_normal((jcfg.hidden_size, 1)) * 0.1).astype(np.float32)
    lora = jax.tree.map(np.asarray, jax_init_lora_params(
        jcfg, LORA, jax.random.PRNGKey(seed + 3), dtype=jnp.float32))
    for ab in lora["layers"].values():
        ab["b"] = rng.normal(0, 0.02, ab["b"].shape).astype(np.float32)
    tree["lora"] = lora
    return tree


def _ids(seed, B=3, T=11, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (B, T)).astype(np.int32)
    ids[1, :4] = PAD   # left padding
    ids[2, -3:] = PAD  # a response that ended early
    return ids


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_score_forward_matches_jax(kind, impl):
    jcfg = jax_config(kind, attention_impl=impl)
    tree = _value_tree(jcfg, seed=5)
    ids = _ids(1)
    want = np.asarray(jax_score_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                        jnp.asarray(ids), PAD, lora_scale=LORA.scale))
    got = tm.score_forward(params_from_numpy(tree), port_config(jcfg),
                           torch.as_tensor(ids), PAD, lora_scale=LORA.scale)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 11, 1)
    # a left pad's query sees no key: the Pallas kernel writes zeros there
    # and the plain versions a uniform average; no caller reads those
    # positions (every slice starts at the context's last token)
    seen = np.cumsum(ids != PAD, axis=1) > 0
    np.testing.assert_allclose(got.numpy()[seen], want[seen], atol=1e-5, rtol=1e-5)


def test_score_forward_gradient_through_the_flash_route():
    """The port's flash autograd Function (its plain backward on the CPU)
    gives the plain route's score-head, LoRA and embedding gradients."""
    jcfg = jax_config("qwen_tied", attention_impl="pallas")
    tree = _value_tree(jcfg, seed=6)
    ids = torch.as_tensor(_ids(2))
    seen = torch.cumsum((ids != PAD).int(), dim=1) > 0  # as in the test above
    grads = {}
    for impl in ("xla", "pallas"):
        p = params_from_numpy(tree)
        leaves = [p["score"], p["embed_tokens"], p["lora"]["layers"]["q_proj"]["b"]]
        for t in leaves:
            t.requires_grad_(True)
        cfg = port_config(jax_config("qwen_tied", attention_impl=impl))
        out = tm.score_forward(p, cfg, ids, PAD, lora_scale=LORA.scale, remat=True)
        grads[impl] = torch.autograd.grad(out[..., 0][seen].square().sum(), leaves)
    # f32 with the two routes' own summation orders: 1e-5 of each
    # gradient's scale
    for a, b in zip(grads["xla"], grads["pallas"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_score_head_layout_through_the_bridge():
    """`score` is [D, num_labels] in both trees: the bridge passes it
    through, untransposed, both ways."""
    mcfg = port_config(jax_config("qwen_tied"))
    head = tm.init_score_head(mcfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    assert head.shape == (mcfg.hidden_size, 1)
    np.testing.assert_array_equal(params_to_numpy({"score": head})["score"], head.numpy())
    a = np.arange(mcfg.hidden_size * 2, dtype=np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(params_from_numpy({"score": a})["score"].numpy(), a)
    # N(0, 1/D), as JAX's
    big = tm.init_score_head(mcfg.__class__(**{**mcfg.__dict__, "hidden_size": 4096}),
                             torch.Generator().manual_seed(1), dtype=torch.float32)
    assert abs(float(big.std()) * 64 - 1) < 0.05


@pytest.mark.parametrize("kind", KINDS)
def test_value_tree_and_mask_match_jax(kind):
    jcfg = jax_config(kind)
    jparams, tparams = make_params(jcfg, seed=8)
    jvalue = jax_make_value_params(jcfg, jparams)
    value = ppo.make_value_params(port_config(jcfg), tparams)
    assert flatten(value).keys() == flatten(params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jvalue))).keys()
    pol = flatten(tparams)
    for path, t in flatten(value).items():
        if path != ("score",):
            assert torch.equal(t, pol[path]), path
            assert t.untyped_storage().data_ptr() != pol[path].untyped_storage().data_ptr()
    assert value["score"].shape == jvalue["score"].shape
    # the trainer's value mask (LoRA adapters, score head, embeddings)
    value["lora"] = params_from_numpy(jax.tree.map(np.asarray, jax_init_lora_params(
        jcfg, LORA, jax.random.PRNGKey(0), dtype=jnp.float32)))
    jvalue = {**jvalue, "lora": jax_init_lora_params(jcfg, LORA, jax.random.PRNGKey(0))}
    fake = types.SimpleNamespace(lora_cfg=LORA, value_lora_cfg=LORA)
    want = JaxRLTrainer._trainable_tree_mask(fake, {"policy": jparams, "value": jvalue})
    got = value_trainable_mask(value, LoraConfig(r=LORA.r, alpha=LORA.alpha))
    assert flatten(got) == {p: bool(m) for p, m in flatten(want["value"]).items()}
    # without value LoRA every leaf trains
    full = flatten(value_trainable_mask(value, None))
    assert all(full.values())
    assert full.keys() == flatten(jax_trainable_mask(jvalue, None)).keys()


def _tiny_ppo(tmp_path, **over):
    cfg = one_card_cut(ppo.build_ppo_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "run")
    cfg.response_length = 5
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 16
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.value_lora_r, cfg.value_lora_alpha = 4, 8
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def test_aliased_value_tree_is_copied_by_the_trainer(tmp_path):
    """A value tree that aliases the policy's leaves (its embeddings would
    then step the policy's) is copied on intake: no leaf of the value tree
    shares storage with the policy or the ref, and a PPO update leaves the
    policy's frozen base where it was."""

    def aliased(mcfg, params):
        return {**{k: v for k, v in params.items() if k not in ("lm_head", "lora")},
                "score": tm.init_score_head(mcfg, torch.Generator().manual_seed(1),
                                            dtype=params["embed_tokens"].dtype)}

    tr = common.build_trainer(_tiny_ppo(tmp_path), device="cpu", value_params_fn=aliased)
    taken = {t.untyped_storage().data_ptr()
             for tree in (tr.params, tr.ref_params) for t in flatten(tree).values()}
    assert not any(t.untyped_storage().data_ptr() in taken
                   for t in flatten(tr.value_params).values())
    base = {p: t.detach().clone() for p, t in flatten(tr.params).items() if p[0] != "lora"
            and p != ("embed_tokens",)}
    tr.reward_func = lambda texts, eos: np.asarray([len(t) % 5 for t in texts], np.float32)
    tr.train(num_updates=1)
    after = flatten(tr.params)
    assert all(torch.equal(after[p], t) for p, t in base.items())
    tr.close()


def _fixed_responses(N, R, vocab, seed=4):
    rng = np.random.default_rng(seed)
    out = rng.integers(3, vocab, (N, R)).astype(np.int32)
    for i in range(0, N, 3):
        out[i, 2 + i % (R - 2)] = EOS  # some rows stop early
    return out


def test_finetune_value_model_matches_jax(monkeypatch):
    """Both initializers see the same fixed responses (their `generate`
    patched), so the same rewards, returns, split and permutations; the
    regressed value trees agree leaf for leaf."""
    jcfg = jax_config("qwen_tied")
    mcfg = port_config(jcfg)
    jpolicy, tpolicy = make_params(jcfg, seed=9)
    jref = {k: v for k, v in jpolicy.items() if k != "lora"}
    tref = {k: v for k, v in tpolicy.items() if k != "lora"}
    vtree = _value_tree(jcfg, seed=10)
    tok, jtok = ToyTokenizer(128), JaxToyTokenizer(128)
    prompts = load_prompt_dataset("synthetic:16", tok).input_ids[:12]
    # the toy tokenizers learn their words as they encode
    np.testing.assert_array_equal(jax_load_dataset("synthetic:16", jtok).input_ids[:12],
                                  prompts)
    R = 6
    fixed = _fixed_responses(prompts.shape[0], R, 128)

    def reward(texts, eos):
        return np.asarray([0.3 * (len(t) % 7) + (eos in t) for t in texts], np.float32)

    monkeypatch.setattr(value_init, "generate", lambda p, c, ids, *a, **k: torch.as_tensor(
        fixed[:ids.shape[0]], dtype=torch.int64))
    monkeypatch.setattr(jax_value_init, "generate",
                        lambda p, c, ids, *a, **k: jnp.asarray(fixed[:ids.shape[0]]))
    kw = dict(response_length=R, temperature=0.7, kl_coef=0.05, gamma=0.9,
              whiten_rewards=True, lora_scale=LORA.scale)
    vcfg = dict(train_data_size=10, num_train_epochs=4, per_device_train_batch_size=3,
                learning_rate=3e-3)
    jout = jax_value_init.finetune_value_model(
        jax.tree.map(jnp.asarray, vtree), jpolicy, jref, reward, prompts, jtok, jcfg,
        vcfg=jax_value_init.ValueInitConfig(**vcfg), value_lora_cfg=LORA, **kw)
    tvalue = params_from_numpy(vtree)
    out = value_init.finetune_value_model(
        tvalue, tpolicy, tref, reward, prompts, tok, mcfg,
        vcfg=value_init.ValueInitConfig(**vcfg),
        value_lora_cfg=LoraConfig(r=LORA.r, alpha=LORA.alpha), **kw)
    assert out is tvalue
    want = flatten(jax.tree.map(np.asarray, jout))
    got = flatten(params_to_numpy(out))
    assert got.keys() == want.keys()
    moved = 0
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))
        moved += not np.array_equal(g, flatten(vtree)[path])
    # the adapters' B, the score head and the embeddings trained
    assert moved >= 3 and not np.array_equal(got[("score",)], vtree["score"])
