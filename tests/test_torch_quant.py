"""Int8 weight-only rollout weights (nanorlhf_tpu_torch/core/quant.py and
the `kernel_q` form of the model's projections) against the JAX package's
`core/quant.py`, on the CPU:

- `quantize_kernel` / `quantize_layers` bit for bit against JAX's as its
  trainer runs them, under `jax.jit` (where XLA turns the scale's division
  by 127 into a product with the f32 reciprocal: eager JAX differs from it
  by an ulp of some scales), through the bridge (JAX's `[L, in, out]`
  against the port's `[L, out, in]`), ties rounding half to even, an
  all-zero channel;
- the quantized forward, prefill and decode steps against JAX's quantized
  model (f32: 1e-5), and JAX's own closeness test of the quantized logits
  to the exact ones;
- int8-weight greedy streams equal to JAX's, on the contiguous and the
  paged cache and with the int8 KV cache;
- the trainer: the view generation samples from (int8 base, live LoRA),
  scoring on the exact weights, quantized once under LoRA and anew from
  the updated base before each rollout under full fine-tuning, and again
  after a resume; an unknown `rollout_quant` raises ValueError."""

import dataclasses

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
    left_pad,
    make_params,
    port_config,
)
from nanorlhf_tpu.core import model as jm
from nanorlhf_tpu.core import quant as jq
from nanorlhf_tpu.sampler import sampler as js
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.core import quant as tq
from nanorlhf_tpu_torch.entrypoints.grpo import build_config
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer.optim import flatten, unflatten
from nanorlhf_tpu_torch.trainer.rollout import check_supported
from test_torch_trainer import _trainer

torch.set_num_threads(1)

ATOL = 1e-5
PAD, EOS = 0, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 48, 40), (3, 16, 96)])
def test_quantize_kernel_matches_jax_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 3, shape[-1])
    w[0, :, 5] = 0.0  # an all-zero output channel: the 1e-12 scale floor
    # a channel of absmax 127 (scale 1): x.5 ties round half to even
    w[1, :, 7] = np.resize([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5], shape[1])
    jw = jnp.asarray(w, dtype=jnp.dtype(dtype))
    jq_, js_ = jax.jit(jq.quantize_kernel)(jw)
    tw = params_from_numpy({"kernel": np.asarray(jw.astype(jnp.float32))})["kernel"]
    tw = tw.to(getattr(torch, dtype))
    q, scale = tq.quantize_kernel(tw)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == np.asarray(js_).shape == (shape[0], 1, shape[2])
    np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), np.asarray(jq_))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js_))
    assert np.asarray(jq_)[1, 1, 7] == 2 and np.asarray(jq_)[1, 2, 7] == -4
    back = tq.dequantize_kernel(q, scale, torch.float32)
    np.testing.assert_array_equal(
        np.swapaxes(back.numpy(), -1, -2),
        np.asarray(jq.dequantize_kernel(jq_, js_, jnp.float32)))


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_layers_through_the_bridge(kind):
    """The port's quantized layer tree equals JAX's carried through
    `params_from_numpy` (kernel_q transposed, kernel_scale as is); every
    other leaf passes through by reference."""
    jcfg = jax_config(kind)
    jparams, tparams = make_params(jcfg, lora=False)
    want = params_from_numpy(_np(jq.quantize_layers(jparams["layers"])))
    got = tq.quantize_layers(tparams["layers"])
    assert got.keys() == want.keys()
    for name, entry in got.items():
        if name in tq.QUANT_PROJS:
            assert "kernel" not in entry and entry["kernel_q"].dtype == torch.int8
            for leaf in entry:
                assert torch.equal(entry[leaf], want[name][leaf]), (name, leaf)
            assert set(entry) == set(want[name])
            if "bias" in entry:
                assert entry["bias"] is tparams["layers"][name]["bias"]
        else:
            assert entry is tparams["layers"][name]
    back = params_to_numpy({"layers": got})["layers"]
    for name in tq.QUANT_PROJS:
        np.testing.assert_array_equal(back[name]["kernel_q"],
                                      np.asarray(jq.quantize_layers(
                                          jparams["layers"])[name]["kernel_q"]))
    view = tq.rollout_view(tparams, got)
    assert view["layers"] is got and view["embed_tokens"] is tparams["embed_tokens"]


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_forward_matches_jax(kind, lora):
    jcfg = jax_config(kind)
    cfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=4, lora=lora)
    jview = jq.rollout_view(jparams, jq.quantize_layers(jparams["layers"]))
    tview = tq.rollout_view(tparams, tq.quantize_layers(tparams["layers"]))
    rng = np.random.default_rng(3)
    qr = left_pad([rng.integers(1, 128, n).tolist() for n in (9, 6, 11)], 12, PAD)
    scale = LORA.scale if lora else 1.0
    want = jm.padded_forward_logits(jview, jcfg, jnp.asarray(qr), PAD, lora_scale=scale)
    got = tm.padded_forward_logits(tview, cfg, torch.as_tensor(qr), PAD, lora_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # JAX's own check (tests/test_quant.py): int8-noise-level logits, greedy
    # argmax mostly unchanged
    exact = tm.padded_forward_logits(tparams, cfg, torch.as_tensor(qr), PAD,
                                     lora_scale=scale)
    rel = float((exact - got).abs().max() / (exact.abs().max() + 1e-6))
    assert 0 < rel < 0.05
    assert float((exact.argmax(-1) == got.argmax(-1)).float().mean()) >= 0.9


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_prefill_and_decode_match_jax(kind):
    jcfg = jax_config(kind)
    cfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=6)
    jview = jq.rollout_view(jparams, jq.quantize_layers(jparams["layers"]))
    tview = tq.rollout_view(tparams, tq.quantize_layers(tparams["layers"]))
    rng = np.random.default_rng(8)
    ids = left_pad([rng.integers(4, 128, n).tolist() for n in (5, 8)], 8, PAD)
    B, Tp = ids.shape
    T_max, mask = Tp + 4, ids != PAD
    jl, jc = jm.prefill(jview, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                        jm.init_kv_cache(jcfg, B, T_max, jnp.float32),
                        lora_scale=LORA.scale)
    tl, tc = tm.prefill(tview, cfg, torch.as_tensor(ids).long(), torch.as_tensor(mask),
                        tm.init_kv_cache(cfg, B, T_max, torch.float32, "cpu"),
                        lora_scale=LORA.scale)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    key_mask = np.zeros((B, T_max), bool)
    key_mask[:, :Tp] = mask
    tok = np.array(jnp.argmax(jl, axis=-1))
    for step in range(1, 4):
        slot = Tp + step - 1
        key_mask[:, slot] = True
        pos = mask.sum(1) + step - 1
        jl, jc = jm.decode_step(jview, jcfg, jnp.asarray(tok), jnp.asarray(pos), slot,
                                jnp.asarray(key_mask), jc, lora_scale=LORA.scale)
        tl, tc = tm.decode_step(tview, cfg, torch.as_tensor(tok).long(),
                                torch.as_tensor(pos).long(), slot,
                                torch.as_tensor(key_mask), tc, lora_scale=LORA.scale)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        tok = np.array(jnp.argmax(jl, axis=-1))


GREEDY_ROUTES = {
    # name: (kv_cache_quant, page_size, decode_rows)
    "contiguous": ("none", 0, 0),
    "paged": ("none", 5, 0),
    "queued": ("none", 4, 3),
    "int8_kv": ("int8", 0, 0),
    "int8_kv_paged": ("int8", 5, 0),
}


@pytest.mark.parametrize("route", sorted(GREEDY_ROUTES))
def test_int8_weight_greedy_rollout_matches_jax_on_every_layout(route):
    """Greedy streams from the int8 view: each layout equal to the
    contiguous one (tokens exactly, logprobs 1e-5) and to JAX's greedy
    stream from its own int8 view of the same weights."""
    kv, page, rows = GREEDY_ROUTES[route]
    jcfg = dataclasses.replace(jax_config("qwen_tied"), kv_cache_quant=kv)
    cfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=11)
    jview = jq.rollout_view(jparams, jq.quantize_layers(jparams["layers"]))
    tview = tq.rollout_view(tparams, tq.quantize_layers(tparams["layers"]))
    rng = np.random.default_rng(5)
    ids = left_pad([rng.integers(4, 128, n).tolist() for n in (6, 8, 3)], 8, PAD)
    sp = dict(greedy=True, n=2, max_tokens=10, capture_logprobs=True)

    def port(**extra):
        return ts.generate(tview, cfg, torch.as_tensor(ids).long(),
                           torch.as_tensor(ids != PAD), torch.Generator().manual_seed(0),
                           ts.SamplingParams(**sp, **extra), eos_token_id=EOS,
                           pad_token_id=PAD, lora_scale=LORA.scale)

    got = port(page_size=page, decode_rows=rows)
    base = port()
    assert torch.equal(got[0], base[0])
    np.testing.assert_allclose(got[1].numpy(), base[1].numpy(), atol=ATOL, rtol=0)
    if not rows:
        want = js.generate(jview, jcfg, jnp.asarray(ids), jnp.asarray(ids != PAD),
                           jax.random.PRNGKey(0), js.SamplingParams(**sp, page_size=page),
                           eos_token_id=EOS, pad_token_id=PAD, lora_scale=LORA.scale)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL, rtol=0)
    # int8 weights change the stream of the exact model somewhere
    exact = ts.generate(tparams, cfg, torch.as_tensor(ids).long(),
                        torch.as_tensor(ids != PAD), torch.Generator().manual_seed(0),
                        ts.SamplingParams(**sp), eos_token_id=EOS, pad_token_id=PAD,
                        lora_scale=LORA.scale)
    assert not torch.equal(exact[1], base[1])
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}


def _assert_view_of(tr, view):
    """`view` is the int8 view of the trainer's live policy: quantized from
    its current base, LoRA / embeddings / norms its own tensors."""
    want = tq.quantize_layers(tr.params["layers"])
    for name in tq.QUANT_PROJS:
        for leaf in ("kernel_q", "kernel_scale"):
            assert torch.equal(view["layers"][name][leaf], want[name][leaf]), (name, leaf)
    assert all(view[k] is tr.params[k] for k in tr.params if k != "layers")


@pytest.mark.parametrize("use_lora", [True, False])
def test_trainer_int8_rollout(tmp_path, monkeypatch, use_lora):
    """Two updates with int8 rollout weights: generation samples from the
    int8 view, scoring and the update from the exact tree; under LoRA the
    base is quantized once (the same tensors every rollout), under full
    fine-tuning anew from the updated base before each rollout."""
    seen = []
    real_gen, real_score = trollout.generate, trollout.score_chunk

    def gen(params, *a, **kw):
        seen.append(("generate", params))
        return real_gen(params, *a, **kw)

    def score(params, *a, **kw):
        seen.append(("score", params))
        return real_score(params, *a, **kw)

    monkeypatch.setattr(trollout, "generate", gen)
    monkeypatch.setattr(trollout, "score_chunk", score)
    tr = _trainer(tmp_path, rollout_quant="int8", use_lora=use_lora)
    try:
        first = tr._quant_layers
        assert first["q_proj"]["kernel_q"].dtype == torch.int8
        bases = []
        for _ in range(2):
            bases.append({p: t.detach().clone() for p, t in flatten(tr.params).items()
                          if p[0] == "layers"})
            tr.train(num_updates=1)
        assert tr.state["global_step"] == 2
        gens = [p for what, p in seen if what == "generate"]
        scores = [p for what, p in seen if what == "score"]
        assert len(gens) == 2 and scores
        for view in gens:
            assert "kernel" not in view["layers"]["q_proj"]
            assert view["lora" if use_lora else "embed_tokens"] is \
                tr.params["lora" if use_lora else "embed_tokens"]
        assert all(p is tr.params for p in scores)
        moved = any(not torch.equal(t, bases[1][p])
                    for p, t in flatten(tr.params).items() if p[0] == "layers")
        if use_lora:
            assert tr._quant_layers is first and not moved
            assert gens[0]["layers"] is gens[1]["layers"] is first
        else:
            # the base moved in update 1: rollout 2 sampled from its new
            # quantization, not the first one
            assert moved and gens[1]["layers"] is not gens[0]["layers"]
            q1 = tq.quantize_layers(unflatten(bases[1])["layers"])
            for name in tq.QUANT_PROJS:
                assert torch.equal(gens[1]["layers"][name]["kernel_q"], q1[name]["kernel_q"])
            assert any(not torch.equal(gens[1]["layers"][n]["kernel_q"],
                                       gens[0]["layers"][n]["kernel_q"])
                       for n in tq.QUANT_PROJS)
        _assert_view_of(tr, tr._rollout_params())
    finally:
        tr.close()


def test_int8_view_requantized_after_resume(tmp_path):
    """Full fine-tuning: a fresh trainer resumed from the checkpoint of one
    update samples from the quantization of the restored base, not of its
    own initial weights."""
    tr = _trainer(tmp_path, rollout_quant="int8", use_lora=False, save_steps=1)
    try:
        tr.train(num_updates=1)
        trained = tr._rollout_params()
    finally:
        tr.close()
    fresh = _trainer(tmp_path, rollout_quant="int8", use_lora=False, save_steps=1)
    try:
        initial = fresh._quant_layers
        assert fresh.restore_checkpoint() == 1
        assert fresh._quant_layers is not initial
        _assert_view_of(fresh, tq.rollout_view(fresh.params, fresh._quant_layers))
        for name in tq.QUANT_PROJS:
            assert torch.equal(fresh._quant_layers[name]["kernel_q"],
                               trained["layers"][name]["kernel_q"])
        assert any(not torch.equal(fresh._quant_layers[n]["kernel_q"], initial[n]["kernel_q"])
                   for n in tq.QUANT_PROJS)
    finally:
        fresh.close()


def test_rollout_quant_values():
    cfg = build_config()
    cfg.rollout_quant = "int8"
    check_supported(cfg)
    cfg.rollout_quant = "int4"
    with pytest.raises(ValueError, match="rollout_quant"):
        check_supported(cfg)
