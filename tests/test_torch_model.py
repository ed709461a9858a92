"""The port's decoder (nanorlhf_tpu_torch/core/model.py) against the JAX
package's on tiny f32 models: same weights through bridge.py, same inputs,
outputs within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KINDS, LORA, jax_config, left_pad, make_params, port_config
from nanorlhf_tpu.core import model as jm
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_from_numpy, params_to_numpy
from nanorlhf_tpu_torch.core import model as tm

torch.set_num_threads(1)

ATOL = 1e-5
PAD = 0


def _qr():
    rng = np.random.default_rng(3)
    rows = [rng.integers(1, 128, n).tolist() for n in (9, 6, 11)]
    return left_pad(rows, 12, PAD)


def test_bridge_roundtrip():
    jcfg = jax_config("llama_untied")
    jparams, tparams = make_params(jcfg)
    back = params_to_numpy(tparams)
    import jax

    want = jax.tree.map(np.asarray, jparams)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])
    # the port's orientation: kernels [L, out, in], lm_head [V, D]
    assert tuple(tparams["layers"]["q_proj"]["kernel"].shape) == (2, 64, 64)
    assert tuple(tparams["layers"]["gate_proj"]["kernel"].shape) == (2, 128, 64)
    assert tuple(tparams["lm_head"].shape) == (128, 64)
    assert tuple(tparams["lora"]["layers"]["down_proj"]["a"].shape) == (2, LORA.r, 128)


@pytest.mark.parametrize("kind", KINDS)
def test_init_params_layout(kind):
    jcfg = jax_config(kind)
    jparams, _ = make_params(jcfg, lora=False)
    mine = tm.init_params(port_config(jcfg), seed=0, dtype=torch.float32, device="cpu")
    import jax

    want = jax.tree.map(lambda a: np.asarray(a).shape, jparams)
    got = params_to_numpy(mine)
    got = jax.tree.map(lambda a: a.shape, got)
    assert got == want


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ctx", [None, 5])
def test_padded_forward_logits(kind, impl, ctx):
    jcfg = jax_config(kind, attention_impl=impl)
    jparams, tparams = make_params(jcfg)
    qr = _qr()
    scale = LORA.scale
    want = jm.padded_forward_logits(jparams, jcfg, jnp.asarray(qr), PAD,
                                    lora_scale=scale, response_context_length=ctx)
    got = tm.padded_forward_logits(tparams, port_config(jcfg), torch.as_tensor(qr),
                                   PAD, lora_scale=scale, response_context_length=ctx)
    # left-pad query rows see no valid key: their logits are unconstrained
    # garbage on the flash path (as in JAX), so only real positions count
    real = (qr != PAD) if ctx is None else (qr[:, ctx - 1:-1] != PAD)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_padded_forward_hidden_and_unembedding(kind):
    jcfg = jax_config(kind)
    jparams, tparams = make_params(jcfg)
    qr = _qr()
    cfg = port_config(jcfg)
    want = jm.padded_forward_hidden(jparams, jcfg, jnp.asarray(qr), PAD,
                                    lora_scale=LORA.scale, response_context_length=4)
    got = tm.padded_forward_hidden(tparams, cfg, torch.as_tensor(qr), PAD,
                                   lora_scale=LORA.scale, response_context_length=4)
    real = qr[:, 3:-1] != PAD  # left-pad rows are unconstrained garbage
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL, rtol=0)
    w, transposed = tm.unembedding(cfg, tparams)
    assert transposed and tuple(w.shape) == (cfg.vocab_size, cfg.hidden_size)
    np.testing.assert_allclose(
        (got @ tm.unembedding_weight(cfg, tparams)).numpy()[real],
        np.asarray(jnp.asarray(want) @ jm.unembedding_weight(jcfg, jparams))[real],
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_decode_chain(kind, impl):
    """prefill + 3 decode steps: last-position and decode-step logits."""
    jcfg = jax_config(kind, attention_impl=impl)
    cfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg)
    rng = np.random.default_rng(5)
    rows = [rng.integers(1, 128, n).tolist() for n in (7, 4)]
    ids = left_pad(rows, 8, PAD)
    mask = ids != PAD
    B, Tp, n_steps = 2, 8, 3
    T_max = Tp + n_steps + 2
    scale = LORA.scale
    jc = jm.init_kv_cache(jcfg, B, T_max, jnp.float32)
    jl, jc = jm.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), jc,
                        lora_scale=scale)
    tc = tm.init_kv_cache(cfg, B, T_max, torch.float32, "cpu")
    tl, tc = tm.prefill(tparams, cfg, torch.as_tensor(ids).long(),
                        torch.as_tensor(mask), tc, lora_scale=scale)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # cached K/V at the real prompt slots (left-pad slots are never read:
    # their layer-2 values come from garbage pad rows on the flash path)
    for got_c, want_c in zip(tc, jc):
        np.testing.assert_allclose(
            got_c.numpy()[:, :, :, :Tp].transpose(1, 3, 0, 2, 4)[mask],
            np.asarray(want_c)[:, :, :, :Tp].transpose(1, 3, 0, 2, 4)[mask],
            atol=ATOL, rtol=0)

    key_mask = np.zeros((B, T_max), bool)
    key_mask[:, :Tp] = mask
    prompt_len = mask.sum(1)
    tok = np.array(jnp.argmax(jl, axis=-1))
    for step in range(1, n_steps + 1):
        slot = Tp + step - 1
        key_mask[:, slot] = True
        pos = prompt_len + step - 1
        jl, jc = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                slot, jnp.asarray(key_mask), jc, lora_scale=scale)
        tl, tc = tm.decode_step(tparams, cfg, torch.as_tensor(tok).long(),
                                torch.as_tensor(pos).long(), slot,
                                torch.as_tensor(key_mask), tc, lora_scale=scale)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        tok = np.array(jnp.argmax(jl, axis=-1))
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}


def test_unported_paths_raise():
    jcfg = jax_config("qwen_tied")
    cfg = port_config(jcfg)
    import dataclasses

    # the int8 KV cache, ported by the paged / int8 slice: JAX's layout minus
    # the [.., 8, T] sublane expansion of the scales, which the port drops
    from nanorlhf_tpu.core.model import init_kv_cache as jax_init_kv_cache

    q8 = tm.init_kv_cache(dataclasses.replace(cfg, kv_cache_quant="int8"), 1, 4,
                          torch.float32, "cpu")
    want = jax_init_kv_cache(dataclasses.replace(jcfg, kv_cache_quant="int8"), 1, 4)
    assert [t.dtype for t in q8] == [torch.int8, torch.bfloat16] * 2
    for got, ref in zip(q8, want):
        ref = np.asarray(ref, np.float32)
        if ref.ndim == 5 and got.dim() == 4:  # scales: [L, B, KV, 8, T]
            ref = ref[:, :, :, 0, :]
        np.testing.assert_array_equal(got.float().numpy(), ref)
    with pytest.raises(ValueError):
        tm.init_kv_cache(dataclasses.replace(cfg, kv_cache_quant="int4"), 1, 4,
                         torch.float32, "cpu")
    # int8 weight-only projections (kernel_q) raised here until they were
    # ported: tests/test_torch_quant.py holds them against JAX
    with pytest.raises(ValueError):
        tm.use_kernel("flash", torch.zeros(1))


def test_bf16_bridge_casts():
    jcfg = jax_config("qwen_tied")
    jparams, _ = make_params(jcfg, lora=False)
    import jax

    t = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.bfloat16)
    assert t["embed_tokens"].dtype == torch.bfloat16
    assert t["layers"]["q_proj"]["kernel"].is_contiguous()
