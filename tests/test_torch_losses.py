"""The GRPO loss and the helpers around it in the port (algos/losses.py,
algos/advantages.py, ops/masking.py, core/lora.trainable_mask) against the
JAX package, in f32 on numpy inputs made from a seed; plus the
distribution of the port's seeded draws (keep-1-of-N, the per-epoch
permutation), which match JAX's in distribution only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LORA, jax_config, make_params
from nanorlhf_tpu.algos import advantages as jadv
from nanorlhf_tpu.algos import losses as jlosses
from nanorlhf_tpu.core.lora import trainable_mask as jax_trainable_mask
from nanorlhf_tpu.ops import masking as jmask
from nanorlhf_tpu_torch.algos import advantages as tadv
from nanorlhf_tpu_torch.algos import losses as tlosses
from nanorlhf_tpu_torch.core.lora import LoraConfig, trainable_mask
from nanorlhf_tpu_torch.ops import masking as tmask
from nanorlhf_tpu_torch.trainer.rollout import KEEP_STREAM, PERM_STREAM, stream_generator

ATOL = 1e-6


def _loss_inputs(seed, B=5, T=11):
    rng = np.random.default_rng(seed)
    new = (rng.standard_normal((B, T)) * 0.3 - 2).astype(np.float32)
    old = (new + rng.standard_normal((B, T)) * 0.2).astype(np.float32)
    ref = (new + rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    adv = rng.standard_normal((B, T)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    mask[0] = False  # an all-pad row
    return new, old, ref, adv, mask


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cliprange,kl_coef", [(0.2, 0.01), (0.05, 0.3)])
def test_grpo_loss_and_aux_match_jax(seed, cliprange, kl_coef):
    new, old, ref, adv, mask = _loss_inputs(seed)
    loss, aux = tlosses.grpo_loss(*map(torch.as_tensor, (new, old, ref, adv, mask)),
                                  cliprange, kl_coef)
    jloss, jaux = jlosses.grpo_loss(*map(jnp.asarray, (new, old, ref, adv, mask)),
                                    cliprange, kl_coef)
    _close(loss, jloss)
    assert set(aux) == set(jaux)
    for k in jaux:
        _close(aux[k], jaux[k])


def test_grpo_loss_gradient_matches_jax():
    new, old, ref, adv, mask = _loss_inputs(3)
    tnew = torch.as_tensor(new).requires_grad_()
    loss, _ = tlosses.grpo_loss(tnew, *map(torch.as_tensor, (old, ref, adv, mask)), 0.2, 0.05)
    g = torch.autograd.grad(loss, tnew)[0]
    jg = jax.grad(lambda n: jlosses.grpo_loss(n, *map(jnp.asarray, (old, ref, adv, mask)),
                                              0.2, 0.05)[0])(jnp.asarray(new))
    _close(g, jg)


def test_ppo_clip_token_and_k3_match_jax():
    new, old, ref, adv, mask = _loss_inputs(4)
    loss, aux = tlosses.ppo_clip_loss_token(*map(torch.as_tensor, (new, old, adv, mask)), 0.2)
    jloss, jaux = jlosses.ppo_clip_loss_token(*map(jnp.asarray, (new, old, adv, mask)), 0.2)
    _close(loss, jloss)
    assert set(aux) == set(jaux)
    for k in jaux:
        _close(aux[k], jaux[k])
    _close(tlosses.k3_kl(torch.as_tensor(new), torch.as_tensor(ref)),
           jlosses.k3_kl(jnp.asarray(new), jnp.asarray(ref)))


def test_truncated_is_arguments_raise():
    new, old, ref, adv, mask = map(torch.as_tensor, _loss_inputs(5))
    with pytest.raises(NotImplementedError, match="truncated-IS"):
        tlosses.grpo_loss(new, old, ref, adv, mask, 0.2, 0.01, behavior_logprobs=old)
    with pytest.raises(NotImplementedError, match="truncated-IS"):
        tlosses.ppo_clip_loss_token(new, old, adv, mask, 0.2,
                                    segment_ages=torch.zeros_like(mask, dtype=torch.int32))


def _responses(seed, B=6, T=10, stop=3, pad=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(4, 50, (B, T)).astype(np.int32)
    r[0, 4] = stop              # stop mid-row
    r[1, 0] = stop              # stop first
    r[2, -1] = stop             # stop last
    r[3, 6:] = pad              # already padded, no stop
    r[4, 0:] = pad              # all pad
    return r


def test_truncate_response_and_padding_masks_match_jax():
    r = _responses(0)
    got = tmask.truncate_response(3, 0, torch.as_tensor(r))
    want = np.asarray(jmask.truncate_response(3, 0, jnp.asarray(r)))
    np.testing.assert_array_equal(got.numpy(), want)
    seq = tmask.first_true_indices(got == 0) - 1
    jseq = jmask.first_true_indices(jnp.asarray(want) == 0) - 1
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    for a, b in zip(tmask.response_padding_masks(got, seq),
                    jmask.response_padding_masks(jnp.asarray(want), jseq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sparse_terminal_rewards_and_returns_match_jax():
    rng = np.random.default_rng(1)
    T = 10
    scores = rng.standard_normal(6).astype(np.float32)
    # seq_len -1 (first token pad), mid, T-2 (one-past exists), T-1 (clamped)
    seq = np.array([-1, 3, T - 2, T - 1, 0, 5], np.int32)
    kl = rng.standard_normal((6, T)).astype(np.float32)
    for pen in (None, kl):
        got = tadv.sparse_terminal_rewards(torch.as_tensor(scores), torch.as_tensor(seq), T,
                                           None if pen is None else torch.as_tensor(pen))
        want = jadv.sparse_terminal_rewards(jnp.asarray(scores), jnp.asarray(seq), T,
                                            None if pen is None else jnp.asarray(pen))
        _close(got, want)
        for gamma in (1.0, 0.9):
            _close(tadv.discounted_returns(got, gamma),
                   jadv.discounted_returns(jnp.asarray(want), gamma))


@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
@pytest.mark.parametrize("lora_on", [True, False])
def test_trainable_mask_matches_jax(kind, lora_on):
    jparams, tparams = make_params(jax_config(kind), seed=3)
    got = trainable_mask(tparams, LoraConfig(r=LORA.r, alpha=LORA.alpha) if lora_on else None)
    want = jax_trainable_mask(jparams, LORA if lora_on else None)
    assert got == jax.tree.map(bool, want)


def _chi2(counts):
    expected = counts.sum() / counts.size
    return float(((counts - expected) ** 2 / expected).sum())


def test_keep_one_of_n_is_uniform_and_seeded():
    """Over 2000 seeded draws of 8 prompts × N=4, every index is equally
    likely (chi-square with 3 dof below 16.3, p = 0.001) and independent
    of the prompt's position; equal seeds give equal draws."""
    counts = np.zeros((8, 4))
    for i in range(2000):
        keep = tadv.keep_one_of_n_indices(stream_generator(1, KEEP_STREAM, i), 8, 4)
        counts[np.arange(8), keep.numpy()] += 1
    assert _chi2(counts.sum(0)) < 16.3
    assert max(_chi2(row) for row in counts) < 25.0  # 8 rows, 3 dof each
    a = tadv.keep_one_of_n_indices(stream_generator(1, KEEP_STREAM, 5), 8, 4)
    b = tadv.keep_one_of_n_indices(stream_generator(1, KEEP_STREAM, 5), 8, 4)
    assert torch.equal(a, b)


def test_epoch_permutation_is_uniform():
    """The per-epoch minibatch permutation (torch.randperm on a seeded
    generator): each row lands in each position equally often."""
    n, draws = 6, 3000
    pos = np.zeros((n, n))
    for i in range(draws):
        perm = torch.randperm(n, generator=stream_generator(1, PERM_STREAM, i, 0)).numpy()
        pos[perm, np.arange(n)] += 1
    assert _chi2(pos.ravel()) < 70.0  # 25 dof (row/column sums fixed), p ≈ 1e-5
    assert sorted(perm.tolist()) == list(range(n))
