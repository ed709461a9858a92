"""The port's advantage estimators and losses of RLOO, ReMax, RAFT and PPO
(`nanorlhf_tpu_torch/algos/`) against the JAX package's on the same numpy
inputs: values, and the losses' gradients, at 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.algos import advantages as jadv
from nanorlhf_tpu.algos import losses as jlosses
from nanorlhf_tpu_torch.algos import advantages as adv
from nanorlhf_tpu_torch.algos import losses

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_rloo_and_remax_advantages(n):
    rng = np.random.default_rng(n)
    r = rng.standard_normal(6 * n).astype(np.float32)
    _close(adv.rloo_advantage(torch.as_tensor(r), n),
           jadv.rloo_advantage(jnp.asarray(r), n))
    g = rng.standard_normal(6 * n).astype(np.float32)
    _close(adv.remax_advantage(torch.as_tensor(r), torch.as_tensor(g)),
           jadv.remax_advantage(jnp.asarray(r), jnp.asarray(g)))


def test_best_of_k_best_is_exact_with_ties():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 3, 40).astype(np.float32)  # many ties: the first max wins
    got = adv.best_of_k_indices(torch.as_tensor(r), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jadv.best_of_k_indices(jnp.asarray(r), 4)))


def test_best_of_k_random_is_seeded_and_uniform():
    r = torch.zeros(4 * 20000)

    def draw(seed):
        return adv.best_of_k_indices(r, 4, torch.Generator().manual_seed(seed)).numpy()

    a = draw(3)
    np.testing.assert_array_equal(a, draw(3))
    assert not np.array_equal(a, draw(4))
    freq = np.bincount(a, minlength=4) / a.size
    jfreq = np.bincount(np.asarray(jadv.best_of_k_indices(
        jnp.asarray(r.numpy()), 4, key=jax.random.PRNGKey(3))), minlength=4) / a.size
    # 20000 draws: the standard error of a frequency of 1/4 is 0.003
    np.testing.assert_allclose(freq, 0.25, atol=0.015)
    np.testing.assert_allclose(jfreq, 0.25, atol=0.015)


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.8)])
def test_gae(gamma, lam):
    rng = np.random.default_rng(1)
    r = rng.standard_normal((3, 9)).astype(np.float32)
    v = rng.standard_normal((3, 9)).astype(np.float32)
    a, ret = adv.gae(torch.as_tensor(r), torch.as_tensor(v), gamma, lam)
    ja, jret = jadv.gae(jnp.asarray(r), jnp.asarray(v), gamma, lam)
    _close(a, ja)
    _close(ret, jret)


def _policy_inputs(seed, B=5, T=7):
    rng = np.random.default_rng(seed)
    mask = rng.random((B, T)) > 0.25
    mask[:, 0] = True
    new = (rng.standard_normal((B, T)) * 0.2 - 3).astype(np.float32)
    old = (new + rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    return new, old, mask, rng


def _grad_close(port_fn, jax_fn, x, close=None):
    """Values, aux and d loss / d x of the two implementations."""
    close = close or _close
    xt = torch.as_tensor(x).requires_grad_(True)
    loss, aux = port_fn(xt)
    (g,) = torch.autograd.grad(loss, xt)
    (jloss, jaux), jg = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x))
    close(loss.detach(), jloss)
    close(g, jg)
    assert set(aux) == set(jaux)
    for k in jaux:
        close(aux[k], jaux[k])


@pytest.mark.parametrize("cliprange", [0.2, 0.02])
def test_ppo_clip_loss_sequence(cliprange):
    new, old, mask, rng = _policy_inputs(2)
    a = rng.standard_normal(new.shape[0]).astype(np.float32)
    _grad_close(
        lambda x: losses.ppo_clip_loss_sequence(x, torch.as_tensor(old), torch.as_tensor(a),
                                                torch.as_tensor(mask), cliprange),
        lambda x: jlosses.ppo_clip_loss_sequence(x, jnp.asarray(old), jnp.asarray(a),
                                                 jnp.asarray(mask), cliprange),
        new)


@pytest.mark.parametrize("cliprange_value", [0.01, 0.5])
def test_value_loss_clipped(cliprange_value):
    vpred, values, mask, rng = _policy_inputs(3)
    returns = rng.standard_normal(vpred.shape).astype(np.float32)
    _grad_close(
        lambda x: losses.value_loss_clipped(x, torch.as_tensor(values),
                                            torch.as_tensor(returns),
                                            torch.as_tensor(mask), cliprange_value),
        lambda x: jlosses.value_loss_clipped(x, jnp.asarray(values), jnp.asarray(returns),
                                             jnp.asarray(mask), cliprange_value),
        vpred)


def test_sft_loss():
    new, _, mask, _ = _policy_inputs(4)
    _grad_close(lambda x: losses.sft_loss(x, torch.as_tensor(mask)),
                lambda x: jlosses.sft_loss(x, jnp.asarray(mask)), new)


@pytest.mark.parametrize("segments", [False, True])
def test_truncated_is_still_raises(segments):
    """RLOO's sequence-level IS weight — whole-sequence, or factorized over
    the runs of constant swap-segment age — against JAX's: loss, aux and
    the gradient at 1e-6 in f32 (the weight is the exp of a sum of logprob
    differences; its reduction order moves the last bits)."""
    new, old, mask, rng = _policy_inputs(5)
    beh = (old + rng.standard_normal(old.shape) * 0.3).astype(np.float32)
    ages = np.zeros(old.shape, np.int32)
    ages[0, :3], ages[0, 3:5], ages[3, :4] = 2, 1, 1
    seq_adv = rng.standard_normal(old.shape[0]).astype(np.float32)
    t = torch.as_tensor
    kw = dict(behavior_logprobs=t(beh), is_truncation=1.2,
              segment_ages=t(ages) if segments else None)
    jkw = dict(behavior_logprobs=jnp.asarray(beh), is_truncation=1.2,
               segment_ages=jnp.asarray(ages) if segments else None)
    _grad_close(
        lambda x: losses.ppo_clip_loss_sequence(x, t(old), t(seq_adv), t(mask), 0.2, **kw),
        lambda x: jlosses.ppo_clip_loss_sequence(x, jnp.asarray(old), jnp.asarray(seq_adv),
                                                 jnp.asarray(mask), 0.2, **jkw),
        new, close=lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6))
