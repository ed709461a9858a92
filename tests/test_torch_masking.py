"""The port's numerics (ops/masking.py, algos/advantages.py) against the
JAX package's on random arrays, in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.algos.advantages import grpo_group_advantage as jax_group_advantage
from nanorlhf_tpu.ops import masking as jm
from nanorlhf_tpu_torch.algos.advantages import grpo_group_advantage
from nanorlhf_tpu_torch.ops import masking as tm

torch.set_num_threads(1)

ATOL = 1e-5


def test_constants():
    assert tm.MIN_TEMPERATURE == jm.MIN_TEMPERATURE
    assert tm.INVALID_LOGPROB == jm.INVALID_LOGPROB


@pytest.mark.parametrize("temp", [1.0, 0.7, 0.0])
def test_logprobs_and_entropy_from_logits(temp, rng):
    logits = (rng.standard_normal((3, 5, 40)) * 2).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5))
    got = tm.logprobs_from_logits(torch.as_tensor(logits), torch.as_tensor(labels), temp)
    want = jm.logprobs_from_logits(jnp.asarray(logits), jnp.asarray(labels), temp)
    # temp 0 floors at MIN_TEMPERATURE: logits/1e-6 are ~1e6, so f32 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-6 if temp == 0.0 else 0)
    np.testing.assert_allclose(tm.entropy_from_logits(torch.as_tensor(logits)).numpy(),
                               np.asarray(jm.entropy_from_logits(jnp.asarray(logits))),
                               atol=ATOL, rtol=0)
    assert tm.guard_temperature(temp) == jm.guard_temperature(temp)
    np.testing.assert_allclose(tm.guard_temperature(torch.tensor([temp, 2.0])).numpy(),
                               np.asarray(jm.guard_temperature(jnp.asarray([temp, 2.0]))))


def test_masked_stats_and_first_true(rng):
    values = rng.standard_normal((4, 9)).astype(np.float32)
    mask = rng.random((4, 9)) > 0.3
    tv, tmask = torch.as_tensor(values), torch.as_tensor(mask)
    jv, jmask = jnp.asarray(values), jnp.asarray(mask)
    np.testing.assert_allclose(tm.masked_mean(tv, tmask).numpy(),
                               np.asarray(jm.masked_mean(jv, jmask)), atol=ATOL)
    np.testing.assert_allclose(tm.masked_mean(tv, tmask, axis=1).numpy(),
                               np.asarray(jm.masked_mean(jv, jmask, axis=1)), atol=ATOL)
    np.testing.assert_allclose(tm.masked_var(tv, tmask).numpy(),
                               np.asarray(jm.masked_var(jv, jmask)), atol=ATOL)
    for shift in (True, False):
        np.testing.assert_allclose(tm.masked_whiten(tv, tmask, shift).numpy(),
                                   np.asarray(jm.masked_whiten(jv, jmask, shift)),
                                   atol=ATOL)
    bools = rng.random((5, 7)) > 0.7
    bools[0] = False
    np.testing.assert_array_equal(tm.first_true_indices(torch.as_tensor(bools)).numpy(),
                                  np.asarray(jm.first_true_indices(jnp.asarray(bools))))
    assert tm.exact_div(12, 4) == jm.exact_div(12, 4)
    with pytest.raises(ValueError):
        tm.exact_div(10, 4)


@pytest.mark.parametrize("n", [2, 4])
def test_grpo_group_advantage(n, rng):
    scores = rng.standard_normal(4 * n).astype(np.float32)
    scores[:n] = 0.5  # a zero-variance group: 0/0 maps to 0
    got = grpo_group_advantage(torch.as_tensor(scores), n)
    want = jax_group_advantage(jnp.asarray(scores), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert (got[:n] == 0).all()
