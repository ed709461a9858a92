"""The flash-attention backward of the port (ops/attention.py) against the
JAX package, in f32: the plain backward (`flash_attention_backward_reference`,
what the port runs for CPU tensors and holds the Hopper kernels against)
and the CPU route's autograd through `flash_attention` vs `jax.grad`
through the JAX `flash_attention` (its Pallas backward in interpret mode,
as tests/test_attention.py runs it) and through `reference_attention`.

Left-pad query rows whose keys are all masked are "garbage rows" in both
packages (their uniform P spreads over different padded key sets), so the
causal cases give them a zero cotangent, as the training path does, and a
separate test checks that a non-zero cotangent there stays finite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops.attention import flash_attention as jax_flash
from nanorlhf_tpu.ops.attention import reference_attention as jax_reference
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_bwd_dkv,
    flash_bwd_dq,
    reference_attention,
)

torch.set_num_threads(1)

# f32 on both sides; the JAX kernel pads T to 128 and sums in another order
ATOL, RTOL = 2e-5, 1e-4

CASES = {
    # name: (B, H, KV, T, d, causal, left pad per row)
    "causal_gqa3_masked_rows": (2, 6, 2, 16, 16, True, (0, 5)),
    "noncausal_gqa3": (2, 6, 2, 16, 16, False, (0, 5)),
    "causal_gqa4_ragged_T": (1, 8, 2, 13, 16, True, (3,)),
    "causal_gqa7": (1, 14, 2, 11, 8, True, (2,)),
    "noncausal_mha_ragged_T": (2, 4, 4, 9, 8, False, (0, 2)),
}


def _inputs(case, seed=0):
    B, H, KV, T, d, causal, pad = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    valid = np.arange(T)[None, :] >= np.asarray(pad)[:, None]
    w = rng.standard_normal((B, H, T, d)).astype(np.float32)
    if causal:  # fully masked (left-pad) query rows get no cotangent
        w = w * valid[:, None, :, None]
    return q, k, v, valid, w, causal


def _jax_grads(fn, q, k, v, valid, w, causal):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, jnp.asarray(valid), causal) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _torch_grads(fn, q, k, v, valid, w, causal):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, torch.from_numpy(valid), causal)
    return torch.autograd.grad(out, leaves, torch.from_numpy(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_autograd_matches_jax_flash_grad(case):
    """The port's differentiable `flash_attention` (CPU route: forward and
    backward are the plain versions) vs `jax.grad` of the JAX kernel."""
    args = _inputs(case)
    got = _torch_grads(flash_attention, *args)
    want = _jax_grads(jax_flash, *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_reference_grad(case):
    """`flash_attention_backward_reference` from the forward's residuals
    (out, lse) vs `jax.grad` through the JAX XLA `reference_attention`."""
    q, k, v, valid, w, causal = _inputs(case, seed=1)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    tvalid = torch.from_numpy(valid)
    out, lse = flash_attention_forward(tq, tk, tv, tvalid, causal)
    got = flash_attention_backward_reference(tq, tk, tv, tvalid, out, lse, tw, causal)
    want = _jax_grads(jax_reference, q, k, v, valid, w, causal)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_torch_autograd(case):
    """The FA2 formulas written out agree with autograd through the plain
    forward (`reference_attention`) of the port itself."""
    args = _inputs(case, seed=2)
    got = _torch_grads(flash_attention, *args)
    want = _torch_grads(reference_attention, *args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


def test_fully_masked_rows_stay_finite():
    """A left-pad row whose keys are all masked, with a NON-zero
    cotangent: the finite NEG_INF keeps P uniform, so every gradient is
    finite (never NaN)."""
    q, k, v, valid, _, causal = _inputs("causal_gqa3_masked_rows")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tvalid = torch.from_numpy(valid)
    out, lse = flash_attention_forward(tq, tk, tv, tvalid, causal)
    assert not tvalid[1, :5].any()  # rows 0-4 of batch row 1 see no key
    do = torch.ones_like(out)
    for g in flash_attention_backward(tq, tk, tv, tvalid, out, lse, do, causal):
        assert torch.isfinite(g).all()


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach a kernel launch: the counters stay at 0."""
    _build.reset_launch_counts()
    _torch_grads(flash_attention, *_inputs("noncausal_gqa3"))
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}
    assert _build.KERNELS["flash_bwd_dq"].source == _build.KERNELS["flash_bwd_dkv"].source
    # the kernel wrappers themselves refuse CPU tensors instead of
    # handing their pointers to a kernel
    q, k, v, valid, w, causal = _inputs("noncausal_gqa3")
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tvalid = torch.from_numpy(valid)
    lse = torch.zeros(tq.shape[:3])
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq(tq, tk, tv, tvalid, tq, lse, tq, causal)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv(tq, tk, tv, tvalid, lse, lse, tq, causal)
