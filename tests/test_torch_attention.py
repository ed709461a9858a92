"""The flash-attention wrapper's plain version (ops/attention.py — what the
port runs for CPU tensors and holds the Hopper kernel against) against the
JAX Pallas flash kernel in interpret mode and its XLA oracle, in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops.attention import _flash_forward, reference_attention
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops import attention as ta

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(rng, B, H, KV, T, d, pads):
    q = rng.standard_normal((B, H, T, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    valid = np.ones((B, T), bool)
    for b, p in enumerate(pads):
        valid[b, :p] = False
    return q, k, v, valid


def _jax_flash(q, k, v, valid, causal, block=128):
    """The Pallas kernel in interpret mode, T padded to the block as
    `flash_attention` does; returns (out, lse lane 0) cut back to T."""
    T = q.shape[2]
    Tp = -(-T // block) * block
    pad4 = [(0, 0), (0, 0), (0, Tp - T), (0, 0)]
    out, lse = _flash_forward(
        jnp.pad(jnp.asarray(q), pad4), jnp.pad(jnp.asarray(k), pad4),
        jnp.pad(jnp.asarray(v), pad4),
        jnp.pad(jnp.asarray(valid), [(0, 0), (0, Tp - T)]),
        causal, block, block, interpret=True)
    return np.asarray(out)[:, :, :T], np.asarray(lse)[:, :, :T, 0]


CASES = {
    # name: (B, H, KV, T, d, left pads per row)
    "gqa": (2, 8, 2, 16, 16, (0, 0)),
    "padded_rows": (2, 4, 2, 24, 16, (5, 2)),
    "ragged_t": (2, 4, 2, 13, 16, (3, 0)),
    "mha_long": (1, 2, 2, 150, 32, (7,)),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_flash_kernel_and_oracle(case, causal, rng):
    q, k, v, valid = _inputs(rng, *CASES[case])
    out, lse = ta.flash_attention_forward(*map(torch.as_tensor, (q, k, v, valid)),
                                          causal=causal)
    j_out, j_lse = _jax_flash(q, k, v, valid, causal)
    oracle = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v, valid)),
                                            causal=causal))
    # padding query rows are unconstrained (garbage in the kernel, as in JAX)
    rows = valid[:, None, :] if causal else np.ones_like(valid)[:, None, :]
    rows = np.broadcast_to(rows, out.shape[:3])
    np.testing.assert_allclose(out.numpy()[rows], j_out[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy()[rows], j_lse[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL, rtol=0)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == out.shape[:3]


def test_fully_masked_row_is_finite_and_matches_oracle(rng):
    q, k, v, valid = _inputs(rng, 2, 4, 2, 10, 16, (0, 0))
    valid[1, :] = False  # every key of row 1 masked
    out, lse = ta.flash_attention_forward(*map(torch.as_tensor, (q, k, v, valid)))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    oracle = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v, valid))))
    np.testing.assert_allclose(out.numpy(), oracle, atol=ATOL, rtol=0)
    j_out, _ = _jax_flash(q, k, v, valid, True)
    np.testing.assert_allclose(out.numpy()[0], j_out[0], atol=ATOL, rtol=0)


def test_cpu_tensors_never_launch_and_allow_grad(rng):
    q, k, v, valid = (torch.as_tensor(a) for a in _inputs(rng, 1, 2, 1, 8, 16, (2,)))
    q.requires_grad_(True)
    before = _build.launch_counts()
    out = ta.flash_attention(q, k, v, valid)
    out.sum().backward()  # the plain version is differentiable on the CPU
    assert q.grad is not None
    assert _build.launch_counts() == before == {n: 0 for n in _build.KERNELS}


def test_reference_attention_matches_oracle_bf16_shapes(rng):
    q, k, v, valid = _inputs(rng, 2, 6, 2, 12, 16, (4, 0))
    got = ta.reference_attention(*map(torch.as_tensor, (q, k, v, valid)))
    want = np.asarray(reference_attention(*map(jnp.asarray, (q, k, v, valid))))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
