"""The decode-attention wrapper's plain version (ops/decode_attention.py —
what the port runs for CPU tensors and holds the Hopper kernel against)
against the JAX prefix-bounded Pallas kernel in interpret mode and its XLA
oracle, in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    reference_decode_attention as jax_reference,
)
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops import decode_attention as td

torch.set_num_threads(1)

ATOL = 1e-5

CASES = {
    # name: (H, KV, T_max, hd, start per row, filled per row)
    "per_row_bounds": (8, 2, 512, 64, (0, 17, 300), (512, 200, 400)),
    "unaligned_t_max": (6, 2, 200, 64, (3, 0, 50), (77, 200, 51)),
    "filled_on_block_edge": (12, 2, 384, 32, (0, 5, 128), (128, 256, 384)),
    "single_slot": (4, 4, 256, 32, (0, 5, 9), (1, 6, 10)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_oracle(case, rng):
    H, KV, T, hd, start, filled = CASES[case]
    B = len(start)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    s = np.asarray(start, np.int32)
    f = np.asarray(filled, np.int32)
    got = td.decode_attention(*map(torch.as_tensor, (q, k, v, s, f)))
    kernel = jax_decode_attention(*map(jnp.asarray, (q, k, v, s, f)),
                                  block_k=128, interpret=True)
    oracle = jax_reference(*map(jnp.asarray, (q, k, v, s, f)))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL, rtol=0)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def test_slots_outside_the_window_are_ignored(rng):
    """Garbage outside [start, filled) must not change the result."""
    H, KV, T, hd = 4, 2, 64, 16
    q = torch.as_tensor(rng.standard_normal((2, H, hd)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((2, KV, T, hd)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((2, KV, T, hd)).astype(np.float32))
    s, f = torch.tensor([3, 0]), torch.tensor([40, 64])
    base = td.decode_attention(q, k, v, s, f)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, :3] = 1e4
    v2[0, :, 40:] = -1e4
    np.testing.assert_allclose(td.decode_attention(q, k2, v2, s, f).numpy(),
                               base.numpy(), atol=ATOL, rtol=0)
