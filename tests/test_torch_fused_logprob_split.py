"""The fused hidden→logprob kernel's decomposition (K10 in
`csrc/fused_logprob.cu`): its plain version `fused_logprob_split_reference`
(per vocab split, the online (m, l, g, u) state over whole vocab tiles, then
the merge) against the JAX Pallas kernel `_pallas_forward` in interpret mode
and the JAX lax chunk scan `_lax_forward`, in f32; and the split rule
`fused_logprob_split_count`.

Tolerance: 1e-5 absolute in f32 (the same logsumexp, summed per split and
merged, against one pass over 512-wide vocab blocks or whole rows)."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops import fused_logprob as tf

# the module, not the function nanorlhf_tpu.ops re-exports under its name
jf = importlib.import_module("nanorlhf_tpu.ops.fused_logprob")

torch.set_num_threads(1)

ATOL = 1e-5
R, D, V = 37, 32, 1000   # no tile width (128, 256, 512) divides V
BLOCK_V = 128            # 8 vocab tiles, the last 104 columns wide
N_TILES = -(-V // BLOCK_V)
# splits: one, two, three (ragged), five (3 splits of 2 tiles, then one of 2
# and one left empty), one per tile
SPLITS = (1, 2, 3, 5, N_TILES)


@functools.lru_cache(maxsize=None)
def _case(transposed, with_entropy, temp):
    """Inputs, the JAX kernel's (lp, ent) in interpret mode and the lax
    scan's."""
    rng = np.random.default_rng(7 + 2 * transposed + with_entropy)
    h = rng.standard_normal((R, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if transposed else (D, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, R).astype(np.int32)
    labels[:3] = [0, V - 1, N_TILES * BLOCK_V - BLOCK_V]  # first, last, the tail tile's first
    jargs = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), temp)
    pallas = jf._pallas_forward(*jargs, interpret=True, transposed=transposed,
                                with_entropy=with_entropy)
    lax = jf._lax_forward(*jargs, R, with_entropy, False, transposed)
    return (h, w, labels), [np.asarray(x) for x in pallas if x is not None], \
        [np.asarray(x) for x in lax]


@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("with_entropy", [False, True])
@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_matches_jax_kernel_and_lax(splits, transposed, with_entropy, temp):
    (h, w, labels), pallas, lax = _case(transposed, with_entropy, temp)
    got = tf.fused_logprob_split_reference(
        torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(labels), temp, splits,
        block_v=BLOCK_V, with_entropy=with_entropy, transposed=transposed)
    assert (got[1] is None) == (not with_entropy)
    got = [x.numpy() for x in got if x is not None]
    assert len(got) == len(pallas) == len(lax) == 1 + with_entropy
    for g, p, x in zip(got, pallas, lax):
        assert g.shape == (R,) and g.dtype == np.float32
        np.testing.assert_allclose(g, p, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, x, atol=ATOL, rtol=0)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


@pytest.mark.parametrize("transposed", [True, False])
def test_kernel_tiles_at_the_pinned_split(transposed, rng):
    """The kernel's own tile width (256) and split count, on a vocab of
    ragged 256-wide tiles, against the chunked plain version."""
    Rk, Vk = 300, 1000
    h = torch.as_tensor(rng.standard_normal((Rk, D)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((Vk, D) if transposed else (D, Vk)) * 0.3)
                        .astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, Vk, Rk))
    splits = tf.fused_logprob_split_count(Rk, Vk, 132)
    assert splits == 4 == -(-Vk // tf.KERNEL_BLOCK_VOCAB)  # one tile a split
    got = tf.fused_logprob_split_reference(h, w, labels, 0.7, splits, with_entropy=True,
                                           transposed=transposed)
    want = tf.fused_logprob_chunked(h, w, labels, 0.7, 64, with_entropy=True,
                                    transposed=transposed)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x.numpy(), atol=ATOL, rtol=0)


def test_split_rule_pins_and_properties():
    rule = tf.fused_logprob_split_count
    # the shapes chip_smoke.py phase 2 holds on an H100 (132 SMs):
    # scoring at 16 x 1500 and 16 x 512 rows, the update's microbatch at
    # 4 x 1500 and 4 x 512, the [D, V] slice and the edge
    assert rule(24000, 151936, 132) == 7
    assert rule(6000, 151936, 132) == 14
    assert rule(8192, 151936, 132) == 33
    assert rule(2048, 151936, 132) == 33
    assert rule(512, 4096, 132) == 16
    assert rule(300, 1000, 132) == 4
    for sms in (66, 114, 132):
        for rows in (1, 127, 128, 300, 4096, 24000, 100000):
            for vocab in (8, 1000, 4096, 32000, 151936):
                n_vt = -(-vocab // tf.KERNEL_BLOCK_VOCAB)
                s = rule(rows, vocab, sms)
                assert 1 <= s <= n_vt
                # the fewest splits of its tiles per split: none left empty
                per = -(-n_vt // s)
                assert (s - 1) * per < n_vt
                assert s == 1 or -(-n_vt // (s - 1)) > per
