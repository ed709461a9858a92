"""The k-query verify attention's plain versions (ops/decode_attention.py —
what the port runs for CPU tensors and holds the Hopper kernels K6 and K9
against) against the JAX Pallas kernels `decode_verify_attention` /
`paged_decode_verify_attention` in interpret mode and their XLA oracles, in
f32: Tq in {1, 3, 5} candidates and GQA groups G in {1, 2, 4} over the
contiguous cache; over scattered pages, candidate blocks that straddle two
pages, a sentinel block, and a row whose candidates run past its table.

Tolerance: 1e-5 absolute in f32 (the same masked softmax, summed in
another order). Where candidates run past the table, the JAX kernel's grid
revisits a clamped page while the gathered view (JAX's oracle and the
port's plain version) ends at nb·P, as the port's kernel does: those
candidates lie past the logical width T_max, their outputs are discarded by
the sampler's emission clamp, and they are compared against the oracle only
(the kernel for the slots below T_max)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops import decode_attention as jd
from nanorlhf_tpu_torch.ops import decode_attention as td

torch.set_num_threads(1)

ATOL = 1e-5


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*map(jnp.asarray, arrays), **kw))


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("Tq", [1, 3, 5])
def test_verify_plain_matches_jax_kernel_and_oracle(Tq, G, rng):
    B, KV, T, hd = 3, 2, 150, 16
    q = rng.standard_normal((B, KV * G, Tq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    # row 1's candidates cross the Pallas kernel's 128-key block edge, row
    # 2's prefix starts mid-cache and its last candidate takes the last slot
    start = np.asarray([0, 9, 60], np.int32)
    fill = np.asarray([40, 126, T - Tq], np.int32)
    args = (q, k, v, start, fill)
    got = td.decode_verify_attention(*map(torch.as_tensor, args)).numpy()
    assert got.shape == q.shape
    np.testing.assert_allclose(got, _jax(jd.decode_verify_attention, *args,
                                         interpret=True), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _jax(jd.reference_decode_verify_attention, *args),
                               atol=ATOL, rtol=0)
    if Tq == 1:
        # one candidate is the single-query decode over [start, fill + 1)
        single = td.decode_attention(*map(torch.as_tensor, (q[:, :, 0], k, v, start,
                                                            fill + 1)))
        np.testing.assert_allclose(got[:, :, 0], single.numpy(), atol=ATOL, rtol=0)


def _scatter(logical, table, N, P):
    """Pool [N, KV, P, hd] holding `logical` [B, KV, nb·P, hd] at the
    table's pages (sentinel blocks left out)."""
    pool = np.zeros((N, logical.shape[1], P, logical.shape[3]), logical.dtype)
    for b in range(logical.shape[0]):
        for j, page in enumerate(table[b]):
            if page < N:
                pool[page] = logical[b, :, j * P:(j + 1) * P]
    return pool


PAGED_CASES = {
    # name: (G, Tq, P, nb, start per row, fill per row)
    "straddling_pages": (2, 5, 8, 4, (0, 3, 2), (6, 21, 12)),
    "page_not_dividing": (4, 3, 5, 5, (1, 0, 4), (3, 8, 14)),
    "past_the_table": (2, 5, 8, 3, (2, 0, 0), (12, 22, 5)),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_verify_plain_matches_jax_kernel_and_oracle(case, rng):
    G, Tq, P, nb, start, fill = PAGED_CASES[case]
    B, KV, hd = 3, 2, 16
    N = B * nb + 3
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    table[2, -1] = N      # row 2 never reaches its sentinel last block
    T = nb * P
    k_log = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v_log = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    kp, vp = _scatter(k_log, table, N, P), _scatter(v_log, table, N, P)
    q = rng.standard_normal((B, KV * G, Tq, hd)).astype(np.float32)
    s, f = np.asarray(start, np.int32), np.asarray(fill, np.int32)
    assert f[2] + Tq <= (nb - 1) * P
    args = (q, kp, vp, table, s, f)
    got = td.paged_decode_verify_attention(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, _jax(jd.reference_paged_decode_verify_attention,
                                         *args), atol=ATOL, rtol=0)
    # the same logical cache laid out contiguously gives the same bits
    contiguous = td.decode_verify_attention(*map(torch.as_tensor, (q, k_log, v_log, s, f)))
    live = np.arange(B) != 2  # row 2's sentinel block holds zeros in the pool
    assert np.array_equal(got[live], contiguous.numpy()[live])
    want = _jax(jd.paged_decode_verify_attention, *args, interpret=True)
    below = f[:, None] + np.arange(Tq)[None, :] < T          # [B, Tq]
    if case == "past_the_table":
        assert not below.all()
    for b in range(B):
        np.testing.assert_allclose(got[b][:, below[b]], want[b][:, below[b]],
                                   atol=ATOL, rtol=0)
