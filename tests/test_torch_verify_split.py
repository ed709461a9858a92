"""The k-query verify kernels' decomposition (K6 and K9, one body in
`csrc/decode_attention.cu`): its plain version
`decode_verify_split_reference` (each row's keys cut into S ranges of whole
16-key tiles, each range's tiles dealt round-robin to 4 warps, the partial
softmax states merged by warp, then by split) and its paged form against
the JAX Pallas kernels `decode_verify_attention` / `paged_decode_verify_
attention` in interpret mode and their XLA oracles, in f32; and the split
rule `verify_split_count`.

Tolerance: 1e-5 absolute in f32 (the same masked softmax, summed in S x 4
partial states and merged, against one pass). A candidate whose window is
empty (fill + qi + 1 <= start) returns zeros in the split, as the CUDA
kernels do, which read nothing there; the XLA oracle averages such a
window (ROADMAP C), so both are compared on the other candidates."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops import decode_attention as jd
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops import decode_attention as td

torch.set_num_threads(1)

ATOL = 1e-5
SPLITS = (1, 2, 3, 8)

CASES = {
    # name: (Tq, G, hd, T_max, start per row, fill per row); windows of one
    # key, shorter than S tiles, straddling 16-key tile edges, the last slot
    # taken, and a row whose prefix starts after its first candidates
    "tq1_g1_hd64": (1, 1, 64, 160, (0, 9, 40, 150), (159, 20, 40, 3)),
    "tq3_g2_hd128": (3, 2, 128, 150, (0, 31, 17, 100), (147, 95, 15, 99)),
    "tq5_g6_hd128": (5, 6, 128, 200, (0, 10, 63, 3), (195, 41, 64, 120)),
    "tq8_g7_hd64": (8, 7, 64, 130, (0, 5, 33, 70), (122, 16, 47, 66)),
    "tq8_g8_hd128": (8, 8, 128, 120, (2, 0, 50), (112, 30, 45)),
}


def _empty(start, fill, Tq):
    """[B, Tq]: the candidates whose window [start, fill + qi + 1) is empty."""
    return fill[:, None] + np.arange(Tq)[None, :] + 1 <= start[:, None]


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs, the JAX kernel's output (interpret mode) and the oracle's."""
    Tq, G, hd, T, start, fill = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    B, KV = len(start), 2
    q = rng.standard_normal((B, KV * G, Tq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    s, f = np.asarray(start, np.int32), np.asarray(fill, np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, s, f)))
    kernel = np.asarray(jd.decode_verify_attention(*jargs, interpret=True))
    oracle = np.asarray(jd.reference_decode_verify_attention(*jargs))
    return (q, k, v, s, f), kernel, oracle


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_matches_jax_kernel_and_oracle(case, S):
    args, kernel, oracle = _case(case)
    s, f = args[3], args[4]
    Tq = args[0].shape[2]
    got = td.decode_verify_split_reference(*map(torch.as_tensor, args), S).numpy()
    assert got.shape == args[0].shape
    live = ~_empty(s, f, Tq)                     # [B, Tq]
    for b in range(len(s)):
        np.testing.assert_allclose(got[b][:, live[b]], kernel[b][:, live[b]], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got[b][:, live[b]], oracle[b][:, live[b]], atol=ATOL,
                                   rtol=0)
        assert not got[b][:, ~live[b]].any()     # the empty windows: zeros
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def test_cases_hold_empty_windows_and_tile_edges():
    emptied = sum(_empty(np.asarray(c[4]), np.asarray(c[5]), c[0]).any() for c in CASES.values())
    assert emptied >= 3
    assert {c[0] for c in CASES.values()} == {1, 3, 5, 8}
    assert {c[1] for c in CASES.values()} == {1, 2, 6, 7, 8}
    assert {c[2] for c in CASES.values()} == {64, 128}


def _scatter(logical, table, N, P):
    """Pool [N, KV, P, hd] holding `logical` [B, KV, nb·P, hd] at the
    table's pages (sentinel blocks left out)."""
    pool = np.zeros((N, logical.shape[1], P, logical.shape[3]), logical.dtype)
    for b in range(logical.shape[0]):
        for j, page in enumerate(table[b]):
            if page < N:
                pool[page] = logical[b, :, j * P:(j + 1) * P]
    return pool


@functools.lru_cache(maxsize=None)
def _paged_case():
    """G 6, Tq 5, hd 64, pages of 24 (not a multiple of the 16-key tile)
    scattered through a pool with spare pages; row 0 stays below its
    sentinel last block, row 1's candidates straddle a page, row 2's run
    past the table (clamped to nb·P), row 3's first candidates have empty
    windows."""
    rng = np.random.default_rng(21)
    KV, G, Tq, hd, P, nb = 2, 6, 5, 64, 24, 6
    start = np.asarray([0, 4, 30, 60], np.int32)
    fill = np.asarray([(nb - 1) * P - Tq, 45, nb * P - 2, 57], np.int32)
    B, T = len(start), nb * P
    N = B * nb + 3
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    table[0, -1] = N
    q = rng.standard_normal((B, KV * G, Tq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    kp, vp = _scatter(k, table, N, P), _scatter(v, table, N, P)
    j = jnp.asarray
    kernel = jd.paged_decode_verify_attention(j(q), j(kp), j(vp), j(table), j(start),
                                              j(fill), interpret=True)
    oracle = jd.reference_paged_decode_verify_attention(j(q), j(kp), j(vp), j(table),
                                                        j(start), j(fill))
    inputs = dict(q=q, k=k, v=v, kp=kp, vp=vp, table=table, start=start, fill=fill)
    return inputs, np.asarray(kernel), np.asarray(oracle)


@pytest.mark.parametrize("S", SPLITS)
def test_paged_split_through_gather(S):
    c, kernel, oracle = _paged_case()
    t = {n: torch.as_tensor(x) for n, x in c.items()}
    s, f = c["start"], c["fill"]
    Tq, T = c["q"].shape[2], c["k"].shape[2]
    got = td.paged_decode_verify_split_reference(t["q"], t["kp"], t["vp"], t["table"],
                                                 t["start"], t["fill"], S)
    live = ~_empty(s, f, Tq)
    # the JAX kernel's grid revisits a clamped page past the table, while
    # the gathered view ends at nb·P as the port's kernel does: compare the
    # kernel on the candidates below T_max, the oracle on every live one
    below = f[:, None] + np.arange(Tq)[None, :] < T
    assert not below.all() and (~live).any()
    for b in range(len(s)):
        keep = live[b] & below[b]
        np.testing.assert_allclose(got[b][:, keep].numpy(), kernel[b][:, keep], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got[b][:, live[b]].numpy(), oracle[b][:, live[b]],
                                   atol=ATOL, rtol=0)
        assert not got[b][:, ~live[b]].any()
    # the paged split on the same logical cache is the contiguous split, bit
    # for bit (K9 == K6 on the card): row 0 never reads its sentinel block
    contiguous = td.decode_verify_split_reference(t["q"], t["k"], t["v"], t["start"],
                                                  t["fill"], S)
    assert torch.equal(got, contiguous)


@pytest.mark.parametrize("S", range(1, td.VERIFY_MAX_SPLITS + 1))
def test_split_bounds_cover_each_window_once_in_whole_tiles(S, rng):
    T, Tq = 300, 5
    start = torch.as_tensor(rng.integers(-3, 200, 64))
    fill = torch.as_tensor(rng.integers(0, 320, 64))
    start[:3] = torch.tensor([0, 40, 7])
    fill[:3] = torch.tensor([T - Tq, 20, 7 + 16 * S])  # full, empty, S + 1 tiles
    lo, hi = td.verify_split_bounds(start, fill, Tq, T, S)
    assert lo.shape == hi.shape == (S, 64)
    s0 = start.clamp(min=0)
    s1 = torch.maximum((fill + Tq).clamp(max=T), s0)
    assert torch.equal(lo[0], s0) and torch.equal(hi[-1], s1)
    assert torch.equal(lo[1:], hi[:-1])          # contiguous, in split order
    n = hi - lo
    tile = td.VERIFY_TILE
    cap = (((s1 - s0 + S - 1) // S + tile - 1) // tile * tile).expand_as(n)
    assert (n >= 0).all() and (n <= cap).all() and (cap % tile == 0).all()
    assert torch.equal(n[hi < s1], cap[hi < s1])
    assert not n[:, 1].any()                      # the empty window reads nothing


def test_split_rule_depends_on_the_shape_only():
    rule = td.verify_split_count
    for sms in (66, 114, 132):
        for KV in (1, 2, 4, 8):
            prev = td.VERIFY_MAX_SPLITS
            for B in (1, 2, 4, 8, 16, 32, 64, 128, 512, 4096):
                S = rule(B, KV, sms)
                assert 1 <= S <= td.VERIFY_MAX_SPLITS  # at most the portable cluster
                assert S <= prev
                prev = S
                assert B * KV * S <= td.VERIFY_BLOCKS_PER_SM * sms or S == 1
    # the shapes phase 7 gives the kernels on an H100 (132 SMs): K6 at B=64
    # (7a), K9 at B=32 (7b), KV=2; and the edges chip_smoke.py holds
    assert rule(64, 2, 132) == 1 and rule(32, 2, 132) == 2
    assert rule(3, 2, 132) == 8 and rule(133, 8, 132) == 1 and rule(22, 2, 132) == 3
