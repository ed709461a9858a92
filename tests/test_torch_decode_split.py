"""The decode kernels' key-range split (K4, K5, K7, K8 in
`csrc/decode_attention.cu`): its plain version
(`decode_attention_split_reference` over `decode_split_bounds`) against the
JAX Pallas decode kernels in interpret mode and their XLA oracles, in f32,
and the split rule (`decode_split_count`).

Tolerance: 1e-5 absolute in f32 (the same softmax, summed in S partial
states and merged, against one pass). An empty window (filled <= start)
returns zeros in the split, as in the CUDA kernels, which read nothing
there. The JAX kernel returns zeros for filled == 0 only (for 0 < filled
<= start it averages the tile holding `start`, as the XLA oracle averages
every empty window), so both are compared on the other rows."""

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
    # name: (KV, G, hd, T_max, start per row, filled per row); windows of
    # one key, of whole tiles, shorter than S tiles, straddling tile edges,
    # a full row and an empty one (filled == start)
    "g1_hd64": (2, 1, 64, 256, (0, 0, 40, 7), (256, 0, 72, 8)),
    "g2_hd128": (2, 2, 128, 200, (0, 31, 3, 50), (200, 95, 50, 20)),
    "g6_hd128": (2, 6, 128, 300, (0, 10, 100, 3), (300, 41, 100, 290)),
    "g7_hd64": (2, 7, 64, 160, (0, 63, 9), (160, 64, 9)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs, the JAX kernel's output (interpret mode) and the oracle's."""
    KV, G, hd, T, start, filled = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    B = len(start)
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    s, f = np.asarray(start, np.int32), np.asarray(filled, np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, s, f)))
    kernel = np.asarray(jd.decode_attention(*jargs, block_k=128, interpret=True))
    oracle = np.asarray(jd.reference_decode_attention(*jargs))
    return (q, k, v, s, f), kernel, oracle


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_matches_jax_kernel_and_oracle(case, S):
    args, kernel, oracle = _case(case)
    s, f = args[3], args[4]
    got = td.decode_attention_split_reference(*map(torch.as_tensor, args), S).numpy()
    live = f > s
    np.testing.assert_allclose(got[live | (f == 0)], kernel[live | (f == 0)], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[live], oracle[live], atol=ATOL, rtol=0)
    assert (~live).any() and not got[~live].any()  # the empty windows: zeros
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def _scattered_pages(rng, B, nb, extra=3):
    """Table [B, nb] of distinct pages from a pool of B·nb + extra, the
    sentinel N as row 0's last block."""
    N = B * nb + extra
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    table[0, -1] = N
    return table, N


def _scatter(logical, table, N, P, fill=0.0):
    B = logical.shape[0]
    pool = np.full((N,) + logical.shape[1:2] + (P,) + logical.shape[3:], fill, logical.dtype)
    for b in range(B):
        for j, page in enumerate(table[b]):
            if page < N:
                pool[page] = logical[b, :, j * P:(j + 1) * P]
    return pool


def _expand8(scales):
    """The port's [.., T] scales in JAX's sublane-expanded [.., 8, T]."""
    return np.broadcast_to(scales[..., None, :], scales.shape[:-1] + (8, scales.shape[-1]))


@functools.lru_cache(maxsize=None)
def _paged_case():
    """G 6, hd 64, pages of 48 (not a multiple of 32) scattered through a
    pool with spare pages; row 0 stays below its sentinel block, row 2's
    window is empty, row 3 holds one key. Returns the inputs and the JAX
    kernels' outputs (interpret mode): paged bf16, int8, paged int8."""
    rng = np.random.default_rng(11)
    KV, G, hd, P, nb = 2, 6, 64, 48, 5
    start = np.asarray([0, 3, 70, 100, 5], np.int32)
    filled = np.asarray([(nb - 1) * P, 240, 70, 101, 190], np.int32)
    B, T = len(start), nb * P
    table, N = _scattered_pages(rng, B, nb)
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, KV, T, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, KV, T, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, KV, T)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, KV, T)).astype(np.float32)
    kp, vp = _scatter(k, table, N, P), _scatter(v, table, N, P)
    q8_pools = [_scatter(kq, table, N, P, 0), _scatter(ks, table, N, P, 1.0),
                _scatter(vq, table, N, P, 0), _scatter(vs, table, N, P, 1.0)]
    j = jnp.asarray
    paged = jd.paged_decode_attention(j(q), j(kp), j(vp), j(table), j(start), j(filled),
                                      interpret=True)
    q8 = jd.decode_attention_q8(j(q), j(kq), j(_expand8(ks)), j(vq), j(_expand8(vs)),
                                j(start), j(filled), block_k=128, interpret=True)
    paged_q8 = jd.paged_decode_attention_q8(
        j(q), j(q8_pools[0]), j(_expand8(q8_pools[1])), j(q8_pools[2]),
        j(_expand8(q8_pools[3])), j(table), j(start), j(filled), interpret=True)
    inputs = dict(q=q, k=k, v=v, kq=kq, ks=ks, vq=vq, vs=vs, kp=kp, vp=vp,
                  q8_pools=q8_pools, table=table, start=start, filled=filled)
    return inputs, tuple(np.asarray(x) for x in (paged, q8, paged_q8))


@pytest.mark.parametrize("S", SPLITS)
def test_paged_and_int8_instances_through_gather_and_dequantize(S):
    c, (paged, q8, paged_q8) = _paged_case()
    t = {n: torch.as_tensor(x) for n, x in c.items() if n != "q8_pools"}
    pools = [torch.as_tensor(x) for x in c["q8_pools"]]
    q, table, s, f = t["q"], t["table"], t["start"], t["filled"]

    def split(k, v):
        return td.decode_attention_split_reference(q, k, v, s, f, S)

    live = (f > s).numpy()
    got7 = split(td._gather_pool(t["kp"], table), td._gather_pool(t["vp"], table))
    np.testing.assert_allclose(got7.numpy()[live], paged[live], atol=ATOL, rtol=0)
    # the paged split on the same logical cache is the contiguous split, bit
    # for bit (K7 == K4 and K8 == K5 on the card)
    assert torch.equal(got7, split(t["k"], t["v"]))
    deq = functools.partial(td.dequantize_kv, dtype=torch.float32)
    got5 = split(deq(t["kq"], t["ks"]), deq(t["vq"], t["vs"]))
    np.testing.assert_allclose(got5.numpy()[live], q8[live], atol=ATOL, rtol=0)
    got8 = split(deq(td._gather_pool(pools[0], table), td._gather_pool(pools[1], table)),
                 deq(td._gather_pool(pools[2], table), td._gather_pool(pools[3], table)))
    np.testing.assert_allclose(got8.numpy()[live], paged_q8[live], atol=ATOL, rtol=0)
    assert torch.equal(got8, got5)
    assert not got7[2].any() and not got8[2].any()  # the empty window


@pytest.mark.parametrize("S", range(1, td.DECODE_MAX_SPLITS + 1))
def test_split_bounds_cover_each_window_once_in_whole_tiles(S, rng):
    T = 300
    start = torch.as_tensor(rng.integers(-3, 200, 64))
    filled = torch.as_tensor(rng.integers(0, 340, 64))
    start[:4] = torch.tensor([0, 5, 7, 32])
    filled[:4] = torch.tensor([T, 5, 8, 64 + 32 * S])  # full, empty, one key, S+2 tiles
    lo, hi = td.decode_split_bounds(start, filled, T, S)
    assert lo.shape == hi.shape == (S, 64)
    s0 = start.clamp(min=0)
    s1 = torch.maximum(filled.clamp(max=T), s0)
    assert torch.equal(lo[0], s0) and torch.equal(hi[-1], s1)
    assert torch.equal(lo[1:], hi[:-1])          # contiguous, in split order
    n = hi - lo
    assert (n >= 0).all()
    tile = td.DECODE_TILE
    # one range size per row, ceil(n / S) rounded up to whole tiles: every
    # range before the window's end has it, none is longer
    cap = ((s1 - s0 + S - 1) // S + tile - 1) // tile * tile
    cap = cap.expand_as(n)
    assert (cap % tile == 0).all() and (n <= cap).all()
    assert torch.equal(n[hi < s1], cap[hi < s1])
    used = (n > 0).sum(0)
    assert torch.equal(used, torch.where(s1 > s0, (s1 - s0 + cap[0] - 1) // cap[0].clamp(min=1), 0))
    # S + 1 tiles over S ranges: ranges of two tiles, ceil((S + 1) / 2) used
    assert used[3] == -(-(S + 1) // 2)


def test_split_rule_depends_on_the_shape_only():
    rule = td.decode_split_count
    for sms in (66, 114, 132):
        for KV in (1, 2, 4, 8):
            prev = td.DECODE_MAX_SPLITS
            for B in (1, 2, 4, 8, 16, 32, 64, 128, 512, 4096):
                S = rule(B, KV, sms)
                assert 1 <= S <= td.DECODE_MAX_SPLITS
                assert S <= prev  # more rows, no more splits
                prev = S
                # one wave of DECODE_BLOCKS_PER_SM blocks a SM, where S allows
                assert B * KV * S <= td.DECODE_BLOCKS_PER_SM * sms or S == 1
    # the rollout's shapes on an H100 (132 SMs): B=16 and B=64 rows, KV=2
    assert rule(16, 2, 132) == 8 and rule(64, 2, 132) == 3 and rule(32, 2, 132) == 6


def test_k4_and_k7_arguments_get_the_same_split(rng):
    """S comes from the rows of q and the kv heads of the cache (dim 1 of
    both the contiguous [B, KV, T, hd] cache and the [N, KV, P, hd] pool),
    never from T_max, nb·P or the rows' windows."""
    B, KV, hd, sms = 16, 2, 64, 132
    q = torch.zeros((B, 12, hd))
    for T, P, nb in ((1510, 128, 12), (522, 16, 33), (40, 48, 1)):
        contiguous = torch.zeros((B, KV, T, hd))
        pool = torch.zeros((B * nb + 3, KV, P, hd))
        assert (td.decode_split_count(q.shape[0], contiguous.shape[1], sms)
                == td.decode_split_count(q.shape[0], pool.shape[1], sms) == 8)


@pytest.mark.parametrize("S", SPLITS)
def test_split_matches_plain_version_on_random_windows(S, rng):
    B, KV, G, hd, T = 6, 2, 3, 32, 400
    q = torch.as_tensor(rng.standard_normal((B, KV * G, hd)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((B, KV, T, hd)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((B, KV, T, hd)).astype(np.float32))
    start = torch.as_tensor(rng.integers(0, 100, B))
    filled = start + torch.as_tensor(rng.integers(1, 300, B))
    got = td.decode_attention_split_reference(q, k, v, start, filled, S)
    want = td.reference_decode_attention(q, k, v, start, filled)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
