"""The paged and int8 decode-attention wrappers' plain versions
(ops/decode_attention.py — what the port runs for CPU tensors and holds the
Hopper kernels K7, K5, K8 against) against the JAX Pallas kernels in
interpret mode and their XLA oracles, in f32; the int8 quantizer against
JAX's bit for bit; the model's paged writes (the scratch page that takes
JAX's dropped writes) and its per-row decode slots against JAX's.

Tolerance: 2e-5 absolute in f32 (the same masked softmax, summed in
another order). Pools are scattered through a larger pool with spare pages
and a sentinel tail on one row, as `tests/test_paged_cache.py` builds them;
JAX's [.., 8, T] scales are the port's [.., T] broadcast over the 8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.core.model import _quantize_kv as jax_quantize_kv
from nanorlhf_tpu.ops import decode_attention as jd
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.ops import decode_attention as td
from nanorlhf_tpu_torch.sampler.paged.pages import full_table as tm_full_table

torch.set_num_threads(1)

ATOL = 2e-5


def _scattered_pages(rng, B, nb, extra=3):
    """Table [B, nb] of distinct pages drawn from a pool of B·nb + extra,
    with a sentinel (N) last block on row 0 when rows have more than one."""
    N = B * nb + extra
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    if nb > 1:
        table[0, -1] = N
    return table, N


def _scatter(logical, table, N, P, fill=0.0):
    """Pool [N, KV, P, ...] holding `logical` [B, KV, nb·P, ...] at the
    table's pages (sentinel blocks left out)."""
    B, KV = logical.shape[:2]
    pool = np.full((N, KV, P) + logical.shape[3:], fill, logical.dtype)
    for b in range(B):
        for j, page in enumerate(table[b]):
            if page < N:
                pool[page] = logical[b, :, j * P:(j + 1) * P]
    return pool


CASES = {
    # name: (KV, G, hd, P, nb, start per row, filled per row)
    "rollout_like": (2, 6, 32, 16, 6, (0, 3, 40), (80, 96, 41)),
    "page_not_dividing_32": (2, 4, 16, 5, 7, (0, 2, 7), (30, 35, 8)),
    "gqa7_wide_pages": (2, 7, 64, 48, 3, (1, 0, 47), (90, 144, 100)),
    "gqa4_single_page": (4, 4, 16, 8, 1, (0, 0, 3), (5, 8, 4)),
}


def _inputs(rng, case):
    KV, G, hd, P, nb, start, filled = CASES[case]
    B = len(start)
    table, N = _scattered_pages(rng, B, nb)
    T = nb * P
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    s, f = np.asarray(start, np.int32), np.asarray(filled, np.int32)
    if table[0, -1] == N:
        f[0] = min(f[0], (nb - 1) * P)  # row 0 never reads its sentinel block
    return KV, hd, P, nb, B, T, N, table, q, s, f


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_plain_matches_jax_kernel_and_oracle(case, rng):
    KV, hd, P, nb, B, T, N, table, q, s, f = _inputs(rng, case)
    k_log = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    v_log = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    kp, vp = _scatter(k_log, table, N, P), _scatter(v_log, table, N, P)
    args = (q, kp, vp, table, s, f)
    got = td.paged_decode_attention(*map(torch.as_tensor, args))
    kernel = jd.paged_decode_attention(*map(jnp.asarray, args), interpret=True)
    oracle = jd.reference_paged_decode_attention(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL, rtol=0)
    # the same logical cache laid out contiguously gives the same answer
    contig = td.decode_attention(*map(torch.as_tensor, (q, k_log, v_log, s, f)))
    np.testing.assert_allclose(got.numpy(), contig.numpy(), atol=ATOL, rtol=0)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def _q8(rng, shape):
    values = rng.integers(-127, 128, shape).astype(np.int8)
    scales = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    return values, scales


def _expand8(scales):
    """The port's [.., T] scales in JAX's sublane-expanded [.., 8, T]."""
    return np.broadcast_to(scales[..., None, :], scales.shape[:-1] + (8, scales.shape[-1]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_q8_plain_matches_jax_kernel_and_oracle(case, rng):
    KV, hd, P, nb, B, T, N, table, q, s, f = _inputs(rng, case)
    kq, ks = _q8(rng, (B, KV, T, hd))
    vq, vs = _q8(rng, (B, KV, T, hd))
    got = td.decode_attention_q8(*map(torch.as_tensor, (q, kq, ks, vq, vs, s, f)))
    jargs = tuple(map(jnp.asarray, (q, kq, _expand8(ks), vq, _expand8(vs), s, f)))
    kernel = jd.decode_attention_q8(*jargs, block_k=128, interpret=True)
    oracle = jd.reference_decode_attention_q8(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL, rtol=0)

    # the same int8 cache through pages (K8)
    pools = [_scatter(kq, table, N, P, 0), _scatter(ks, table, N, P, 1.0),
             _scatter(vq, table, N, P, 0), _scatter(vs, table, N, P, 1.0)]
    got_p = td.paged_decode_attention_q8(
        *map(torch.as_tensor, (q, *pools, table, s, f)))
    jpools = [jnp.asarray(pools[0]), jnp.asarray(_expand8(pools[1])),
              jnp.asarray(pools[2]), jnp.asarray(_expand8(pools[3]))]
    kernel_p = jd.paged_decode_attention_q8(
        jnp.asarray(q), *jpools, jnp.asarray(table), jnp.asarray(s), jnp.asarray(f),
        interpret=True)
    oracle_p = jd.reference_paged_decode_attention_q8(
        jnp.asarray(q), *jpools, jnp.asarray(table), jnp.asarray(s), jnp.asarray(f))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(kernel_p), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(oracle_p), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), got.numpy(), atol=ATOL, rtol=0)
    assert _build.launch_counts() == {n: 0 for n in _build.KERNELS}


def test_gather_pool_matches_jax(rng):
    table, N = _scattered_pages(rng, 3, 4)
    pool = rng.standard_normal((N, 2, 5, 8)).astype(np.float32)
    got = td._gather_pool(torch.as_tensor(pool), torch.as_tensor(table))
    want = jd._gather_pool(jnp.asarray(pool), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # scale pools [N, KV, P] against JAX's [N, KV, 8, P] view
    spool = rng.standard_normal((N, 2, 5)).astype(np.float32)
    got_s = td._gather_pool(torch.as_tensor(spool), torch.as_tensor(table))
    want_s = jd._gather_scale_pool(jnp.asarray(_expand8(spool)), jnp.asarray(table))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[:, :, 0, :])


def test_empty_row_follows_the_oracle(rng):
    table, N = _scattered_pages(rng, 2, 3)
    kp = torch.as_tensor(rng.standard_normal((N, 2, 4, 16)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((2, 4, 16)).astype(np.float32))
    s, f = torch.tensor([2, 0]), torch.tensor([2, 0])
    out = td.paged_decode_attention(q, kp, kp, torch.as_tensor(table), s, f)
    # a row with filled == start: JAX's oracle (and so the port's plain
    # version) softmaxes uniformly over its NEG_INF scores, while the
    # kernels (JAX's and the port's, held by chip_smoke.py) return zeros;
    # the model never asks for such a row
    want = jd.reference_paged_decode_attention(*map(jnp.asarray, (
        q.numpy(), kp.numpy(), kp.numpy(), table, s.numpy(), f.numpy())))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype, rng):
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                     # an all-zero row: the 1e-8 scale floor
    x[0, 1, 2, :4] = [127.0, 63.5, -0.5, 1.5]  # ties round half to even
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    q, s = tm.quantize_kv(tx)
    jq, js = jax_quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js[:, :, 0, :], np.float32))
    # dequantization in the working dtype, as JAX's `_dequantize_kv`
    from nanorlhf_tpu.core.model import _dequantize_kv as jax_dequantize_kv

    np.testing.assert_array_equal(
        td.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jax_dequantize_kv(jq, js, jnp.float32)))


def test_paged_writes_drop_into_the_scratch_page(rng):
    """A write through a sentinel entry, or past the table, lands on the
    scratch page N and leaves every live page as it was (JAX's
    mode="drop")."""
    N, KV, P, hd, nb = 6, 2, 4, 8, 2
    pool = torch.as_tensor(rng.standard_normal((N + 1, KV, P, hd)).astype(np.float32))
    before = pool.clone()
    table = torch.tensor([[3, N], [1, 0]], dtype=torch.int32)
    new = torch.as_tensor(rng.standard_normal((2, KV, 3, hd)).astype(np.float32))
    slots = torch.tensor([[3, 4, 5], [6, 7, 8]])  # row 0 crosses into its
    # sentinel block; row 1 runs past the table (slot 8 = block 2)
    dest = tm._paged_pages(N, table, slots, P)
    tm._paged_cache_update(pool, new, dest)
    assert torch.equal(pool[3, :, 3], new[0, :, 0])
    assert torch.equal(pool[0, :, 2], new[1, :, 0])
    assert torch.equal(pool[0, :, 3], new[1, :, 1])
    untouched = [p for p in range(N) if p not in (0, 3)]
    assert torch.equal(pool[untouched], before[untouched])
    assert torch.equal(pool[3, :, :3], before[3, :, :3])
    assert torch.equal(pool[0, :, :2], before[0, :, :2])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_step_per_row_slots_match_jax(layout):
    """`decode_step` with a per-row [B] cache_index (rows at different
    depths, as continuous batching has them) against JAX's, on the tiny
    model: the logits and the K/V written at each row's own slot."""
    import jax

    from _torch_parity import LORA, jax_config, left_pad, make_params, port_config
    from nanorlhf_tpu.core import model as jm
    from nanorlhf_tpu.sampler.paged.pages import full_table as jax_full_table

    jcfg = jax_config("qwen_tied")
    cfg = port_config(jcfg)
    jparams, tparams = make_params(jcfg, seed=3)
    ids = left_pad([[5, 6, 7, 8], [9, 10], [11, 12, 13]], 5, 0)
    mask = ids != 0
    B, Tp, T, P = 3, 5, 12, 4
    nb = -(-T // P)
    slots = np.asarray([5, 7, 6], np.int32)
    key_mask = np.zeros((B, T), bool)
    key_mask[:, :Tp] = mask
    key_mask[np.arange(B), slots] = True
    tok = np.asarray([20, 21, 22], np.int32)
    pos = mask.sum(1).astype(np.int32)
    if layout == "paged":
        jtab, ttab = jax_full_table(B, nb), torch.as_tensor(tm_full_table(B, nb))
        jcache = jm.init_paged_kv_cache(jcfg, B * nb, P, jnp.float32)
        tcache = tm.init_paged_kv_cache(cfg, B * nb, P, torch.float32, "cpu")
        jkw, tkw = dict(page_table=jtab, page_size=P), dict(page_table=ttab, page_size=P)
        jpre, tpre = dict(jkw, logical_len=T), dict(tkw, logical_len=T)
    else:
        jcache = jm.init_kv_cache(jcfg, B, T, jnp.float32)
        tcache = tm.init_kv_cache(cfg, B, T, torch.float32, "cpu")
        jkw = tkw = jpre = tpre = {}
    _, jcache = jm.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), jcache,
                           lora_scale=LORA.scale, **jpre)
    tm.prefill(tparams, cfg, torch.as_tensor(ids).long(), torch.as_tensor(mask), tcache,
               lora_scale=LORA.scale, **tpre)
    jl, jcache = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(slots), jnp.asarray(key_mask), jcache,
                                lora_scale=LORA.scale, **jkw)
    tl, tcache = tm.decode_step(tparams, cfg, torch.as_tensor(tok).long(),
                                torch.as_tensor(pos).long(), torch.as_tensor(slots).long(),
                                torch.as_tensor(key_mask), tcache, lora_scale=LORA.scale,
                                **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    jk = np.asarray(jax.device_get(jcache[0]))
    tk = tcache[0].numpy()
    for r, t in enumerate(slots):
        if layout == "paged":
            page, off = r * nb + t // P, t % P
            np.testing.assert_allclose(tk[:, page, :, off], jk[:, page, :, off],
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(tk[:, r, :, t], jk[:, r, :, t], atol=1e-5, rtol=0)
