"""The flash-attention backward of the port (ops/attention.py) against the
JAX package, in f32: the plain backward (`flash_attention_backward_reference`,
what the port runs for CPU tensors and holds the Hopper kernels against)
and the CPU route's autograd through `flash_attention` vs `jax.grad`
through the JAX `flash_attention` (its Pallas backward in interpret mode,
as tests/test_attention.py runs it) and through `reference_attention`.
The dK/dV kernel's split: its schedule (`dkv_schedule`: every step the
causal mask leaves exactly once, none it removes, balanced at the update
shapes) and its plain version (`flash_bwd_dkv_split_reference`, walking
that schedule with small tiles so key tiles really split) against the
plain backward and against `jax.grad`.

Left-pad query rows whose keys are all masked are "garbage rows" in both
packages (their uniform P spreads over different padded key sets), so the
causal cases give them a zero cotangent, as the training path does, and a
separate test checks that a non-zero cotangent there stays finite."""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.ops.attention import flash_attention as jax_flash
from nanorlhf_tpu.ops.attention import reference_attention as jax_reference
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.ops.attention import (
    DKV_MAX_IMBALANCE,
    DKV_MIN_BLOCKS_PER_SM,
    dkv_balance,
    dkv_key_tile_steps,
    dkv_schedule,
    dkv_split_count,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_bwd_dkv,
    flash_bwd_dkv_split_reference,
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
    "causal_mha_ragged_T": (2, 2, 2, 13, 8, True, (0, 5)),
}
# the split's plain version at small tiles, so that T of 9-16 makes 3-4
# key tiles and the splits below cut them into parts
SPLIT_TILES = {"block_q": 4, "block_k": 4}
SPLITS = (1, 2, 3, 5)


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


def _split_inputs(case):
    """Inputs, the plain forward's residuals and Δ = Σ dO·O, as torch f32."""
    q, k, v, valid, w, causal = _inputs(case, seed=3)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    tvalid = torch.from_numpy(valid)
    out, lse = flash_attention_forward(tq, tk, tv, tvalid, causal)
    delta = (tw * out).sum(-1)
    return (q, k, v, valid, w, causal), (tq, tk, tv, tvalid, out, lse, delta, tw)


@functools.lru_cache(maxsize=None)
def _jax_flash_grads(case):
    args, _ = _split_inputs(case)
    return tuple(np.asarray(g) for g in _jax_grads(jax_flash, *args))


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_reference_matches_plain_backward(case, S):
    """Summing the parts' f32 partials in slot order gives the unsplit
    plain backward's dK/dV (1e-5 in f32: only the summation order moves)."""
    (_, _, _, _, _, causal), (tq, tk, tv, tvalid, out, lse, delta, tw) = _split_inputs(case)
    _, dk, dv = flash_attention_backward_reference(tq, tk, tv, tvalid, out, lse, tw, causal)
    got = flash_bwd_dkv_split_reference(tq, tk, tv, tvalid, lse, delta, tw, causal, S,
                                        **SPLIT_TILES)
    for g, want in zip(got, (dk, dv)):
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_reference_matches_jax_flash_grad(case, S):
    """The split's plain version vs `jax.grad` through the JAX flash
    kernel (Pallas backward in interpret mode)."""
    (_, _, _, _, _, causal), (tq, tk, tv, tvalid, out, lse, delta, tw) = _split_inputs(case)
    got = flash_bwd_dkv_split_reference(tq, tk, tv, tvalid, lse, delta, tw, causal, S,
                                        **SPLIT_TILES)
    want = _jax_flash_grads(case)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


def _schedule_steps(B, KV, G, T, causal, S, block_q, block_k):
    """Every (b, kv head, key tile, g, query tile) step the schedule's
    blocks walk, with its count."""
    steps = dkv_key_tile_steps(T, causal, block_q, block_k)
    blocks, _, _ = dkv_schedule(B, KV, G, T, causal, S, block_q, block_k)
    seen = collections.Counter()
    for b, kvh, x, first, end, _, _, _ in blocks:
        i0, n_i = steps[x]
        for s in range(first, end):
            seen[(b, kvh, x, s // n_i, i0 + s % n_i)] += 1
    return seen


def _unmasked_steps(B, KV, G, T, causal, block_q, block_k):
    """The steps in which the causal mask leaves some (query, key) pair."""
    n_q, n_k = -(-T // block_q), -(-T // block_k)
    left = set()
    for x in range(n_k):
        for i in range(n_q):
            last_q = min(T, (i + 1) * block_q) - 1
            if not causal or x * block_k <= last_q:
                left |= {(b, kvh, x, g, i) for b in range(B) for kvh in range(KV)
                         for g in range(G)}
    return left


SCHEDULE_SHAPES = {
    # name: (B, KV, T, block_q, block_k)
    "kernel_tiles": (2, 2, 300, 64, 64),
    "small_tiles": (1, 3, 37, 4, 4),
    "tall_query_tiles": (2, 1, 45, 8, 4),
}


@pytest.mark.parametrize("G", (1, 3, 7))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("shape", sorted(SCHEDULE_SHAPES))
def test_schedule_covers_each_unmasked_step_once(shape, S, causal, G):
    B, KV, T, bq, bk = SCHEDULE_SHAPES[shape]
    seen = _schedule_steps(B, KV, G, T, causal, S, bq, bk)
    left = _unmasked_steps(B, KV, G, T, causal, bq, bk)
    assert set(seen) >= left
    assert all(seen[step] == 1 for step in left)


@pytest.mark.parametrize("G", (1, 3, 7))
@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("shape", sorted(SCHEDULE_SHAPES))
def test_schedule_skips_masked_steps(shape, S, G):
    """Under the causal mask no block walks a (key tile, query tile) pair
    whose every key lies after every query."""
    B, KV, T, bq, bk = SCHEDULE_SHAPES[shape]
    seen = _schedule_steps(B, KV, G, T, True, S, bq, bk)
    assert set(seen) <= _unmasked_steps(B, KV, G, T, True, bq, bk)


@pytest.mark.parametrize("S", SPLITS)
def test_schedule_slots_and_order(S):
    """Blocks come heaviest first; each cut key tile's parts hold
    consecutive slots in step order, and a tile of one part writes bf16
    itself (slot -1)."""
    blocks, reduce, n_slots = dkv_schedule(2, 2, 3, 37, True, S, 4, 4)
    work = [r[4] - r[3] for r in blocks]
    assert work == sorted(work, reverse=True)
    parts = collections.defaultdict(list)
    for b, kvh, x, first, end, slot, _, _ in blocks:
        parts[(b, kvh, x)].append((first, end, slot))
    slots = []
    for b, kvh, x, slot0, n, _, _, _ in reduce:
        got = sorted(parts[(b, kvh, x)])
        assert [p[2] for p in got] == list(range(slot0, slot0 + n))
        assert all(got[p][1] == got[p + 1][0] for p in range(n - 1))
        slots += [p[2] for p in got]
    assert sorted(slots) == list(range(n_slots))
    cut = {(r[0], r[1], r[2]) for r in reduce}
    assert all(p[0][2] == -1 and len(p) == 1 for u, p in parts.items() if u not in cut)
    if S > 1:
        assert reduce  # the heaviest key tiles are cut


@pytest.mark.parametrize("T", (522, 1510))
def test_split_balance_at_update_shapes(T):
    """At the update's B=4, H=12, KV=2 on 132 SMs the chosen S gives at
    least two blocks per SM and no block above 1.3x the mean steps."""
    B, KV, G, sms = 4, 2, 6, 132
    S = dkv_split_count(B, KV, G, T, True, sms)
    n, mean, most = dkv_balance(dkv_schedule(B, KV, G, T, True, S)[0])
    assert S > 1
    assert n >= DKV_MIN_BLOCKS_PER_SM * sms
    assert most <= DKV_MAX_IMBALANCE * mean
    # without the split the heaviest key tile is far above the mean
    n1, mean1, most1 = dkv_balance(dkv_schedule(B, KV, G, T, True, 1)[0])
    assert n1 < DKV_MIN_BLOCKS_PER_SM * sms and most1 > DKV_MAX_IMBALANCE * mean1
