"""The port's rings (`parallel/ring_attention.py`) on spawned gloo ranks
against the JAX package's: the einsum ring on its 8-device CPU mesh and the
flash ring (Pallas in interpret mode) on 2 devices, and the plain full
attention — causal, non-causal, GQA, a left-padded row whose first shards
are all masked, a width that is not a multiple of 128, and the backward
(dQ, dK, dV of sum(out · w)). JAX's tolerances: 2e-4 against the
reference and the einsum ring, 2e-5 flash ring against flash ring. The
port runs at 2 and 4 ranks, both rings each; each group is spawned once a
session."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_sp_ranks as R
from nanorlhf_tpu.ops.attention import reference_attention
from nanorlhf_tpu.parallel.ring_attention import ring_attention, ring_attention_flash
from nanorlhf_tpu.utils.shardmap_compat import shard_map

torch.set_num_threads(1)

TOL, RING_TOL = 2e-4, 2e-5
SPECS = dict(in_specs=(P(None, None, "sp", None), P(None, None, "sp", None),
                       P(None, None, "sp", None), P(None, "sp")),
             out_specs=P(None, None, "sp", None))


def _case(seed, B, H, KV, T, d, valid_rows, causal=True):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, T), bool)
    for b, (lo, hi) in valid_rows.items():
        valid[b, :lo] = False
        valid[b, hi:] = False
    return {"q": rng.normal(size=(B, H, T, d)).astype(np.float32),
            "k": rng.normal(size=(B, KV, T, d)).astype(np.float32),
            "v": rng.normal(size=(B, KV, T, d)).astype(np.float32),
            "valid": valid, "causal": causal,
            "w": (rng.normal(size=(B, H, T, d)) * valid[:, None, :, None]).astype(np.float32)}


# JAX's ring tests' shapes (tests/test_ring_attention.py), plus a row whose
# first 20 keys are masked (all of rank 0's, and more, at 4 ranks)
CASES = {
    "causal": _case(1, 2, 4, 2, 32, 8, {0: (6, 32)}),
    "non_causal": _case(2, 1, 2, 2, 16, 8, {}, causal=False),
    "gqa": _case(3, 1, 8, 2, 16, 8, {}),
    "masked_shards": _case(4, 2, 4, 2, 32, 8, {1: (20, 32)}),
    "flash_2way": _case(5, 2, 4, 2, 256, 16, {1: (0, 196)}),
    "non_aligned": _case(6, 1, 4, 2, 384, 16, {0: (0, 334)}),
}
SMALL = ("causal", "non_causal", "gqa", "masked_shards")
WORLDS = {2: tuple(CASES), 4: SMALL}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: {case: {ring: (out, dq, dk, dv) global}}}: the ranks' shards
    concatenated along T."""
    got = {}
    for world, names in WORLDS.items():
        ranks = R.shared_spawn(tmp_path_factory, f"ring_{world}", R.run_cases, world,
                               ([("ring", CASES[n]) for n in names],))
        got[world] = {
            name: {ring: tuple(np.concatenate([r[i][ring][j] for r in ranks], axis=2)
                               for j in range(4))
                   for ring in ("einsum", "flash")}
            for i, name in enumerate(names)}
    return got


def _jax_ring(fn, case, n_dev, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("sp",))
    ring = shard_map(partial(fn, axis_name="sp", causal=case["causal"], **kw), mesh=mesh,
                     check_vma=False, **SPECS)
    q, k, v, valid, w = (jnp.asarray(case[n]) for n in ("q", "k", "v", "valid", "w"))
    out = jax.jit(ring)(q, k, v, valid)
    grads = jax.jit(jax.grad(lambda q_, k_, v_: (ring(q_, k_, v_, valid) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return (np.asarray(out), *map(np.asarray, grads))


def _reference(case):
    q, k, v, valid, w = (jnp.asarray(case[n]) for n in ("q", "k", "v", "valid", "w"))
    out = reference_attention(q, k, v, valid, case["causal"])
    grads = jax.grad(lambda q_, k_, v_: (reference_attention(q_, k_, v_, valid,
                                                             case["causal"]) * w).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out), *map(np.asarray, grads))


def _close(got, want, valid, tol, what):
    """out at the valid query rows (a row with no valid key is
    unconstrained); dq, dk, dv everywhere (w is zero on those rows)."""
    rows = valid[:, None, :, None]
    np.testing.assert_allclose(got[0] * rows, want[0] * rows, rtol=tol, atol=tol,
                               err_msg=f"{what}: out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("world,name", [(w, n) for w, ns in WORLDS.items() for n in ns])
@pytest.mark.parametrize("ring", ["einsum", "flash"])
def test_ring_matches_reference(port, world, name, ring):
    case = CASES[name]
    _close(port[world][name][ring], _reference(case), case["valid"], TOL,
           f"{ring} ring at {world} ranks vs the reference")


@pytest.mark.parametrize("name", SMALL)
def test_einsum_ring_matches_jax_einsum_ring_on_8_devices(port, name):
    case = CASES[name]
    want = _jax_ring(ring_attention, case, 8)
    for world in WORLDS:
        _close(port[world][name]["einsum"], want, case["valid"], TOL,
               f"einsum ring at {world} ranks vs JAX's on 8 devices")


@pytest.mark.parametrize("name", ["flash_2way", "non_aligned", "masked_shards"])
def test_flash_ring_matches_jax_flash_ring(port, name):
    """Against JAX's flash ring (Pallas per hop, interpret mode) on 2
    devices: the forward ring against ring at 2e-5, the backward at 2e-4;
    the port's two rings agree at 2e-5."""
    case = CASES[name]
    want = _jax_ring(ring_attention_flash, case, 2, block_q=64, block_k=64) \
        if name == "flash_2way" else _jax_ring(ring_attention_flash, case, 2)
    got = port[2][name]["flash"]
    rows = case["valid"][:, None, :, None]
    np.testing.assert_allclose(got[0] * rows, want[0] * rows, rtol=RING_TOL, atol=RING_TOL)
    _close(got, want, case["valid"], TOL, "flash ring vs JAX's flash ring")
    _close(port[2][name]["einsum"], got, case["valid"], RING_TOL, "einsum vs flash ring")
