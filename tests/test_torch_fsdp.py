"""The fsdp axis on spawned gloo ranks against the JAX package on the
conftest's virtual CPU devices, f32 tiny models: `gather_shard` forward
and backward against an unsharded all-gather (the backward is its exact
transpose, a reduce-scatter); the fsdp = 2 forward through the per-layer
gather hook and its gradients against JAX's `padded_forward_logits` on
`shard_params` (JAX `test_sharding.py:47-61`), with no remat and under both
remat policies; `sp_fsdp_forward_logits` / `sp_score_logprobs(
fsdp_axis="fsdp")` at (1, 2, 1, 2) against JAX's at SCORE_TOL; and the
per-layer hook refusing KV caches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as M
import _torch_sp_ranks as R
from _torch_parity import LORA, jax_config, make_params, port_config
from nanorlhf_tpu.core.model import padded_forward_logits as jax_padded_forward_logits
from nanorlhf_tpu.core.model import padding_inputs as jax_padding_inputs
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel import make_mesh as jax_make_mesh
from nanorlhf_tpu.parallel.mesh import shard_params as jax_shard_params
from nanorlhf_tpu.parallel.sp import sp_fsdp_forward_logits as jax_sp_fsdp_forward_logits
from nanorlhf_tpu.parallel.sp import sp_score_logprobs as jax_sp_score_logprobs
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)

PAD, TEMP = 0, 0.9
SCORE_TOL = 2e-3
# f32 on both sides: the forward agrees to f32 rounding, and each gradient
# (a sum over every logit of the rows, |g| up to ~150 here) within
# GRAD_SCALE_TOL of its leaf's largest element
FWD_ATOL, GRAD_RTOL, GRAD_SCALE_TOL = 1e-4, 1e-4, 2e-6
GATHER_DIMS = (0, 1, 2)
REMATS = {"none": (False, "full"), "full": (True, "full"), "dots": (True, "dots")}
# the spawned groups' join, with room for a loaded CPU
JOIN_TIMEOUT = 300.0


def _rows(seed=3, vocab=128, rows=4, width=16):
    rng = np.random.default_rng(seed)
    qr = rng.integers(4, vocab, (rows, width)).astype(np.int64)
    qr[0, :5] = PAD
    qr[1, :2] = PAD
    qr[2, 11:] = PAD
    return qr


def _gather_arg(dim):
    rng = np.random.default_rng(dim)
    full = rng.standard_normal((4, 6, 8)).astype(np.float32)
    return {"axes": (1, 2, 1, 1), "full": full, "dim": dim,
            "w": rng.standard_normal((2,) + full.shape).astype(np.float32)}


def _setup():
    jcfg = jax_config("llama_untied")
    jparams, _ = make_params(jcfg, seed=9)
    return jcfg, jparams


def _tree_arg(jcfg, jparams, **extra):
    return {"cfg": dataclasses.asdict(port_config(jcfg)),
            "tree": jax.tree.map(np.asarray, jparams), "pad": PAD,
            "lora_scale": LORA.scale, **extra}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jcfg, jparams = _setup()
    w = np.random.default_rng(5).standard_normal((4, 16, jcfg.vocab_size)).astype(np.float32)
    cases = [("gather", _gather_arg(d)) for d in GATHER_DIMS]
    cases += [("fsdp_forward", _tree_arg(jcfg, jparams, axes=(1, 2, 1, 1), qr=_rows(), w=w,
                                         remat=r, remat_policy=p))
              for r, p in (REMATS[k] for k in sorted(REMATS))]
    return R.shared_spawn(tmp_path_factory, "fsdp_two", M.run_cases, 2, (cases,),
                          timeout=JOIN_TIMEOUT)


@pytest.mark.parametrize("dim", GATHER_DIMS)
def test_gather_shard_forward_and_transpose(ranks, dim):
    """The forward is the whole leaf on every rank; the backward of
    sum(full · w_r) summed over the ranks, cut to each rank's slice — the
    reduce-scatter that transposes the all-gather — exactly."""
    arg = _gather_arg(dim)
    i = GATHER_DIMS.index(dim)
    total = arg["w"].sum(0)
    n = arg["full"].shape[dim] // 2
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got[i]["out"], arg["full"])
        want = np.take(total, range(rank * n, (rank + 1) * n), axis=dim)
        np.testing.assert_allclose(got[i]["grad"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat", sorted(REMATS))
def test_fsdp_forward_and_gradients_match_jax(ranks, remat):
    """The fsdp = 2 forward (embedding and head gathered up front, each
    layer through the hook, under checkpointing inside the layer) against
    JAX's `padded_forward_logits` on `shard_params` over a (1, 2, 1, 1)
    mesh, and the whole gradients of sum(logits · w) for the LoRA leaves
    and the embedding against `jax.grad`, on both ranks; the gradients come
    out sharded like the leaves."""
    jcfg, jparams = _setup()
    mesh = jax_make_mesh(JaxMeshConfig(1, 2, 1, 1), devices=jax.devices()[:2])
    sharded = jax_shard_params(jparams, mesh)
    qr = jnp.asarray(_rows())
    w = jnp.asarray(np.random.default_rng(5).standard_normal((4, 16, jcfg.vocab_size)),
                    jnp.float32)
    use_remat, policy = REMATS[remat]
    jcfg = dataclasses.replace(jcfg, remat_policy=policy)

    def loss(train):
        p = {**sharded, "embed_tokens": train["embed_tokens"], "lora": train["lora"]}
        return (jax_padded_forward_logits(p, jcfg, qr, PAD, lora_scale=LORA.scale,
                                          remat=use_remat) * w).sum()

    train = {"embed_tokens": sharded["embed_tokens"], "lora": sharded["lora"]}
    logits = jax_padded_forward_logits(sharded, jcfg, qr, PAD, lora_scale=LORA.scale)
    grads = flatten(jax.tree.map(np.asarray, jax.grad(loss)(train)))
    i = len(GATHER_DIMS) + sorted(REMATS).index(remat)
    for got in ranks:
        got = got[i]
        np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=0, atol=FWD_ATOL)
        for path, g in grads.items():
            key = "/".join(path)
            want = np.swapaxes(g, -1, -2) if path[-1] in ("a", "b") else g
            np.testing.assert_allclose(got["grads"][key], want, rtol=GRAD_RTOL,
                                       atol=GRAD_SCALE_TOL * np.abs(want).max(), err_msg=key)
        assert got["shard_shapes"]["embed_tokens"][1] == jcfg.hidden_size // 2
        assert got["shard_shapes"]["lora/layers/q_proj/a"][-1] == jcfg.hidden_size // 2


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    jcfg, jparams = _setup()
    arg = _tree_arg(jcfg, jparams, axes=(1, 2, 1, 2), qr=_rows(), temperature=TEMP)
    return R.shared_spawn(tmp_path_factory, "sp_fsdp_four", M.run_cases, 4,
                          ([("sp_fsdp", arg)],), timeout=JOIN_TIMEOUT)


@pytest.mark.parametrize("what", ["logits", "logprobs"])
def test_sp_fsdp_forward_matches_jax(sp_ranks, what):
    """`sp_fsdp_forward_logits` at (1, 2, 1, 2): each rank's logits shard is
    JAX's over its sp rank's quarter of the sequence; the per-token
    logprobs of `sp_score_logprobs(fsdp_axis="fsdp")` are JAX's on every
    rank (positions whose token and label are real), at SCORE_TOL."""
    jcfg, jparams = _setup()
    mesh = jax_make_mesh(JaxMeshConfig(1, 2, 1, 2), devices=jax.devices()[:4])
    sharded = jax_shard_params(jparams, mesh)
    rows = _rows()
    qr = jnp.asarray(rows)
    if what == "logits":
        ids, mask, pos = jax_padding_inputs(qr, PAD)
        want = np.asarray(jax_sp_fsdp_forward_logits(sharded, jcfg, ids, mask, pos, mesh,
                                                     lora_scale=LORA.scale))
        t = rows.shape[1] // 2
        valid = rows != PAD
        for got in sp_ranks:
            got = got[0]
            sl = slice(got["sp_rank"] * t, (got["sp_rank"] + 1) * t)
            np.testing.assert_allclose(got["logits"][valid[:, sl]], want[:, sl][valid[:, sl]],
                                       rtol=0, atol=SCORE_TOL)
        return
    want = np.asarray(jax_sp_score_logprobs(sharded, jcfg, qr, PAD, TEMP, mesh,
                                            fsdp_axis="fsdp", lora_scale=LORA.scale))
    valid = (rows[:, :-1] != PAD) & (rows[:, 1:] != PAD)
    for got in sp_ranks:
        lp = got[0]["logprobs"]
        np.testing.assert_allclose(lp[:, :-1][valid], want[:, :-1][valid], rtol=0,
                                   atol=SCORE_TOL)
        assert (lp[:, -1] == 0).all()


def test_layer_transform_takes_no_cache():
    """The per-layer hook runs on cache-free forwards only: with KV caches
    `_run_layers` raises instead of dropping them."""
    from nanorlhf_tpu_torch.core import model as tm

    mcfg = port_config(jax_config("qwen_tied", vocab_size=64))
    _, params = make_params(jax_config("qwen_tied", vocab_size=64), seed=1)
    x = torch.zeros((1, 2, mcfg.hidden_size))
    caches = tuple(torch.zeros((mcfg.num_hidden_layers, 1)) for _ in range(2))
    with pytest.raises(ValueError, match="cache-free"):
        tm._run_layers(mcfg, params, x, None, None, None, kv_caches=caches,
                       layer_transform=lambda layer, lora: (layer, lora))
