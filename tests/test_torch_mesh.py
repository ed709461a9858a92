"""The port's mesh (`parallel/mesh.py`) against the JAX package's on the
conftest's 8 virtual CPU devices: each rank's coordinates against
`make_mesh(...).devices` (JAX's `reshape(d, f, t, s)`, `dcn_data` too),
`param_sharding_rules` spec for spec (LoRA, `kernel_q`, `kernel_scale`)
and through the bridge's transpose, `shard_params` slices bit-equal to
JAX's `addressable_shards` at fsdp 2 and 4, `batch_sharding` blocks equal
to JAX's shards, and `make_mesh` over spawned gloo ranks (the groups'
coordinates and blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as M
import _torch_sp_ranks as R
from _torch_parity import jax_config, make_params
from nanorlhf_tpu.core.quant import quantize_layers as jax_quantize_layers
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel import make_mesh as jax_make_mesh
from nanorlhf_tpu.parallel import mesh as jmesh
from nanorlhf_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from nanorlhf_tpu.parallel.mesh import param_sharding_rules as jax_rules
from nanorlhf_tpu.parallel.mesh import shard_params as jax_shard_params
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.parallel import mesh as pmesh
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)

AXES = {"d2f2": (2, 2, 1, 1), "d2s2": (2, 1, 1, 2), "f2s2": (1, 2, 1, 2),
        "d4": (4, 1, 1, 1)}


def _jax_mesh(axes, dcn=1):
    n = int(np.prod(axes))
    return jax_make_mesh(JaxMeshConfig(*axes, dcn_data=dcn), devices=jax.devices()[:n])


def _fake_mesh(axes, rank):
    return pmesh.Mesh(*axes, rank=rank, coords=pmesh.coords_of(rank, axes))


@pytest.mark.parametrize("name", sorted(AXES) + ["dcn2"])
def test_rank_coordinates_match_jax_mesh(name):
    """Rank r sits where JAX's mesh puts device r: ((i_d·f + i_f)·t + i_t)·s
    + i_s; `dcn_data=2` keeps the id order on hosts without slices."""
    axes, dcn = (AXES[name], 1) if name != "dcn2" else ((4, 1, 1, 1), 2)
    mesh = _jax_mesh(axes, dcn)
    devices = np.asarray(mesh.devices)
    for r in range(int(np.prod(axes))):
        (where,) = np.argwhere(np.vectorize(lambda d: d.id)(devices) == r)
        assert tuple(int(x) for x in where) == pmesh.coords_of(r, axes)


def _tree(kind):
    jparams, _ = make_params(jax_config(kind), seed=3)
    return jparams


@pytest.mark.parametrize("kind", ["qwen_tied", "llama_untied"])
def test_param_sharding_rules_match_jax_spec_for_spec(kind):
    """Every leaf's spec (the LoRA subtree's included) is JAX's, and the
    port's spec is JAX's through the bridge's transpose: the last two
    entries swapped for kernels, lm_head and LoRA a/b."""
    tree = _tree(kind)
    want = flatten(jax.tree.map(tuple, jax_rules(tree),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    got = flatten(pmesh.param_sharding_rules(jax.tree.map(np.asarray, tree)))
    assert got.keys() == want.keys() and {p: tuple(v) for p, v in got.items()} == want
    port = flatten(params_from_numpy(jax.tree.map(np.asarray, tree)))
    for path, spec in want.items():
        t = port[path]
        full = list(spec) + [None] * (t.dim() - len(spec))
        if path[-1] in ("kernel", "lm_head", "a", "b"):
            full[-1], full[-2] = full[-2], full[-1]
        assert pmesh.port_spec(path, t.dim()) == tuple(full), path
    assert pmesh.port_spec(("layers", "q_proj", "kernel"), 3)[-1] == "fsdp"


def test_quantized_kernel_specs_match_jax():
    """`kernel_q` shards like its kernel, `kernel_scale` keeps the
    out-axis entry with the contracted axis unsharded (JAX's int8 rollout
    tree), under the port's layout too."""
    tree = _tree("qwen_tied")
    layers = jax_quantize_layers(tree["layers"])
    want = flatten(jax.tree.map(tuple, jax_rules({"layers": layers}),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert any(p[-1] == "kernel_scale" for p in want)
    for path, spec in want.items():
        assert pmesh._spec_for_path(path) == spec, path
        assert jmesh._spec_for_path(path) == jax.sharding.PartitionSpec(*spec)
    assert pmesh.port_spec(("layers", "q_proj", "kernel_scale"), 3) == (None, None, "tensor")
    assert pmesh.port_spec(("layers", "o_proj", "kernel_scale"), 3) == (None, None, "fsdp")
    assert pmesh.fsdp_dim(("layers", "down_proj", "kernel_q"), 3) == 1


@pytest.mark.parametrize("fsdp", [2, 4])
def test_shard_params_equal_jax_addressable_shards(fsdp):
    """Each fsdp rank's slice of every leaf, bit for bit JAX's shard on the
    device at that coordinate (transposed by the bridge for kernels, heads
    and LoRA)."""
    tree = _tree("llama_untied")
    jmesh_ = _jax_mesh((1, fsdp, 1, 1))
    sharded = flatten(jax_shard_params(tree, jmesh_))
    full = params_from_numpy(jax.tree.map(np.asarray, tree))
    cut = 0
    for i in range(fsdp):
        got = flatten(pmesh.shard_params(full, _fake_mesh((1, fsdp, 1, 1), i)))
        for path, arr in sharded.items():
            (shard,) = [s for s in arr.addressable_shards if s.device.id == i]
            want = np.asarray(shard.data)
            if path[-1] in ("kernel", "lm_head", "a", "b"):
                want = np.swapaxes(want, -1, -2)
            np.testing.assert_array_equal(got[path].numpy(), want, err_msg="/".join(path))
            cut += got[path].numel() < flatten(full)[path].numel()
    assert cut > 0


@pytest.mark.parametrize("name", ["d2f2", "f2s2", "d4"])
def test_batch_sharding_blocks_equal_jax_shards(name):
    """`batch_sharding` gives rank r the rows JAX's (data, fsdp) batch
    sharding places on device r; sp peers hold the same block."""
    axes = AXES[name]
    mesh = _jax_mesh(axes)
    rows = 8
    x = jax.device_put(jnp.arange(rows * 3).reshape(rows, 3), jax_batch_sharding(mesh))
    for shard in x.addressable_shards:
        block = pmesh.batch_sharding(_fake_mesh(axes, shard.device.id), rows)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      np.arange(rows * 3).reshape(rows, 3)[block])
    with pytest.raises(ValueError, match="batch ranks"):
        pmesh.batch_sharding(_fake_mesh((4, 1, 1, 1), 1), 6)


def test_shard_params_refuses_an_indivisible_leaf():
    leaf = {"embed_tokens": torch.zeros(10, 6)}
    with pytest.raises(ValueError, match="embed_tokens"):
        pmesh.shard_params(leaf, _fake_mesh((1, 4, 1, 1), 0))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    cases = [("mesh", {"axes": AXES["d2f2"], "rows": 8}),
             ("mesh", {"axes": AXES["f2s2"], "rows": 8})]
    return R.shared_spawn(tmp_path_factory, "mesh_groups", M.run_cases, 4, (cases,),
                          timeout=300.0)


@pytest.mark.parametrize("i,name", [(0, "d2f2"), (1, "f2s2")])
def test_make_mesh_over_spawned_ranks(spawned, i, name):
    """`make_mesh` on four gloo ranks: each rank's coordinates and its batch
    block are JAX's device placement's; `Transport.broadcast_` over the
    batch line hands every rank its first rank's tensor."""
    axes = AXES[name]
    mesh = _jax_mesh(axes)
    x = jax.device_put(jnp.arange(8), jax_batch_sharding(mesh, ndim=1))
    for rank, got in enumerate(spawned):
        got = got[i]
        assert got["rank"] == rank and got["coords"] == pmesh.coords_of(rank, axes)
        np.testing.assert_array_equal(got["broadcast"], [0.0, 0.0, 0.0])
        (shard,) = [s for s in x.addressable_shards if s.device.id == rank]
        assert list(range(*got["block"])) == np.asarray(shard.data).tolist()
