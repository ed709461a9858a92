"""Sequence parallelism in the port's dense trainer, on gloo ranks spawned
from the test (`parallel.distributed.spawn`): SP scoring against the JAX
package's `sp_score_logprobs` / `sp_score_values` on a 2-device CPU mesh
(2e-3), the update's gradients at sp = 2 against sp = 1 (one loss summed
over the ranks, not N), and GRPO, REINFORCE (remat), PPO, the sampler
capture's ref scorer and the flash ring's update at sp = 2 against sp = 1
on the same seed (5e-3 / 2e-3 on the LoRA leaves, JAX's
`tests/test_trainer_sp.py` tolerances), with the width check's ValueError.
The sp = 1 runs and the JAX side run in the test's process; each group of
ranks is spawned once a session (`_torch_sp_ranks.shared_spawn`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_ranks as R
from _torch_parity import LORA, jax_config, make_params, port_config
from nanorlhf_tpu.core.model import init_params as jax_init_params
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel import make_mesh as jax_make_mesh
from nanorlhf_tpu.parallel.sp import sp_score_logprobs as jax_sp_score_logprobs
from nanorlhf_tpu.parallel.sp import sp_score_values as jax_sp_score_values
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.ops.masking import logprobs_from_logits
from nanorlhf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from nanorlhf_tpu_torch.trainer.config import AlgoName

torch.set_num_threads(1)

PAD, CTX, RESP, TEMP = 0, 8, 8, 0.9
SCORE_TOL = 2e-3
LEAF_RTOL, LEAF_ATOL = 5e-3, 2e-3


def _rows(seed=3, vocab=128):
    rng = np.random.default_rng(seed)
    qr = rng.integers(4, vocab, (4, CTX + RESP)).astype(np.int32)
    qr[0, :5] = PAD      # a left-padded prompt whose first shard is mostly pad
    qr[1, :2] = PAD
    qr[2, CTX + 3:] = PAD  # a response cut short
    return qr


def _score_setup():
    jcfg = jax_config("qwen_tied")
    jparams, _ = make_params(jcfg, seed=5)
    vparams = jax_init_params(jcfg, jax.random.PRNGKey(6), jnp.float32)
    vparams = {k: v for k, v in vparams.items() if k != "lm_head"}
    vparams["score"] = jax.random.normal(jax.random.PRNGKey(7), (jcfg.hidden_size, 1)) * 0.1
    return jcfg, jparams, vparams


def _minibatch(seed=4):
    rng = np.random.default_rng(seed)
    qr = _rows(seed, vocab=4096).astype(np.int64)
    pm = qr[:, CTX:] == PAD
    return {"query_responses": qr, "responses": qr[:, CTX:],
            "logprobs": np.where(pm, 1.0, -rng.uniform(0.5, 3, pm.shape)).astype(np.float32),
            "ref_logprobs": np.where(pm, 1.0, -rng.uniform(0.5, 3, pm.shape)).astype(np.float32),
            "advantages": np.repeat(rng.normal(size=(4, 1)), RESP, 1).astype(np.float32),
            "padding_mask": pm}


GRAD_SPECS = {name: dict(cfg=dict(temperature=TEMP, kl_coef=0.05, lora_r=4, lora_alpha=8),
                         mb=_minibatch(), ctx=CTX, pad=PAD, remat=remat)
              for name, remat in (("plain", False), ("remat", True))}


def _trainer_cfg(**over):
    return dict(dict(response_length=8, temperature=1.0, sample_n=2, kl_coef=0.05,
                     total_episodes=4, per_device_train_batch_size=2,
                     gradient_accumulation_steps=1, num_mini_batches=1,
                     learning_rate=1e-3, lora_r=4, lora_alpha=8,
                     gradient_checkpointing=False, train_dataset_name="synthetic:32"),
                **over)


TRAINER_SPECS = {
    "grpo": dict(cfg=_trainer_cfg()),
    "reinforce_remat": dict(cfg=_trainer_cfg(
        algo=AlgoName.REINFORCE, sample_n=1, advantage_whiten=True,
        gradient_checkpointing=True)),
    "ppo": dict(algo="ppo", cfg=_trainer_cfg(algo=AlgoName.PPO, sample_n=1,
                                             total_episodes=2)),
    "capture": dict(cfg=_trainer_cfg(sampler_logprob_capture=True)),
    "flash_ring": dict(cfg=_trainer_cfg(attention_impl="pallas")),
    "odd_width": dict(cfg=_trainer_cfg(response_length=7)),
}
GROUPS = {"a": ("grpo", "reinforce_remat", "capture"), "b": ("ppo", "flash_ring", "odd_width")}


@pytest.fixture(scope="module")
def score_and_grads(tmp_path_factory):
    jcfg, jparams, vparams = _score_setup()
    tree = jax.tree.map(np.asarray, jparams)
    vtree = jax.tree.map(np.asarray, vparams)
    cfg = dataclasses.asdict(port_config(jcfg))
    cases = [("score", (tree, vtree, cfg, _rows(), PAD, TEMP, CTX, LORA.scale))]
    cases += [("grad", GRAD_SPECS[k]) for k in sorted(GRAD_SPECS)]
    ranks = R.shared_spawn(tmp_path_factory, "dense_score_grad", R.run_cases, 2, (cases,))
    return jcfg, jparams, vparams, ranks


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = {}
    for group, names in GROUPS.items():
        root = tmp_path_factory.mktemp(f"sp_trainers_{group}")
        specs = [dict(TRAINER_SPECS[n], out=str(root / n)) for n in names]
        ranks = R.shared_spawn(tmp_path_factory, f"dense_trainers_{group}", R.run_cases, 2,
                               ([("train", s) for s in specs],))
        for i, (name, spec) in enumerate(zip(names, specs)):
            out[name] = ([r[i] for r in ranks], R.train_once(dict(spec, out=str(root / "ctl")), 1))
    return out


def test_sp_score_matches_jax_and_one_device(score_and_grads):
    """Per-token logprobs, the response-scope entropy and the values on both
    ranks against JAX's SP scorers on a 2-device mesh, and against the
    port's own one-device forward."""
    jcfg, jparams, vparams, ranks = score_and_grads
    mesh = jax_make_mesh(JaxMeshConfig(1, 1, 1, 2), devices=jax.devices()[:2])
    qr = jnp.asarray(_rows())
    lp, ent = jax_sp_score_logprobs(jparams, jcfg, qr, PAD, TEMP, mesh,
                                    lora_scale=LORA.scale, with_entropy=True,
                                    entropy_from_position=CTX - 1)
    vals = jax_sp_score_values(vparams, jcfg, qr, PAD, mesh)
    _, tparams = make_params(jcfg, seed=5)
    logits = tm.padded_forward_logits(tparams, port_config(jcfg), torch.as_tensor(_rows()).long(),
                                      PAD, lora_scale=LORA.scale)
    one = logprobs_from_logits(logits[:, :-1], torch.as_tensor(_rows()[:, 1:]).long(), TEMP)
    # positions whose token and label are real (a pad query row attends to
    # no key: its output is unconstrained, and the losses mask it)
    rows = _rows()
    valid = (rows[:, :-1] != PAD) & (rows[:, 1:] != PAD)
    for rank in ranks:
        got = rank[0]
        np.testing.assert_allclose(got["logprobs"][:, :-1][valid], np.asarray(lp)[:, :-1][valid],
                                   rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(got["logprobs"][:, :-1][valid], one.numpy()[valid],
                                   rtol=0, atol=1e-5)
        assert got["logprobs"][:, -1].tolist() == [0.0] * 4
        assert abs(got["entropy"] - float(ent)) < SCORE_TOL
        np.testing.assert_allclose(got["values"][rows != PAD], np.asarray(vals)[rows != PAD],
                                   rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("name", sorted(GRAD_SPECS))
def test_sp_update_gradients_are_one_loss_not_n(score_and_grads, name):
    """The LoRA gradients of one microbatch loss at sp = 2, summed over the
    ranks as the update sums them, equal sp = 1's: each rank's backward
    carries its own shard's part of ONE loss. A loss counted on every rank
    through an autograd-aware gather would read 2x here."""
    ranks = score_and_grads[3]
    i = 1 + sorted(GRAD_SPECS).index(name)
    want = R.microbatch_grads(GRAD_SPECS[name])
    norm = np.sqrt(sum((g ** 2).sum() for g in want["grads"].values()))
    assert norm > 0
    for rank in ranks:
        got = rank[i]
        assert abs(got["loss"] - want["loss"]) < 1e-5 * max(1.0, abs(want["loss"]))
        assert abs(got["entropy"] - want["entropy"]) < 1e-5 * max(1.0, want["entropy"])
        diff = np.sqrt(sum(((got["grads"][k] - g) ** 2).sum() for k, g in want["grads"].items()))
        assert diff < 1e-4 * norm, (diff, norm)
        twice = np.sqrt(sum(((got["grads"][k] - 2 * g) ** 2).sum()
                            for k, g in want["grads"].items()))
        assert twice > 0.5 * norm


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LEAF_RTOL, atol=LEAF_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["grpo", "reinforce_remat", "ppo", "capture", "flash_ring"])
def test_sp2_update_matches_sp1(trained, name):
    """One update at sp = 2 against sp = 1 on the same seed: the same
    rollout (the hash check passed on both ranks), the LoRA leaves (and
    PPO's value leaves) within 5e-3 / 2e-3, the loss, KL and entropy rows
    within 1e-3 (PPO 2e-3), the rewards within 1e-6; the ranks agree with
    each other; the first row carries the transport's rows."""
    ranks, ctl = trained[name]
    want = ctl["rows"][0]
    tol = 2e-3 if name == "ppo" else 1e-3
    for got in ranks:
        assert "error" not in got, got.get("error")
        assert got["state"]["global_step"] == 1
        _assert_leaves_close(got["leaves"], ctl["leaves"])
        row = got["rows"][0]
        assert abs(row["eval_objective/scores_old"] - want["eval_objective/scores_old"]) < 1e-6
        for key in ("loss/policy_avg_new", "objective/kl_old", "policy/entropy_avg_new",
                    "loss/value_avg_new"):
            if key in want:
                assert abs(row[key] - want[key]) < tol, (key, row[key], want[key])
        assert row["sp/size"] == 2.0 and row["sp/backend_nccl"] == 0.0
        assert row["sp/host_staged"] == 0.0 and row["sp/hops"] > 0
    for k in ranks[0]["leaves"]:
        np.testing.assert_array_equal(ranks[0]["leaves"][k], ranks[1]["leaves"][k])
    if name == "capture":
        assert "sampler_capture/ratio_drift_new" in ranks[0]["rows"][0]
    if name == "flash_ring":
        # the scoring pass and the update ran the same ring: epoch-1 ratio 1
        assert abs(ranks[0]["rows"][0]["val/ratio_new"] - 1.0) < 1e-5


def test_sp_width_divisibility_enforced(trained):
    """A response width not divisible by sp raises JAX's ValueError on
    every rank."""
    ranks, _ = trained["odd_width"]
    for got in ranks:
        assert "divisible by sp" in got["error"]


def test_mesh_axes_beyond_sp_wait_for_a14b(monkeypatch):
    """A mesh that does not cover the world is a ValueError naming the
    launcher; JAX's `sp > 1 with tensor > 1` ValueError; the data and fsdp
    axes resolve (a world of 4 faked, its groups recorded: one per axis
    line, every rank creating every group in one order) and the tensor
    axis raises NotImplementedError naming A14c."""
    import types

    from nanorlhf_tpu_torch.parallel import mesh as pmesh

    assert make_mesh(MeshConfig()).sp == 1
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(MeshConfig(1, 1, 1, 2))
    made = []
    monkeypatch.setattr(pmesh, "world_size", lambda: 4)
    monkeypatch.setattr(pmesh, "dist", types.SimpleNamespace(
        get_rank=lambda: 3, get_backend=lambda: "gloo",
        new_group=lambda ranks: made.append(tuple(ranks)) or tuple(ranks),
        group=types.SimpleNamespace(WORLD="world")))
    monkeypatch.setattr(pmesh, "Transport", lambda group, backend: group)
    with pytest.raises(ValueError, match="sp > 1 with tensor > 1 is not supported"):
        make_mesh(MeshConfig(1, 1, 2, 2))
    for axes in (MeshConfig(1, 1, 4, 1), MeshConfig(2, 1, 2, 1)):
        with pytest.raises(NotImplementedError, match="A14c"):
            make_mesh(axes)
    m = make_mesh(MeshConfig())
    assert (m.data, m.fsdp, m.sp, m.coords) == (4, 1, 1, (3, 0, 0, 0))
    assert m.batch_transport == m.data_transport == "world" and made == []
    m = make_mesh(MeshConfig(2, 1, 1, 2))
    assert (m.data, m.sp, m.coords, m.batch_rank, m.sp_rank) == (2, 2, (1, 0, 0, 1), 1, 1)
    assert made == [(0, 2), (1, 3), (0, 1), (2, 3)]
    assert (m.data_transport, m.transport, m.batch_transport) == ((1, 3), (2, 3), (1, 3))
    made.clear()
    m = make_mesh(MeshConfig(1, 2, 1, 2))
    assert (m.fsdp, m.sp, m.fsdp_rank, m.batch_rank) == (2, 2, 1, 1)
    assert made == [(0, 2), (1, 3), (0, 1), (2, 3)]
    assert (m.fsdp_transport, m.transport, m.batch_transport) == ((1, 3), (2, 3), (1, 3))


def test_spawn_brings_the_group_down_when_a_rank_fails(tmp_path):
    """A rank that raises kills the group (the other rank waits in a
    barrier it can never leave) and `spawn` raises with its traceback,
    long before the join's timeout."""
    import time

    from nanorlhf_tpu_torch.parallel.distributed import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 planted failure"):
        spawn(R.fail_on_rank_1, 2, timeout=R.JOIN_TIMEOUT, store_dir=str(tmp_path))
    assert time.monotonic() - t0 < R.JOIN_TIMEOUT / 2


@pytest.mark.parametrize("case", ["one_rank", "backend", "device"])
def test_distributed_bring_up_on_one_process(case, monkeypatch):
    """`initialize_multihost` is a no-op for a world of 1 and returns JAX's
    summary keys; the backend is gloo on the CPU and for ranks that share a
    card, NCCL where each owns one; a rank's device follows LOCAL_RANK."""
    from nanorlhf_tpu_torch.parallel import distributed as pd

    if case == "one_rank":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        got = pd.initialize_multihost(device="cpu")
        assert {k: got[k] for k in ("process_index", "process_count")} == {
            "process_index": 0, "process_count": 1}
        assert set(got) >= {"local_device_count", "global_device_count", "backend"}
        assert pd.broadcast_host_value(7) == 7
    elif case == "backend":
        assert pd.choose_backend("cpu") == "gloo"
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        assert pd.choose_backend("cuda") == "gloo"
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        assert pd.choose_backend("cuda") == "nccl"
    else:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setenv("LOCAL_RANK", "3")
        assert pd.rank_device("cuda") == torch.device("cuda", 1)
        assert pd.rank_device("cpu") == torch.device("cpu")
