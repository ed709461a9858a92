"""The data and fsdp axes end to end on spawned gloo ranks, f32 tiny
models, against the JAX package on the conftest's virtual CPU devices and
against the port's own one-rank run of the same global batch:

- the update: two `update_minibatch` steps at data = 2 and at fsdp = 2
  against the JAX trainer's `_update_fn` on a 2-device mesh (leaves, Adam
  moments, loss stats, grad norm), with `max_grad_norm` small enough to
  clip, with ranks holding very different counts of valid tokens (the
  loss is the global masked mean), and PPO at fsdp = 2 (the value tree
  sharded: its leaves and moments too); each fsdp rank holds the rules'
  share of the leaves and the moments; the sparse trainer at data = 2
  against JAX's SparseGRPOTrainer on a scripted rollout, its 1-row
  buckets padded to the batch ranks with masked rows;
- the trainers: one greedy (top-k 1) GRPO update at data = 2 and at
  fsdp = 2 — the gathered rollout equal to JAX's greedy stream, the rows
  and the trainable leaves against the one-rank run at LEAF_RTOL /
  LEAF_ATOL; PPO at fsdp = 2 (the value tree sharded); RLOO, ReMax,
  REINFORCE and RAFT at data = 2 in one spawn; sparse GRPO at data = 2;
  compacting decode at data = 2; an fsdp = 2 checkpoint resumed at
  data = 1 and at data = 2; `common.build_trainer` under a world of 2 with
  the default `MeshConfig()`; SIGTERM on one fsdp rank preempting both;
  the paths that wait for A14c refused.

The one-rank runs and the JAX side run in the test's process; each group
of ranks is spawned once a session (`_torch_sp_ranks.shared_spawn`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as M
import _torch_sp_ranks as R
import test_torch_sparse_grpo as S
from _torch_parity import LORA, closes_trainers, jax_config, make_params  # noqa: F401
from _torch_parity import port_config
from nanorlhf_tpu.core.config import ModelConfig as JaxModelConfig
from nanorlhf_tpu.data import ToyTokenizer as JaxToyTokenizer
from nanorlhf_tpu.data import load_prompt_dataset as jax_load_dataset
from nanorlhf_tpu.parallel import MeshConfig as JaxMeshConfig
from nanorlhf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanorlhf_tpu.sampler import SamplingParams as JaxSamplingParams
from nanorlhf_tpu.sampler import generate as jax_generate
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer import RLConfig as JaxRLConfig
from nanorlhf_tpu.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.parallel.fsdp import rule_share
from nanorlhf_tpu_torch.trainer.config import AlgoName
from nanorlhf_tpu_torch.trainer.optim import flatten

torch.set_num_threads(1)

LEAF_RTOL, LEAF_ATOL = 5e-3, 2e-3
D2, F2 = (2, 1, 1, 1), (1, 2, 1, 1)
# a group of trainers on loaded CPUs (the suite runs beside it) can take
# minutes: the join waits this long before it kills the ranks
TRAIN_JOIN_TIMEOUT = 600.0

# ---------------------------------------------------------------------------
# the update against JAX's `_update_fn` on a 2-device mesh
# ---------------------------------------------------------------------------

KNOBS = dict(
    algo="grpo", response_length=6, temperature=0.8, sample_n=2, total_episodes=64,
    per_device_train_batch_size=2, gradient_accumulation_steps=2, num_mini_batches=2,
    num_ppo_epochs=1, learning_rate=1e-3, min_lr_rate=0.1, adam_eps=1e-5,
    weight_decay=0.01, kl_coef=0.05, cliprange=0.2, use_lora=True,
    lora_r=LORA.r, lora_alpha=LORA.alpha, save_steps=0, report_to="none",
    fused_logprob_chunk=5,
)
CTX, PAD, ROWS = 7, 0, 4
# PPO's knobs (tests/test_torch_update_algos.py's): the value group
PPO = {"algo": "ppo", "sample_n": 1, "value_learning_rate": 3e-3, "vf_coef": 0.1,
       "cliprange_value": 0.2, "value_lora_r": LORA.r, "value_lora_alpha": LORA.alpha}
UPDATES = {"data2": (D2, {}, False), "fsdp2": (F2, {}, False),
           "fsdp2_clip": (F2, {"max_grad_norm": 0.05}, False),
           "data2_uneven": (D2, {}, True), "ppo_fsdp2": (F2, PPO, False)}


# the sparse trainer at data = 2 over tests/test_torch_sparse_grpo.py's
# scripted rollout (its global batch of 8 prompts: 4 a rank): 2 zero-reward
# groups leave 6 kept rows; buckets of 1 row (odd) are padded to 2 with a
# masked row, where JAX keeps 1 row (its rows menu) and GSPMD splits it
SPARSE_KNOBS = {**S.KNOBS, "per_device_train_batch_size": 2}
SPARSE_ROLLOUT = (S._responses(0), S._rewards(0, zero_groups=(1, 5)))


def _sparse_setup():
    jmodel = jax_config("qwen_tied", vocab_size=S.V)
    jparams, _ = make_params(jmodel, seed=3)
    return jmodel, jparams


def _minibatch(seed, uneven, ppo=False):
    rng = np.random.default_rng(seed)
    T = KNOBS["response_length"]
    q = rng.integers(3, 64, (ROWS, CTX)).astype(np.int64)
    q[1, :3] = PAD
    r = rng.integers(3, 64, (ROWS, T)).astype(np.int64)
    pm = np.zeros((ROWS, T), bool)
    pm[2, 4:] = True
    if uneven:
        # rank 0's rows of each microbatch (rows 0 and 1: microbatch g is
        # rows g::2, rank 0 takes its first) hold one valid token each, rank
        # 1's all of theirs: an average of the ranks' means would weight
        # one token like T
        pm[:2, 1:] = True
    r[pm] = PAD
    old = (rng.standard_normal((ROWS, T)) * 0.3 - 4).astype(np.float32)
    mb = {"query_responses": np.concatenate([q, r], 1), "responses": r,
          "logprobs": np.where(pm, 1.0, old).astype(np.float32),
          "ref_logprobs": np.where(pm, 1.0, old + 0.1).astype(np.float32),
          "advantages": np.where(pm, 0.0, rng.standard_normal((ROWS, T))).astype(np.float32),
          "padding_mask": pm, "padding_mask_p1": pm}
    if ppo:
        mb["values"] = np.where(pm, 0.0, rng.standard_normal((ROWS, T)) * 0.3
                                ).astype(np.float32)
        mb["returns"] = rng.standard_normal((ROWS, T)).astype(np.float32)
    return mb


def _mbs(name):
    _, over, uneven = UPDATES[name]
    return [_minibatch(s, uneven, over.get("algo") == "ppo") for s in (1, 2)]


def _update_setup(name):
    """The JAX model, its params, and for PPO its value tree (numpy)."""
    from test_torch_update_algos import _value_tree

    jmodel = jax_config("qwen_tied", vocab_size=64)
    jparams, _ = make_params(jmodel, seed=11)
    ppo = UPDATES[name][1].get("algo") == "ppo"
    return jmodel, jparams, (_value_tree(jmodel, jparams) if ppo else None)


@pytest.fixture(scope="module")
def updates(tmp_path_factory):
    """Every UPDATES case, then the sparse trainer's scripted rollout at
    data = 2 (SPARSE), on one group of two ranks."""
    cases = []
    for name in sorted(UPDATES):
        axes, over, _ = UPDATES[name]
        jmodel, jparams, jvalue = _update_setup(name)
        cases.append(("update", {
            "axes": axes, "cfg": dataclasses.asdict(port_config(jmodel)),
            "tree": jax.tree.map(np.asarray, jparams), "value_tree": jvalue,
            "knobs": {**KNOBS, **over}, "lora": {"r": LORA.r, "alpha": LORA.alpha},
            "mbs": _mbs(name), "ctx": CTX, "pad": PAD, "lora_scale": LORA.scale}))
    jmodel, jparams = _sparse_setup()
    cases.append(("sparse_script", {
        "axes": D2, "cfg": dataclasses.asdict(port_config(jmodel)),
        "tree": jax.tree.map(np.asarray, jparams), "vocab": S.V, "knobs": SPARSE_KNOBS,
        "out": str(tmp_path_factory.mktemp("dp_sparse") / "port"),
        "responses": SPARSE_ROLLOUT[0], "rewards": SPARSE_ROLLOUT[1],
        "budgets": (S.FORWARD_BUDGET, S.BACKWARD_BUDGET)}))
    return R.shared_spawn(tmp_path_factory, "dp_updates", M.run_cases, 2, (cases,),
                          timeout=TRAIN_JOIN_TIMEOUT)


def _jax_update(tmp_path, name):
    axes, over, uneven = UPDATES[name]
    jmodel, jparams, jvalue = _update_setup(name)
    jcfg = JaxRLConfig(**{**KNOBS, **over, "algo": JaxAlgoName(over.get("algo", "grpo"))},
                       output_dir=str(tmp_path), mesh=JaxMeshConfig(*axes))
    tok = JaxToyTokenizer(vocab_size=64)
    jtr = JaxRLTrainer(jcfg, jmodel, tok, jparams, jax_load_dataset("synthetic:64", tok),
                       lambda texts, eos: np.zeros(len(texts), np.float32),
                       value_params=None if jvalue is None else jax.tree.map(jnp.asarray, jvalue),
                       mesh=jax_make_mesh(jcfg.mesh, devices=jax.devices()[:int(np.prod(axes))]))
    try:
        trainable, frozen = jtr._partition(jtr._train_tree(jtr.params, jtr.value_params))
        opt_state, stats = jtr.opt_state, []
        for mb in _mbs(name):
            trainable, opt_state, st = jtr._update_fn(
                trainable, frozen, opt_state, {k: jnp.asarray(v) for k, v in mb.items()}, CTX)
            stats.append(jax.device_get(st))
    finally:
        jtr.close()
    import optax

    # each group's ScaleByAdamState, in group order (policy, value)
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState) and jax.tree_util.tree_leaves(s.mu)]
    return trainable, adams, stats


def _jax_layout(tree) -> dict:
    """{path string: numpy} of a JAX-layout tree in the port's layout."""
    flat = flatten(jax.tree.map(np.asarray, tree))
    return {"/".join(p): (np.swapaxes(v, -1, -2) if p[-1] in ("a", "b", "kernel") else v)
            for p, v in flat.items() if v is not None}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_matches_jax_update_fn_on_two_devices(updates, name, tmp_path):
    """Two steps at data = 2 / fsdp = 2 (clipped: fsdp2_clip; one valid
    token a row on rank 0: data2_uneven) against the JAX trainer's
    `_update_fn` on the same mesh shape: the whole leaves, both Adam
    moments, the loss stats and the grad norm; the ranks agree."""
    jtrain, adams, jstats = _jax_update(tmp_path, name)
    groups = ("policy", "value") if UPDATES[name][1].get("algo") == "ppo" else ("policy",)
    assert len(adams) == len(groups)
    # PPO's moments include gradients that cancel (the tied embedding's,
    # the value head's): no tighter than 3e-5 of each leaf's largest
    # moment, as tests/test_torch_update_algos.py holds them on one device
    scale = 3e-5 if len(groups) == 2 else 0.0
    i = sorted(UPDATES).index(name)
    for got in updates:
        got = got[i]
        assert got["count"] == 2
        for g, adam in zip(groups, adams):
            pre = "" if g == "policy" else f"{g}_"
            for key, want, base, sc in (
                    (got[f"{pre}leaves"], _jax_layout(jtrain[g]), 1e-5, 0.0),
                    (got[f"{pre}mu"], _jax_layout(adam.mu[g]), 1e-6, scale),
                    (got[f"{pre}nu"], _jax_layout(adam.nu[g]), 1e-9, scale)):
                assert key.keys() == want.keys()
                for path, w in want.items():
                    atol = max(base, sc * float(np.abs(w).max()))
                    np.testing.assert_allclose(key[path], w, rtol=1e-4, atol=atol,
                                               err_msg=f"{g}/{path}")
        for st, jst in zip(got["stats"], jstats):
            for k in jst:
                np.testing.assert_allclose(st[k], float(jst[k]), rtol=1e-5, atol=1e-6,
                                           err_msg=k)
    for key in ("leaves", "value_leaves"):
        for path in updates[0][i].get(key, {}):
            np.testing.assert_array_equal(updates[0][i][key][path], updates[1][i][key][path])
    if name == "fsdp2_clip":
        assert updates[0][i]["stats"][0]["grad_norm"] > KNOBS.get("max_grad_norm", 0.05)
    if name == "ppo_fsdp2":
        assert {"vf_loss", "vf_clipfrac"} <= set(updates[0][i]["stats"][0])


def _jax_sparse(monkeypatch, tmp_path, port):
    """JAX's SparseGRPOTrainer on a 2-device data mesh over the scripted
    rollout, with the port's keep and permutation draws; each update
    bucket's minibatch, context and loss scale recorded."""
    from nanorlhf_tpu.trainer import sparse_grpo as jsg
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer

    jmodel, jparams = _sparse_setup()
    jtok = JaxToyTokenizer(S.V)
    jds, _ = S._dataset(jtok, ToyTokenizer(S.V))
    script = S._Script([SPARSE_ROLLOUT])
    monkeypatch.setattr(jsg, "generate", script.generate(jnp.asarray))
    monkeypatch.setattr(jsg, "forward_token_budget", lambda *a, **k: S.FORWARD_BUDGET)
    monkeypatch.setattr(jsg, "BACKWARD_BUDGET", S.BACKWARD_BUDGET)
    keeps, perms = list(port["keep"]), list(port["perm"])
    monkeypatch.setattr(jsg, "keep_one_of_n_indices", lambda key, b, n: jnp.asarray(keeps.pop(0)))
    real_perm = jax.random.permutation

    def perm(key, n, *a, **k):
        if perms and len(perms[0]) == n:
            return jnp.asarray(perms.pop(0))
        return real_perm(key, n, *a, **k)

    monkeypatch.setattr(jax.random, "permutation", perm)
    mbs = []
    grad_fn_of = jsg.SparseGRPOTrainer._bucket_grad_fn

    def bucket_grad_fn(self):
        fn = grad_fn_of(self)

        def wrapped(trainable, frozen, mb, ctx, scale):
            mbs.append(({k: np.asarray(v) for k, v in mb.items()}, ctx, float(scale)))
            return fn(trainable, frozen, mb, ctx, scale)

        return wrapped

    monkeypatch.setattr(jsg.SparseGRPOTrainer, "_bucket_grad_fn", bucket_grad_fn)
    jcfg = JaxRLConfig(algo=JaxAlgoName.GRPO, output_dir=str(tmp_path / "jax"),
                       mesh=JaxMeshConfig(*D2[:3]), **SPARSE_KNOBS)
    jtr = jsg.SparseGRPOTrainer(jcfg, jmodel, jtok, jparams, jds, script.reward,
                                mesh=jax_make_mesh(jcfg.mesh, devices=jax.devices()[:2]))
    try:
        jtr.train(1)
    finally:
        jtr.close()
    return jtr, mbs, S._rows(tmp_path / "jax" / "metrics.jsonl")


def test_sparse_update_at_data2_matches_jax(updates, monkeypatch, tmp_path):
    """The sparse trainer at data = 2 against JAX's SparseGRPOTrainer on a
    2-device mesh over the same scripted rollout: each update bucket's real
    rows (tokens and masks equal, logprobs and advantages within 1e-5) and
    loss scale, the port's extra rows all masked (a 1-row bucket padded to
    the 2 batch ranks), the metric row within 1e-5 and the trainable leaves
    within the sparse tests' 1e-5 / 1e-4; the ranks agree."""
    ranks = [r[len(UPDATES)] for r in updates]
    jtr, jmbs, jrows = _jax_sparse(monkeypatch, tmp_path, ranks[0])
    port = ranks[0]
    assert len(port["mb"]) == len(jmbs) >= 3
    padded = 0
    for (mb, ctx, scale), (jmb, jctx, jscale) in zip(port["mb"], jmbs):
        n = jmb["responses"].shape[0]
        assert ctx == jctx and scale == pytest.approx(jscale, abs=1e-7)
        assert mb["responses"].shape[0] % 2 == 0 and mb["responses"].shape[0] >= n
        assert mb["padding_mask"][n:].all()
        padded += mb["responses"].shape[0] > n
        for k in ("query_responses", "responses", "padding_mask"):
            np.testing.assert_array_equal(mb[k][:n], jmb[k], err_msg=k)
        for k in ("logprobs", "ref_logprobs", "advantages"):
            np.testing.assert_allclose(mb[k][:n], jmb[k], atol=1e-5, rtol=1e-5, err_msg=k)
    assert padded >= 1
    row = [r for r in port["rows"] if "episode" in r][-1]
    jrow = [r for r in jrows if "episode" in r][-1]
    keys = {"sparse/kept_frac", "loss/policy_avg_new", "policy/entropy_avg_new",
            "objective/kl_old", "lr"}
    assert keys <= set(row) & set(jrow)
    for k in keys:
        np.testing.assert_allclose(row[k], jrow[k], atol=1e-5, rtol=1e-5, err_msg=k)
    want = flatten(jax.tree.map(np.asarray, jtr.params))
    for path, g in port["leaves"].items():
        w = want[tuple(path.split("/")[1:])]
        w = np.swapaxes(w, -1, -2) if path.split("/")[-1] in ("a", "b", "kernel") else w
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4, err_msg=path)
    assert port["state"] == {k: jtr.state[k] for k in port["state"]}
    for path in port["leaves"]:
        np.testing.assert_array_equal(port["leaves"][path], ranks[1]["leaves"][path])
    assert ranks[1]["mb"] and all(np.array_equal(a[0]["query_responses"], b[0]["query_responses"])
                                  for a, b in zip(port["mb"], ranks[1]["mb"]))


def test_fsdp_ranks_hold_the_rules_share(updates):
    """At fsdp = 2 each rank holds, of the trainable leaves and of the
    Adam moments, the share `param_sharding_rules` gives from the shapes."""
    i = sorted(UPDATES).index("fsdp2")
    whole = {k: torch.as_tensor(v) for k, v in updates[0][i]["leaves"].items()}
    tree = {}
    for path, t in whole.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    total = sum(t.numel() for t in whole.values())
    for got in updates:
        assert got[i]["held"] == got[i]["held_mu"] == round(rule_share(tree, 2) * total)
        assert got[i]["held"] < total


# ---------------------------------------------------------------------------
# the trainers against the one-rank run of the same global batch
# ---------------------------------------------------------------------------

def _knobs(**over):
    return dict(dict(response_length=8, temperature=1.0, sample_n=2, kl_coef=0.05,
                     total_episodes=8, per_device_train_batch_size=2,
                     gradient_accumulation_steps=1, num_mini_batches=1, learning_rate=1e-3,
                     lora_r=4, lora_alpha=8, rollout_top_k=1, gradient_checkpointing=False,
                     train_dataset_name="synthetic:32"), **over)


TRAINERS = {
    "grpo_data2": dict(cfg=_knobs(), mesh=D2),
    "grpo_fsdp2": dict(cfg=_knobs(gradient_checkpointing=True), mesh=F2),
    "ppo_fsdp2": dict(algo="ppo", cfg=_knobs(algo=AlgoName.PPO, sample_n=1,
                                             total_episodes=4), mesh=F2),
    "sparse_data2": dict(sparse=True, cfg=_knobs(), mesh=D2),
    "compact_data2": dict(cfg=_knobs(rollout_compaction_segments=2), mesh=D2),
}
ALGOS = {
    "rloo": dict(cfg=_knobs(algo=AlgoName.RLOO), mesh=D2),
    "remax": dict(cfg=_knobs(algo=AlgoName.REMAX, sample_n=1), mesh=D2),
    "reinforce": dict(cfg=_knobs(algo=AlgoName.REINFORCE, sample_n=1,
                                 advantage_whiten=True), mesh=D2),
    "raft": dict(cfg=_knobs(algo=AlgoName.RAFT), mesh=D2),
}
CKPT = dict(cfg=_knobs(), mesh=F2, save=True)
# SIGTERM's flag set on rank 1 alone (rank 0 writes, so it polls later)
PREEMPT = dict(cfg=_knobs(), mesh=F2, trigger_rank=1, updates=2)
REFUSED = {"rollout_ahead": dict(cfg=_knobs(rollout_ahead=True), mesh=D2),
           "orchestrator": dict(cfg=_knobs(rollout_orchestrator=True), mesh=F2)}


def _one_rank(spec, out):
    """The spec on one rank, its global batch the same (per-device rows
    times the batch ranks). The sparse trainer's minibatch is
    `local_mini_batch_size` rows of the global kept batch (JAX
    sparse_grpo.py:639), a per-rank count: the one-rank run takes the
    mesh run's."""
    cfg = dict(spec["cfg"])
    batch = spec["mesh"][0] * spec["mesh"][1]
    local_mini = cfg["per_device_train_batch_size"] * cfg["gradient_accumulation_steps"]
    cfg["per_device_train_batch_size"] = cfg["per_device_train_batch_size"] * batch
    extra = {"local_mini": local_mini} if spec.get("sparse") else {}
    return M.train_case(0, 1, {**spec, **extra, "cfg": cfg, "mesh": None, "out": out})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainers")
    names = sorted(TRAINERS)
    ranks = R.shared_spawn(tmp_path_factory, "dp_trainers", M.run_cases, 2,
                           ([("train", dict(TRAINERS[n], out=str(root / n))) for n in names],),
                           timeout=TRAIN_JOIN_TIMEOUT)
    return {n: ([r[i] for r in ranks], _one_rank(TRAINERS[n], str(root / f"{n}_one")))
            for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The checkpoint written at fsdp = 2 and resumed at data = 2, the
    launcher's default mesh, the refusals: one group."""
    root = tmp_path_factory.mktemp("dp_meshes")
    ckpt = str(root / "ckpt_fsdp2")
    cases = [("train", dict(CKPT, out=ckpt)),
             ("train", dict(cfg=_knobs(), mesh=D2, out=ckpt, resume=True, updates=0)),
             ("launcher", dict(cfg=_knobs(), out=str(root / "launcher")))]
    cases += [("preempt", dict(PREEMPT, out=str(root / "preempt")))]
    cases += [("refusal", dict(REFUSED[n], out=str(root / n))) for n in sorted(REFUSED)]
    ranks = R.shared_spawn(tmp_path_factory, "dp_meshes", M.run_cases, 2, (cases,),
                           timeout=TRAIN_JOIN_TIMEOUT)
    # the spawning worker's directory (under xdist the ranks may have run
    # for another worker's session fixture)
    return {"ckpt": ([r[0] for r in ranks], [r[1] for r in ranks], ranks[0][0]["out"]),
            "launcher": [r[2] for r in ranks],
            "preempt": [r[3] for r in ranks],
            "refused": {n: [r[4 + j] for r in ranks] for j, n in enumerate(sorted(REFUSED))}}


@pytest.fixture(scope="module")
def algos(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_algos")
    names = sorted(ALGOS)
    ranks = R.shared_spawn(tmp_path_factory, "dp_algos", M.run_cases, 2,
                           ([("train", dict(ALGOS[n], out=str(root / n))) for n in names],),
                           timeout=TRAIN_JOIN_TIMEOUT)
    return {n: ([r[i] for r in ranks], _one_rank(ALGOS[n], str(root / f"{n}_one")))
            for i, n in enumerate(names)}


ROW_KEYS = ("loss/policy_avg_new", "policy/grad_norm_new", "policy/entropy_avg_new",
            "objective/kl_old", "eval_objective/scores_old", "loss/value_avg_new",
            "sparse/kept_frac")


def _assert_like_one_rank(ranks, one):
    for got in ranks:
        assert "error" not in got, got
        assert got["state"]["global_step"] == 1
        for a, b in zip(got["rollouts"], one["rollouts"]):
            np.testing.assert_array_equal(a, b)
        assert got["leaves"].keys() == one["leaves"].keys()
        for k, v in one["leaves"].items():
            np.testing.assert_allclose(got["leaves"][k], v, rtol=LEAF_RTOL, atol=LEAF_ATOL,
                                       err_msg=k)
        row, want = got["rows"][0], one["rows"][0]
        for key in ROW_KEYS:
            if key in want:
                assert abs(row[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), \
                    (key, row[key], want[key])
    assert ranks[0]["leaves"].keys() == ranks[1]["leaves"].keys()
    for k in ranks[0]["leaves"]:
        np.testing.assert_array_equal(ranks[0]["leaves"][k], ranks[1]["leaves"][k])


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_on_two_ranks_matches_one_rank(trained, name):
    """One update on two ranks against one rank on the same global batch:
    the rollouts equal (greedy rows), the trainable leaves within LEAF_RTOL
    / LEAF_ATOL, the loss, grad norm, entropy, KL and reward rows within
    1e-4; the ranks' leaves equal; the mesh rows present; under fsdp each
    rank holds a share of the trainable leaves."""
    ranks, one = trained[name]
    _assert_like_one_rank(ranks, one)
    spec = TRAINERS[name]
    row = ranks[0]["rows"][0]
    assert row["mesh/data"] == spec["mesh"][0] and row["mesh/fsdp"] == spec["mesh"][1]
    for got in ranks:
        if spec["mesh"][1] > 1:
            assert got["held"]["policy"] < one["held"]["policy"]
            assert got["held_mu"]["policy"] < one["held_mu"]["policy"]
            assert row["mesh/fsdp_all_gather_s"] > 0
        else:
            assert got["held"] == one["held"]


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_other_algorithms_at_data2_match_one_rank(algos, name):
    """RLOO, ReMax, REINFORCE and RAFT at data = 2 against one rank."""
    ranks, one = algos[name]
    _assert_like_one_rank(ranks, one)


def test_greedy_rollout_equals_jax_stream(trained):
    """The data = 2 and fsdp = 2 trainers' gathered rollout (each rank
    generated its block of prompts at top-k 1) equals the JAX package's
    greedy stream of the whole batch on the bridged weights."""
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    cfg = build_config()
    mcfg, params, tok = common.resolve_model("tiny-demo", seed=cfg.seed, device="cpu",
                                             dtype=torch.float32)
    jcfg = JaxModelConfig(**dataclasses.asdict(mcfg))
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    for name in ("grpo_data2", "grpo_fsdp2"):
        ranks, _ = trained[name]
        queries = ranks[0]["queries"][0]
        want = np.asarray(jax_generate(
            jparams, jcfg, jnp.asarray(queries), jnp.asarray(queries != tok.pad_token_id),
            jax.random.PRNGKey(0), JaxSamplingParams(greedy=True, n=2, max_tokens=8),
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id))
        for got in ranks:
            np.testing.assert_array_equal(got["rollouts"][0], want)


def test_fsdp2_checkpoint_resumes_at_data1_and_data2(meshes, tmp_path):
    """A checkpoint written at fsdp = 2 (whole leaves, rank 0's write)
    resumes at data = 2 (each rank the whole leaves) and at data = 1 with
    the leaves and the first moments equal bit for bit."""
    saved, resumed, out = meshes["ckpt"]
    one = M.train_case(0, 1, dict(cfg=_knobs(per_device_train_batch_size=4), mesh=None,
                                  out=out, resume=True, updates=0))
    want = saved[0]
    for got in resumed + [one]:
        assert got["state"]["global_step"] == 1
        for key in ("leaves", "mu"):
            assert got[key].keys() == want[key].keys()
            for k, v in want[key].items():
                np.testing.assert_array_equal(got[key][k], v, err_msg=k)
    assert saved[1]["leaves"].keys() == want["leaves"].keys()


def test_build_trainer_default_mesh_on_a_world_of_two(meshes):
    """`common.build_trainer` under a spawned world of 2 with the default
    `MeshConfig()` on device="cpu": data = 2 (JAX's `data=-1`), the global
    batch doubled, one update."""
    for got in meshes["launcher"]:
        assert got["axes"] == (2, 1, 1, 1)
        assert got["state"]["global_step"] == 1
        assert got["batch_size"] == 2 * _knobs()["per_device_train_batch_size"]


def test_sigterm_on_one_fsdp_rank_preempts_every_rank(meshes):
    """SIGTERM's flag set on one rank of fsdp = 2: the ranks agree on it at
    the update boundary, so both stop after the first update, raise
    `Preempted` and commit one emergency checkpoint (the save gathers the
    shards, a collective both ranks must enter)."""
    for got in meshes["preempt"]:
        assert got["preempted"] is not None and "emergency checkpoint" in got["preempted"]
        assert got["step"] == 1
    # rank 0 writes, and lists after its writer has finished
    assert meshes["preempt"][0]["checkpoints"] == ["checkpoint-1"]


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_paths_waiting_for_a14c_raise(meshes, name):
    """`rollout_ahead` on batch ranks and the orchestrator on any mesh
    raise NotImplementedError naming A14c, on every rank."""
    for msg in meshes["refused"][name]:
        assert msg is not None and "A14c" in msg
