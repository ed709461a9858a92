"""The rank functions of the port's data / fsdp tests, run on spawned gloo
ranks (`parallel.distributed.spawn` through `_torch_sp_ranks.shared_spawn`).
This module imports neither `jax` nor the JAX package: the spawned ranks
run the port alone; the JAX side of each test runs in the test's own
process. Every rank runs the same cases in the same order, so their
collectives pair up; each case returns host data (numpy, floats)."""

import os
import zlib

import numpy as np
import torch

from _torch_sp_ranks import _np


def _make_mesh(axes):
    from nanorlhf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.set_num_threads(1)
    return make_mesh(MeshConfig(*axes))


def position_reward(texts, eos_token):
    """crc32 of the text plus 0.3 for every odd row of the list: rows that
    share their text (a greedy group) still differ, and a rank grading its
    block of whole groups gives each row the score the whole batch would."""
    return np.asarray([(zlib.crc32(s.encode()) % 17) / 17.0 + 0.3 * (i % 2)
                       for i, s in enumerate(texts)], np.float32)


def sparse_reward(texts, responses_ids, tokenizer):
    return position_reward(texts, tokenizer.eos_token)


# ---------------------------------------------------------------------------
# the mesh and its rules
# ---------------------------------------------------------------------------

def mesh_case(rank, world, arg):
    """Coordinates, batch blocks and `shard_params` slices of a mesh."""
    from nanorlhf_tpu_torch.parallel.mesh import batch_sharding, shard_params

    mesh = _make_mesh(arg["axes"])
    params = {k: torch.as_tensor(v) for k, v in arg.get("leaves", {}).items()}
    shards = shard_params(params, mesh) if params else {}
    sent = torch.full((3,), float(mesh.batch_rank))
    mesh.batch_transport.broadcast_(sent, 0)
    return {"coords": mesh.coords, "broadcast": sent.numpy(), "rank": mesh.rank, "batch_rank": mesh.batch_rank,
            "block": (batch_sharding(mesh, arg["rows"]).start,
                      batch_sharding(mesh, arg["rows"]).stop),
            "shards": {k: v.numpy() for k, v in shards.items()}}


def gather_case(rank, world, arg):
    """`gather_shard` over the fsdp group: forward and the backward of
    sum(full · w) for this rank's shard of `full` along `dim`."""
    from nanorlhf_tpu_torch.parallel.fsdp import gather_shard

    mesh = _make_mesh(arg["axes"])
    full, dim = torch.as_tensor(arg["full"]), arg["dim"]
    n = full.shape[dim] // mesh.fsdp
    shard = full.narrow(dim, mesh.fsdp_rank * n, n).clone().requires_grad_(True)
    out = gather_shard(shard, dim, mesh.fsdp_transport)
    (out * torch.as_tensor(arg["w"][rank])).sum().backward()
    return {"out": _np(out), "grad": _np(shard.grad)}


def _tiny_tree(arg):
    from nanorlhf_tpu_torch.bridge import params_from_numpy
    from nanorlhf_tpu_torch.core.config import ModelConfig

    return (ModelConfig(**arg["cfg"]), params_from_numpy(arg["tree"], "cpu", torch.float32))


def fsdp_forward_case(rank, world, arg):
    """The fsdp forward of `shard_params` (this rank's block of the rows
    through the layer hook; fsdp is a batch axis too) and the whole
    gradients of sum(logits · w) over the global rows w.r.t. the LoRA
    leaves and the embedding, gathered from the shards; the logits of
    every row (gathered)."""
    from nanorlhf_tpu_torch.core.model import padded_forward_logits
    from nanorlhf_tpu_torch.parallel.fsdp import forward_view, full_tree, reduce_grads
    from nanorlhf_tpu_torch.parallel.mesh import batch_sharding, own_rows, shard_params
    from nanorlhf_tpu_torch.trainer.optim import flatten

    mesh = _make_mesh(arg["axes"])
    mcfg, params = _tiny_tree(arg)
    mcfg = mcfg.__class__(**{**arg["cfg"], "remat_policy": arg["remat_policy"]})
    params = shard_params(params, mesh)
    train = {p: t for p, t in flatten(params).items() if p[0] in ("lora", "embed_tokens")}
    for t in train.values():
        t.requires_grad_(True)
    view, hook = forward_view(params, mesh)
    rows = batch_sharding(mesh, arg["qr"].shape[0])
    logits = padded_forward_logits(view, mcfg, torch.as_tensor(arg["qr"][rows]).long(),
                                   arg["pad"], lora_scale=arg["lora_scale"],
                                   remat=arg["remat"], layer_transform=hook)
    logits = own_rows(mesh, logits)
    (logits * torch.as_tensor(arg["w"])).sum().backward()
    # the rest of the sum: replicated leaves over the batch line
    reduce_grads(mesh, list(train), [t.grad for t in train.values()])
    grads = {}
    for p, t in train.items():
        grads["/".join(p)] = _np(full_tree({p[-1]: t.grad}, mesh, p[:-1])[p[-1]])
    return {"logits": _np(logits), "grads": grads,
            "shard_shapes": {"/".join(p): tuple(t.shape) for p, t in train.items()}}


def sp_fsdp_case(rank, world, arg):
    """`sp_fsdp_forward_logits` at (1, 2, 1, 2): this rank's logits shard
    and `sp_score_logprobs(fsdp_axis="fsdp")`."""
    from nanorlhf_tpu_torch.core.model import padding_inputs
    from nanorlhf_tpu_torch.parallel.mesh import shard_params
    from nanorlhf_tpu_torch.parallel.sp import sp_fsdp_forward_logits, sp_score_logprobs

    mesh = _make_mesh(arg["axes"])
    mcfg, params = _tiny_tree(arg)
    params = shard_params(params, mesh)
    qr = torch.as_tensor(arg["qr"]).long()
    ids, mask, pos = padding_inputs(qr, arg["pad"])
    with torch.no_grad():
        logits = sp_fsdp_forward_logits(params, mcfg, ids, mask, pos, mesh,
                                        lora_scale=arg["lora_scale"])
        lp = sp_score_logprobs(params, mcfg, qr, arg["pad"], arg["temperature"], mesh,
                               lora_scale=arg["lora_scale"], fsdp_axis="fsdp")
    return {"logits": _np(logits), "logprobs": _np(lp), "sp_rank": mesh.sp_rank}


def update_case(rank, world, arg):
    """Two `update_minibatch` steps of the port on a mesh, the params
    (`tree`, the JAX layout in numpy) sharded, and for PPO the value tree
    (`value_tree`) too: the whole trainable leaves and Adam moments of each
    group ("policy", "value"), the stats after each step, the per-rank
    element counts of the policy's trainable shards and moments."""
    from nanorlhf_tpu_torch.bridge import params_from_numpy
    from nanorlhf_tpu_torch.core.lora import LoraConfig, trainable_mask, value_trainable_mask
    from nanorlhf_tpu_torch.parallel.fsdp import full_tree
    from nanorlhf_tpu_torch.parallel.mesh import shard_params
    from nanorlhf_tpu_torch.trainer.config import RLConfig
    from nanorlhf_tpu_torch.trainer.optim import build_optimizer, flatten
    from nanorlhf_tpu_torch.trainer.trainer import _trainable_leaves
    from nanorlhf_tpu_torch.trainer.update import update_minibatch

    mesh = _make_mesh(arg["axes"])
    mcfg, params = _tiny_tree(arg)
    params = shard_params(params, mesh)
    # the batch hierarchy (and so the schedule's length) of the mesh's world
    cfg = RLConfig(**arg["knobs"]).finalize_world(mesh.batch)
    lcfg = LoraConfig(**arg["lora"])
    groups = {"policy": _trainable_leaves(params, trainable_mask(params, lcfg))}
    value = None
    if arg.get("value_tree") is not None:
        value = shard_params(params_from_numpy(arg["value_tree"], "cpu", torch.float32), mesh)
        groups["value"] = _trainable_leaves(value, value_trainable_mask(value, lcfg))
    for t in flatten(groups).values():
        t.requires_grad_(True)
    opt = build_optimizer(cfg, mesh)
    state = opt.init(groups)
    stats = []
    for mb in arg["mbs"]:
        state, st = update_minibatch(params, groups, opt, state,
                                     {k: torch.as_tensor(v) for k, v in mb.items()},
                                     mcfg, cfg, arg["ctx"], arg["pad"], arg["lora_scale"],
                                     value=value, value_lora_scale=arg["lora_scale"],
                                     mesh=mesh)
        stats.append(st)

    def whole(tree, group):
        return {"/".join(p): _np(t) for p, t in
                flatten(full_tree(tree, mesh, (group,))).items()}

    out = {"stats": stats, "count": state["policy"].count,
           "held": sum(t.numel() for t in flatten(groups["policy"]).values()),
           "held_mu": sum(t.numel() for t in flatten(state["policy"].mu).values())}
    for g, train in groups.items():
        pre = "" if g == "policy" else f"{g}_"
        out.update({f"{pre}leaves": whole(train, g), f"{pre}mu": whole(state[g].mu, g),
                    f"{pre}nu": whole(state[g].nu, g)})
    return out


def sparse_script_case(rank, world, arg):
    """The sparse GRPO trainer on a mesh over one scripted rollout (`tree`,
    `cfg`, `vocab`, `knobs`, `axes`, `out`; `responses` [prompts·n, R] and
    `rewards` of the global batch; the token `budgets`): each rank's
    `generate` returns its block of the scripted rows, its reward grades
    its own rows. Returns the keep and epoch-permutation draws, every
    update bucket's device minibatch, context and loss scale, the update
    log, the metric rows (rank 0), the state and the whole trainable
    leaves."""
    import json

    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.entrypoints import grpo_r1
    from nanorlhf_tpu_torch.parallel.mesh import MeshConfig
    from nanorlhf_tpu_torch.trainer import rollout as trollout
    from nanorlhf_tpu_torch.trainer import sparse_grpo as tsg
    from nanorlhf_tpu_torch.trainer.config import RLConfig
    from nanorlhf_tpu_torch.trainer.optim import flatten

    mcfg, params = _tiny_tree(arg)
    tok = ToyTokenizer(arg["vocab"])
    ds = grpo_r1.build_prompt_dataset(grpo_r1.synthetic_math_corpus(64), tok,
                                      max_prompt_len=16)
    cfg = RLConfig(algo="grpo", output_dir=arg["out"], mesh=MeshConfig(*arg["axes"]),
                   **arg["knobs"])
    resp, n = arg["responses"], arg["knobs"]["sample_n"]
    score = {tuple(r.tolist()): s for r, s in zip(resp, arg["rewards"])}
    rec = {"keep": [], "perm": [], "mb": []}
    real = {"generate": trollout.generate, "budget": tsg.forward_token_budget,
            "backward": tsg.BACKWARD_BUDGET, "keep": tsg.keep_one_of_n_indices,
            "perm": tsg.epoch_permutation, "grads": tsg.SparseGRPOTrainer.bucket_grads}
    block = {}

    def generate(params, config, ids, *a, **k):
        lo = block["rank"] * ids.shape[0]  # this rank's block of the prompts
        return torch.as_tensor(resp[lo * n:(lo + ids.shape[0]) * n])

    def reward(texts, ids, tokenizer):
        return np.asarray([score[tuple(np.asarray(r).tolist())] for r in ids], np.float32)

    def keep(gen, b, k):
        out = real["keep"](gen, b, k)
        rec["keep"].append(out.numpy().copy())
        return out

    def perm(*a):
        out = real["perm"](*a)
        rec["perm"].append(out.copy())
        return out

    def bucket_grads(self, mb, ctx, scale):
        rec["mb"].append(({k: v.numpy().copy() for k, v in mb.items()}, ctx, scale))
        return real["grads"](self, mb, ctx, scale)

    trollout.generate = generate
    tsg.forward_token_budget = lambda *a, **k: arg["budgets"][0]
    tsg.BACKWARD_BUDGET = arg["budgets"][1]
    tsg.keep_one_of_n_indices, tsg.epoch_permutation = keep, perm
    tsg.SparseGRPOTrainer.bucket_grads = bucket_grads
    try:
        tr = tsg.SparseGRPOTrainer(cfg, mcfg, tok, params, ds, reward)
        block["rank"] = tr.mesh.batch_rank
        try:
            tr.train(1)
            groups = tr._groups()
            leaves = flatten({g: tr._whole(t, g) for g, t in groups.items()})
        finally:
            tr.close()
    finally:
        trollout.generate = real["generate"]
        tsg.forward_token_budget, tsg.BACKWARD_BUDGET = real["budget"], real["backward"]
        tsg.keep_one_of_n_indices, tsg.epoch_permutation = real["keep"], real["perm"]
        tsg.SparseGRPOTrainer.bucket_grads = real["grads"]
    path = os.path.join(arg["out"], "metrics.jsonl")
    rows = ([json.loads(line) for line in open(path)]
            if rank == 0 and os.path.exists(path) else [])
    return {**rec, "update_log": tr.update_log, "rows": rows, "state": dict(tr.state),
            "leaves": {"/".join(p): _np(t) for p, t in leaves.items()}}


def compaction_case(rank, world, arg):
    """Greedy compacting decode with `batch_sharding=mesh`: the gathered
    rows (every rank the whole batch)."""
    from nanorlhf_tpu_torch.sampler.compaction import generate_tokens_compact

    mesh = _make_mesh(arg["axes"])
    mcfg, params = _tiny_tree(arg)
    ids = torch.as_tensor(arg["ids"]).long()
    out = generate_tokens_compact(
        params, mcfg, ids, ids != arg["pad"], torch.Generator(), max_tokens=arg["max_tokens"],
        eos_token_id=arg["eos"], pad_token_id=arg["pad"], segments=arg["segments"],
        greedy=True, lora_scale=arg["lora_scale"], batch_sharding=mesh,
        stats_out=(stats := []))
    return {"out": out.numpy(), "menu": stats[0]["menu"]}


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def build_cfg(spec: dict):
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config
    from nanorlhf_tpu_torch.entrypoints.ppo import build_ppo_config
    from nanorlhf_tpu_torch.parallel.mesh import MeshConfig

    cfg = build_ppo_config() if spec.get("algo") == "ppo" else build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = spec["out"]
    cfg.save_steps, cfg.load_best_model_at_end = 0, False
    for k, v in spec["cfg"].items():
        setattr(cfg, k, v)
    cfg.mesh = MeshConfig(*spec["mesh"]) if spec.get("mesh") else MeshConfig()
    return cfg


def _trainer(spec: dict):
    """(cfg, trainer) of `spec` over the tiny demo model in f32."""
    from nanorlhf_tpu_torch.entrypoints import common, grpo_r1
    from nanorlhf_tpu_torch.entrypoints.ppo import make_value_params
    from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer
    from nanorlhf_tpu_torch.trainer.trainer import RLTrainer

    torch.set_num_threads(1)
    cfg = build_cfg(spec)
    mcfg, params, tok = common.resolve_model("tiny-demo", seed=cfg.seed, device="cpu",
                                             attention_impl=cfg.attention_impl,
                                             dtype=torch.float32)
    if spec.get("sparse"):
        ds = grpo_r1.build_prompt_dataset(grpo_r1.synthetic_math_corpus(32), tok,
                                          max_prompt_len=16)
        tr = SparseGRPOTrainer(cfg, mcfg, tok, params, ds, sparse_reward)
    else:
        value = make_value_params(mcfg, params) if spec.get("algo") == "ppo" else None
        tr = RLTrainer(cfg, mcfg, tok, params, common.resolve_dataset(cfg, tok),
                       position_reward, value_params=value)
    if spec.get("local_mini"):
        tr.cfg.local_mini_batch_size = spec["local_mini"]
    return cfg, tr


def train_case(rank, world, spec):
    """One trainer from `spec` (`cfg` knobs, `mesh` axes, `algo`,
    `sparse`, `updates`, `out`, `save`, `resume`, `local_mini`: the
    minibatch rows set after the config's finalize) over the tiny demo model
    in f32, trained; returns its state, the metric rows, the global
    rollouts it trained on, its whole trainable leaves and moments, and
    the element counts this rank holds."""
    from nanorlhf_tpu_torch.trainer.optim import flatten

    cfg, tr = _trainer(spec)
    rows, rollouts, queries = [], [], []
    try:
        real_log, real_body = tr.logger.log, tr._rollout_body

        def log(step, episode, metrics):
            rows.append(dict(metrics))
            real_log(step, episode, metrics)

        def body(*a, **k):
            payload = real_body(*a, **k)
            rollouts.append(payload["responses"])
            queries.append(payload["queries"])
            return payload

        tr.logger.log, tr._rollout_body = log, body
        if spec.get("resume"):
            tr.resume_from_checkpoint()
        state = tr.train(num_updates=spec.get("updates", 1))
        if spec.get("save"):
            tr.save_checkpoint()
            tr.ckpt.wait()
        groups = tr._groups()
        whole = {g: tr._whole(t, g) for g, t in groups.items()}
        mu = {g: tr._whole(tr.opt_state[g].mu, g) for g in groups}
        return {"state": dict(state), "rows": rows, "rollouts": rollouts, "queries": queries,
                "out": cfg.output_dir,
                "leaves": {"/".join(p): _np(t) for p, t in flatten(whole).items()},
                "mu": {"/".join(p): _np(t) for p, t in flatten(mu).items()},
                "held": {g: sum(t.numel() for t in flatten(t).values())
                         for g, t in groups.items()},
                "held_mu": {g: sum(t.numel() for t in flatten(tr.opt_state[g].mu).values())
                            for g in groups},
                "params_held": sum(t.numel() for t in flatten(tr.params).values()),
                "last_stats": tr.last_stats}
    finally:
        tr.close()


def launcher_case(rank, world, spec):
    """`entrypoints/common.build_trainer` under the spawned world with the
    launcher's default `MeshConfig()` on device="cpu": the resolved mesh
    and one update's state."""
    from nanorlhf_tpu_torch.entrypoints import common

    torch.set_num_threads(1)
    cfg = build_cfg(spec)
    tr = common.build_trainer(cfg, device="cpu")
    try:
        tr.reward_func = position_reward
        state = tr.train(num_updates=1)
        return {"axes": (tr.mesh.data, tr.mesh.fsdp, tr.mesh.tensor, tr.mesh.sp),
                "state": dict(state), "batch_size": tr.cfg.batch_size}
    finally:
        tr.close()


def preempt_case(rank, world, spec):
    """A trainer whose SIGTERM flag is set on rank `trigger_rank` only,
    before `updates` updates: the step each rank stopped at, the message of
    the `Preempted` it raised (None if none) and the checkpoints written."""
    from nanorlhf_tpu_torch.resilience.preemption import Preempted

    cfg, tr = _trainer(spec)
    try:
        if rank == spec["trigger_rank"]:
            tr._preemption.trigger()
        msg = None
        try:
            tr.train(num_updates=spec["updates"])
        except Preempted as e:
            msg = str(e)
        return {"preempted": msg, "step": tr.state["global_step"],
                "checkpoints": sorted(d for d in os.listdir(cfg.output_dir)
                                      if d.startswith("checkpoint-"))}
    finally:
        tr.close()


def refusal_case(rank, world, spec):
    """The message of the NotImplementedError a trainer on this mesh
    raises (None if it builds)."""
    try:
        train_case(rank, world, spec)
    except NotImplementedError as e:
        return str(e)
    return None


_CASES = {"mesh": mesh_case, "gather": gather_case, "fsdp_forward": fsdp_forward_case,
          "sp_fsdp": sp_fsdp_case, "update": update_case, "sparse_script": sparse_script_case,
          "compaction": compaction_case,
          "train": train_case, "launcher": launcher_case, "preempt": preempt_case,
          "refusal": refusal_case}


def run_cases(rank: int, world: int, cases: list) -> list:
    """Each (kind, argument) case of one spawned group, in order."""
    torch.set_num_threads(1)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return [_CASES[kind](rank, world, arg) for kind, arg in cases]
