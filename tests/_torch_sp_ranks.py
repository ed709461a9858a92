"""The rank functions of the port's sequence-parallel tests, run on spawned
gloo ranks (`parallel.distributed.spawn`, a `FileStore` under a temporary
directory, a 120 s join). This module imports neither `jax` nor the JAX
package: the spawned ranks run the port alone; the JAX side of each test
runs in the test's own process.

`shared_spawn` runs a group once per test session and shares its pickled
result with every xdist worker (a file lock in the session's temporary
root), so the parametrised cases of one group each count as a test while
the group is spawned once."""

import fcntl
import os
import pickle
import zlib

import numpy as np
import torch

from nanorlhf_tpu_torch.parallel.distributed import spawn

JOIN_TIMEOUT = 120.0


def shared_spawn(tmp_path_factory, key: str, fn, world: int, args: tuple = (),
                 timeout: float = JOIN_TIMEOUT):
    """`spawn(fn, world, args, timeout)`, run once per session: under xdist
    the session's temporary root is shared by the workers, and the first to
    take the lock spawns the group and leaves its result for the others."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    result, lock = root / f"sp_{key}.pkl", root / f"sp_{key}.lock"
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if result.exists():
                return pickle.loads(result.read_bytes())
            store = root / f"sp_{key}_store"
            store.mkdir(exist_ok=True)
            out = spawn(fn, world, args, timeout=timeout, store_dir=str(store))
            result.write_bytes(pickle.dumps(out))
            return out
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _mesh(world: int):
    from nanorlhf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.set_num_threads(1)
    return make_mesh(MeshConfig(1, 1, 1, world))


def _np(t):
    return None if t is None else t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the rings
# ---------------------------------------------------------------------------

def ring_case(rank: int, world: int, case: dict) -> dict:
    """A case ({q, k, v, valid, w} numpy global arrays, causal) through both
    rings on this rank's shard: forward, then the backward of sum(out · w).
    Returns {ring: (out, dq, dk, dv)} of the shard."""
    from nanorlhf_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_flash

    mesh = _mesh(world)
    t = case["q"].shape[2] // world
    sl = slice(rank * t, (rank + 1) * t)
    got = {}
    for name, ring in (("einsum", ring_attention), ("flash", ring_attention_flash)):
        q, k, v = (torch.tensor(case[n][:, :, sl], requires_grad=True)
                   for n in ("q", "k", "v"))
        o = ring(q, k, v, torch.as_tensor(case["valid"][:, sl]), mesh.transport,
                 causal=case["causal"])
        (o * torch.as_tensor(case["w"][:, :, sl])).sum().backward()
        got[name] = (_np(o), _np(q.grad), _np(k.grad), _np(v.grad))
    return got


# ---------------------------------------------------------------------------
# SP scoring
# ---------------------------------------------------------------------------

def score_cases(rank: int, world: int, tree: dict, value_tree: dict, cfg: dict,
                qr: np.ndarray, pad: int, temperature: float, ctx: int,
                lora_scale: float) -> dict:
    """`sp_score_logprobs` (with the entropy from ctx − 1) and
    `sp_score_values` of the global rows `qr`, the port's params from the
    numpy trees."""
    from nanorlhf_tpu_torch.bridge import params_from_numpy
    from nanorlhf_tpu_torch.core.config import ModelConfig
    from nanorlhf_tpu_torch.parallel.sp import sp_score_logprobs, sp_score_values

    mesh = _mesh(world)
    mcfg = ModelConfig(**cfg)
    params = params_from_numpy(tree, "cpu", torch.float32)
    value = params_from_numpy(value_tree, "cpu", torch.float32)
    rows = torch.as_tensor(qr).long()
    with torch.no_grad():
        lp, ent = sp_score_logprobs(params, mcfg, rows, pad, temperature, mesh,
                                    lora_scale=lora_scale, with_entropy=True,
                                    entropy_from_position=ctx - 1)
        vals = sp_score_values(value, mcfg, rows, pad, mesh)
    return {"logprobs": _np(lp), "entropy": float(ent), "values": _np(vals)}


# ---------------------------------------------------------------------------
# the update's gradients: one loss, not N
# ---------------------------------------------------------------------------

def microbatch_grads(spec: dict, mesh=None) -> dict:
    """The LoRA gradients of one GRPO microbatch loss (`tiny-demo` params in
    f32 from their seed) and the loss; under `mesh` summed over the group
    as the update sums them."""
    from nanorlhf_tpu_torch.entrypoints import common
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.update import microbatch_loss

    cfg = build_config()
    for k, v in spec["cfg"].items():
        setattr(cfg, k, v)
    mcfg, params, _ = common.resolve_model("tiny-demo", seed=cfg.seed, device="cpu",
                                           dtype=torch.float32)
    from nanorlhf_tpu_torch.trainer.trainer import build_policy

    policy, _, _, lora_scale = build_policy(cfg, mcfg, params)
    lora = flatten(policy["lora"])
    for t in lora.values():
        t.requires_grad_(True)
    mb = {k: torch.as_tensor(v) for k, v in spec["mb"].items()}
    loss, aux = microbatch_loss(policy, mcfg, cfg, mb, spec["ctx"], spec["pad"],
                                lora_scale, remat=spec.get("remat", False), mesh=mesh)
    grads = torch.autograd.grad(loss, list(lora.values()))
    grads = [g.clone() for g in grads]
    if mesh is not None:
        mesh.transport.all_reduce_sum_(grads)
    return {"loss": float(loss), "entropy": float(aux["entropy"]),
            "grads": {"/".join(p): _np(g) for p, g in zip(lora, grads)}}


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def det_reward(texts, eos_token):
    """A deterministic reward with variance inside the groups (crc32, not
    `hash`: PYTHONHASHSEED must not leak into an equivalence check)."""
    return np.asarray([(zlib.crc32(s.encode()) % 17) / 17.0 for s in texts], np.float32)


def sparse_reward(texts, responses_ids, tokenizer):
    return det_reward(texts, tokenizer.eos_token)


def train_once(spec: dict, world: int = 1) -> dict:
    """One trainer built from `spec` (`cfg` knobs, `algo`, `sparse`,
    `updates`, `out`) over the tiny demo model in f32, trained; returns its
    state, the metric rows this rank saw and its trainable leaves, or the
    message of a ValueError it raised."""
    from nanorlhf_tpu_torch.entrypoints import common, grpo_r1
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config
    from nanorlhf_tpu_torch.entrypoints.ppo import build_ppo_config, make_value_params
    from nanorlhf_tpu_torch.parallel.mesh import MeshConfig
    from nanorlhf_tpu_torch.trainer.optim import flatten
    from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer
    from nanorlhf_tpu_torch.trainer.trainer import RLTrainer

    cfg = build_ppo_config() if spec.get("algo") == "ppo" else build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = os.path.join(spec["out"], f"sp{world}")
    cfg.save_steps, cfg.load_best_model_at_end = 0, False
    for k, v in spec["cfg"].items():
        setattr(cfg, k, v)
    cfg.mesh = MeshConfig(1, 1, 1, world)
    mcfg, params, tok = common.resolve_model("tiny-demo", seed=cfg.seed, device="cpu",
                                             attention_impl=cfg.attention_impl,
                                             dtype=torch.float32)
    rows: list = []
    if spec.get("sparse"):
        ds = grpo_r1.build_prompt_dataset(grpo_r1.synthetic_math_corpus(32), tok,
                                          max_prompt_len=16)
        tr = SparseGRPOTrainer(cfg, mcfg, tok, params, ds, sparse_reward)
    else:
        value = make_value_params(mcfg, params) if spec.get("algo") == "ppo" else None
        tr = RLTrainer(cfg, mcfg, tok, params, common.resolve_dataset(cfg, tok),
                       det_reward, value_params=value)
    try:
        real_log = tr.logger.log

        def log(step, episode, metrics):
            rows.append(dict(metrics))
            real_log(step, episode, metrics)

        tr.logger.log = log
        try:
            state = tr.train(num_updates=spec.get("updates", 1))
        except ValueError as e:
            return {"error": str(e)}
        return {"state": dict(state), "rows": rows,
                "leaves": {"/".join(p): _np(t) for p, t in flatten(tr._groups()).items()}}
    finally:
        tr.close()


_CASES = {"ring": ring_case,
          "score": lambda rank, world, a: score_cases(rank, world, *a),
          "grad": lambda rank, world, a: microbatch_grads(a, _mesh(world)),
          "train": lambda rank, world, a: train_once(a, world)}


def run_cases(rank: int, world: int, cases: list) -> list:
    """Each (kind, argument) case of one spawned group, in order (every rank
    runs the same cases, so their collectives pair up)."""
    torch.set_num_threads(1)
    return [_CASES[kind](rank, world, arg) for kind, arg in cases]


def fail_on_rank_1(rank: int, world: int):
    """Rank 1 raises while rank 0 waits in a collective it will never
    complete: `spawn` must bring the whole group down."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 planted failure")
    dist.barrier()
    return rank
