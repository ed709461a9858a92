"""RLTrainer — the port of `nanorlhf_tpu/trainer/trainer.py`'s `RLTrainer`
on its main path: the monolithic, synchronous GRPO branch of `train`
(:1676-2671) on one device.

One update, as in JAX:
    rollout (prefill + sampled decode) → host reward → GRPO group z-score
    → keep 1 of N → policy + ref scoring of the kept rows → GRPO batch
    → PPO epochs × minibatches of `update_minibatch` (microbatch loss,
    backward, AdamW on the trainable leaves) → `_old`/`_new` metrics
    → checkpoint every `save_steps`.

`__init__` builds what JAX's does for this path: the policy with a fresh
LoRA subtree, the frozen ref, the trainable-leaf partition (the LoRA
adapters and, as PEFT's `modules_to_save`, the embeddings — JAX's
`LoraConfig` defaults), the optimizer, the checkpoint manager and the
metrics logger. The random draws JAX takes by splitting its trainer key
(keep-1-of-N, the per-epoch permutation, the LoRA init) come from
generators seeded from (seed, stream, index): same distributions, other
bits.

Unported knobs raise (`check_trainer_supported`): the async orchestrator
and fleet, rollout_ahead, environments, telemetry, lineage, the status
port, fault injection, profiling windows, HF export and the other
algorithms. The sentinel, the health plane and the latency histograms are
on by default in JAX but only observe a healthy run; the port does not run
them yet (ROADMAP).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.core.lora import LoraConfig, init_lora_params, trainable_mask
from nanorlhf_tpu_torch.trainer.bucketing import shape_menu
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
from nanorlhf_tpu_torch.trainer.config import RLConfig
from nanorlhf_tpu_torch.trainer.metrics import MetricsLogger
from nanorlhf_tpu_torch.trainer.optim import AdamWState, build_optimizer, flatten
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM,
    PERM_STREAM,
    assemble_grpo_batch,
    check_supported,
    rollout_and_score,
    rollout_generator,
    stream_generator,
)
from nanorlhf_tpu_torch.trainer.update import check_update_supported, update_minibatch

# seed stream of the LoRA init (the JAX trainer splits its key for it)
LORA_STREAM = 0x10AA


def check_trainer_supported(cfg: RLConfig) -> None:
    """`check_supported` (the rollout's knobs), the update's, and the
    trainer's own."""
    check_supported(cfg)
    check_update_supported(cfg, {})
    unported = {
        "telemetry": cfg.telemetry,
        "lineage": cfg.lineage,
        "status_port": cfg.status_port != 0,
        "fault_spec": bool(cfg.fault_spec),
        "profile_at_step": cfg.profile_at_step is not None,
        "health_arm_sentinel": cfg.health_arm_sentinel,
        "export_hf_dir": bool(cfg.export_hf_dir),
        "env_name": bool(cfg.env_name),
        "rollout_inflight_swaps": cfg.rollout_inflight_swaps,
    }
    on = [what for what, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"not ported to nanorlhf_tpu_torch yet: {', '.join(on)}")


def _trainable_leaves(tree: dict, mask: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _trainable_leaves(v, mask[k])
            if sub:
                out[k] = sub
        elif mask[k]:
            out[k] = v
    return out


def build_policy(cfg: RLConfig, mcfg, params: dict):
    """(policy, ref, lora_cfg, lora_scale): the policy with a LoRA subtree
    (a fresh one from (seed, LORA_STREAM) unless `params` carries one), and
    the frozen ref: the base tree minus LoRA, with a COPY of every leaf the
    optimizer will step (the embeddings under LoRA, everything without it)
    and the frozen leaves shared — those never change."""
    lora_cfg = LoraConfig(r=cfg.lora_r, alpha=cfg.lora_alpha) if cfg.use_lora else None
    policy = dict(params)
    if lora_cfg is not None and "lora" not in policy:
        device = params["embed_tokens"].device
        gen = stream_generator(cfg.seed, LORA_STREAM, device=device)
        policy["lora"] = init_lora_params(mcfg, lora_cfg, gen,
                                          dtype=params["embed_tokens"].dtype,
                                          device=device)
    mask = trainable_mask(policy, lora_cfg)

    def copy_trained(tree, m):
        return {k: copy_trained(v, m[k]) if isinstance(v, dict)
                else (v.detach().clone() if m[k] else v)
                for k, v in tree.items()}

    ref = copy_trained({k: v for k, v in policy.items() if k != "lora"}, mask)
    return policy, ref, lora_cfg, (lora_cfg.scale if lora_cfg else 1.0)


class RLTrainer:
    """The GRPO trainer on one device. Args mirror the JAX trainer's:
    config, model config, tokenizer, base params (the port's layout, on
    the device to train on), a dataset with `loader(batch, seed)` and
    `input_ids`, and `reward_func(list[str], eos_token) -> scores`."""

    def __init__(self, config: RLConfig, model_config, tokenizer, params: dict,
                 dataset, reward_func):
        check_trainer_supported(config)
        self.cfg, self.mcfg = config, model_config
        self.tokenizer, self.reward_func, self.dataset = tokenizer, reward_func, dataset
        self.device = params["embed_tokens"].device
        if config.total_episodes is None:
            config.total_episodes = int(config.num_train_epochs * len(dataset))
        config.finalize_world(1)
        if config.remat_policy != "full" and config.remat_policy != model_config.remat_policy:
            import dataclasses

            self.mcfg = dataclasses.replace(model_config, remat_policy=config.remat_policy)

        self.params, ref, self.lora_cfg, self.lora_scale = build_policy(
            config, self.mcfg, params)
        self._ref_free = not (config.score_ref_logprobs
                              if config.score_ref_logprobs is not None
                              else config.kl_coef != 0.0)
        if config.score_ref_logprobs is False and config.kl_coef != 0.0:
            raise ValueError("score_ref_logprobs=False requires kl_coef == 0")
        self.ref_params = None if self._ref_free else ref
        # the optimizer sees only the trainable leaves (the same tensors as
        # in self.params): frozen weights get no moments and never move
        self.trainable = _trainable_leaves(
            self.params, trainable_mask(self.params, self.lora_cfg))
        for t in flatten(self.trainable).values():
            t.requires_grad_(True)
        self.optimizer = build_optimizer(config)
        self.opt_state = self.optimizer.init(self.trainable)

        self.ckpt = CheckpointManager(config.output_dir, config.save_total_limit,
                                      config.greater_is_better)
        self.logger = MetricsLogger(config.output_dir, config.report_to)
        self.state = {"episode": 0, "global_step": 0, "opt_steps": 0, "rollouts": 0}
        # the latest update's kernel launches per half, phase timings (wall
        # s, device-synchronized) and per-minibatch stats; and the wall
        # seconds of the latest checkpoint write
        self.last_launches: dict = {}
        self.last_timings: dict = {}
        self.last_stats: list = []
        self.last_save_s = None
        self._iter = dataset.loader(config.batch_size, config.seed)
        self.ctx_menu = shape_menu(dataset.input_ids.shape[1], min_value=16)

    # ------------------------------------------------------------------ #

    def _update(self, batch: dict, context_length: int) -> list[dict]:
        """PPO epochs × minibatches of optimizer steps over `batch`."""
        cfg = self.cfg
        local_bs = batch["responses"].shape[0]
        mini = max(1, local_bs // cfg.num_mini_batches)
        on_device = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        all_stats = []
        for epoch in range(cfg.num_ppo_epochs):
            gen = stream_generator(cfg.seed, PERM_STREAM, self.state["global_step"], epoch)
            perm = torch.randperm(local_bs, generator=gen)
            for start in range(0, local_bs - mini + 1, mini):
                inds = perm[start:start + mini].to(self.device)
                mb = {k: v[inds] for k, v in on_device.items()}
                self.opt_state, stats = update_minibatch(
                    self.params, self.trainable, self.optimizer, self.opt_state,
                    mb, self.mcfg, cfg, context_length,
                    self.tokenizer.pad_token_id, self.lora_scale)
                self.state["opt_steps"] += 1
                all_stats.append(stats)
        return all_stats

    def train(self, num_updates: int | None = None) -> dict:
        cfg, tok = self.cfg, self.tokenizer
        pad_id, eos_id = tok.pad_token_id, tok.eos_token_id
        stop_id = eos_id if cfg.stop_token == "eos" else None
        n = cfg.sample_n
        n_updates = (max(0, cfg.num_total_batches - self.state["global_step"])
                     if num_updates is None else num_updates)
        for _ in range(n_updates):
            t_start = time.perf_counter()
            queries = np.asarray(next(self._iter))
            index = self.state["rollouts"]
            self.state["rollouts"] += 1
            self.state["episode"] += cfg.batch_size
            t: dict = {}
            counts0 = launch_counts()
            ro = rollout_and_score(
                self.params, self.ref_params, self.mcfg, cfg, tok, queries,
                self.reward_func, rollout_generator(cfg.seed, index, self.device),
                self.lora_scale, stream_generator(cfg.seed, KEEP_STREAM, index),
                ctx_menu=self.ctx_menu, timings=t)
            if self.ref_params is None:
                ro["ref_logprobs"] = ro["logprobs"].copy()
            batch, post = assemble_grpo_batch(ro, cfg, stop_id, pad_id, eos_id)
            context_length = ro["context_length"]

            t0 = time.perf_counter()
            counts1 = launch_counts()
            lr_step = self.state["opt_steps"]
            all_stats = self._update(batch, context_length)
            t["update_s"] = time.perf_counter() - t0
            counts2 = launch_counts()
            self.last_launches = {
                "rollout_and_score": {k: counts1[k] - counts0[k] for k in counts0},
                "update": {k: counts2[k] - counts1[k] for k in counts0}}
            self.last_timings, self.last_stats = t, all_stats
            agg = {k: float(np.mean([s[k] for s in all_stats]))
                   for k in (all_stats[0] if all_stats else {})}
            metrics = self._metrics(ro, batch, post, agg, all_stats, lr_step, t,
                                    t_start, context_length)
            self.state["global_step"] += 1
            step = self.state["global_step"]
            if step % cfg.logging_steps == 0:
                self.logger.log(step, self.state["episode"], metrics)
                kept = ro["responses"]
                limit = (cfg.log_samples_limit if cfg.log_samples_limit is not None
                         else cfg.num_printed_samples)
                self.logger.log_samples(
                    step, [q.replace(tok.pad_token, "") for q in tok.batch_decode(ro["queries"])],
                    tok.batch_decode(kept), ro["scores"].reshape(-1, n)[
                        np.arange(kept.shape[0]), ro["keep"]], limit)
            if cfg.save_steps and step % cfg.save_steps == 0:
                t0 = time.perf_counter()
                self.save_checkpoint(metrics)
                self.last_save_s = time.perf_counter() - t0
        if cfg.load_best_model_at_end and num_updates is None:
            best = self.ckpt.best_step()
            if best is not None and best != self.state["global_step"]:
                self._load_trainable(self.ckpt.restore(best, self.device)["params"])
                print(f"loaded best checkpoint (step {best})")
        return self.state

    def _metrics(self, ro, batch, post, agg, all_stats, lr_step, t, t_start,
                 context_length) -> dict:
        """The `_old`/`_new` rows of the JAX trainer that this path computes
        (names and semantics per docs/METRICS.md)."""
        cfg = self.cfg
        pm = batch["padding_mask"]
        logprobs, ref_logprobs = batch["logprobs"], batch["ref_logprobs"]
        kl_rollout = float(np.where(pm, 0.0, logprobs - ref_logprobs).sum(1).mean())
        kl_old = 0.0 if self._ref_free else agg.get("refkl_mean", kl_rollout)
        scores_all = float(np.mean(ro["scores"]))
        local_bs, t_resp = batch["responses"].shape
        train_tokens = cfg.num_ppo_epochs * local_bs * (context_length + t_resp)
        mini = max(1, local_bs // cfg.num_mini_batches)
        micro_rows = max(1, mini // cfg.gradient_accumulation_steps)
        itemsize = self.params["embed_tokens"].element_size()
        metrics = {
            "objective/kl_old": kl_old,
            "objective/kl_rollout_old": kl_rollout,
            "objective/entropy_old": float((-np.where(pm, 0.0, logprobs)).sum(1).mean()),
            "objective/non_score_reward_old": 0.0,
            "eval_objective/rlhf_reward_old": scores_all,
            "eval_objective/scores_old": scores_all,
            "policy/approxkl_avg_new": agg.get("approxkl", 0.0),
            "policy/clipfrac_avg_new": agg.get("pg_clipfrac", 0.0),
            "policy/entropy_avg_new": agg.get("entropy", 0.0),
            "loss/policy_avg_new": agg.get("pg_loss", 0.0),
            "val/ratio_new": agg.get("ratio_mean", 1.0),
            "val/ratio_var_new": float(np.var([s["ratio_mean"] for s in all_stats]))
            if all_stats else 0.0,
            "val/num_eos_tokens_old": float((post == self.tokenizer.eos_token_id).sum()),
            "lr": self.optimizer.schedule(lr_step),
            "eps": cfg.adam_eps,
            "sec_per_episode": (time.perf_counter() - t_start) / cfg.batch_size,
            "episode": self.state["episode"],
            "policy/grad_norm_new": agg.get("grad_norm", 0.0),
            "mem/peak_bytes_in_use": float(torch.cuda.max_memory_allocated(self.device))
            if self.device.type == "cuda" else 0.0,
            "mem/logits_bytes_saved": float(micro_rows * t_resp * self.mcfg.vocab_size
                                            * itemsize) if cfg.fused_logprob else 0.0,
            "time/rollout_s": t["generate_s"],
            "time/reward_s": t["reward_s"],
            "time/logprob_s": t["score_s"],
            "time/update_s": t["update_s"],
            "perf/tokens_per_sec_update": train_tokens / max(t["update_s"], 1e-9),
        }
        return metrics

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, metrics: dict | None = None) -> str:
        cfg = self.cfg
        opt = None
        if cfg.save_optimizer_state:
            opt = {"count": self.opt_state.count, "mu": self.opt_state.mu,
                   "nu": self.opt_state.nu}
        metrics = metrics or {}
        return self.ckpt.save(
            self.state["global_step"], self.trainable, opt_state=opt,
            metric_old=metrics.get(cfg.metric_for_best_model),
            extra_state={k: self.state[k] for k in ("episode", "opt_steps", "rollouts")})

    @torch.no_grad()
    def _load_trainable(self, saved: dict) -> None:
        live = flatten(self.trainable)
        for path, t in flatten(saved).items():
            live[path].copy_(t)

    @torch.no_grad()
    def restore_checkpoint(self, step: int | None = None) -> int:
        """Load the trainable leaves, the optimizer state and the step
        counters saved at `step` (default: the latest) into this trainer,
        and fast-forward the data stream to the saved rollout cursor."""
        step = self.ckpt.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.cfg.output_dir}")
        tree = self.ckpt.restore(step, self.device)
        self._load_trainable(tree["params"])
        if "opt_state" in tree:
            opt = tree["opt_state"]
            for name in ("mu", "nu"):
                live = flatten(getattr(self.opt_state, name))
                for path, t in flatten(opt[name]).items():
                    live[path].copy_(t)
            self.opt_state = AdamWState(int(opt["count"]), self.opt_state.mu,
                                        self.opt_state.nu)
        state = self.ckpt.load_trainer_state(step)
        self.state.update(global_step=state["step"],
                          **{k: state[k] for k in ("episode", "opt_steps", "rollouts")})
        self._iter = self.dataset.loader(self.cfg.batch_size, self.cfg.seed)
        for _ in range(self.state["rollouts"]):
            next(self._iter)
        return step

    def close(self) -> None:
        self.logger.close()

