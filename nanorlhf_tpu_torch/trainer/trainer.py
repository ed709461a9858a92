"""RLTrainer — the port of `nanorlhf_tpu/trainer/trainer.py`'s `RLTrainer`
on its main path: the monolithic, synchronous branch of `train`
(:1676-2671) on one device, for all six algorithms.

One update, as in JAX:
    rollout (prefill + sampled decode; ReMax: + a greedy decode) → host
    reward → [GRPO: group z-score, keep 1 of N] → policy + ref scoring →
    the algorithm's batch (`rollout.assemble_batch`; PPO: the value pass,
    GAE) → PPO epochs × minibatches of `update_minibatch` (microbatch
    loss, backward, AdamW on each group's trainable leaves) →
    `_old`/`_new` metrics → checkpoint every `save_steps`.

`__init__` builds what JAX's does for this path: the policy with a fresh
LoRA subtree, the frozen ref, PPO's value tree (its own LoRA, a copy that
shares no storage with the policy), the trainable-leaf partition (the
LoRA adapters and, as PEFT's `modules_to_save`, the embeddings — JAX's
`LoraConfig` defaults; the value tree's score head too), the optimizer's
two groups, the checkpoint manager and the metrics logger; with
`rollout_quant="int8"` the int8 view of the base projections that
generation samples from (`_rollout_params`: quantized once under LoRA,
before each rollout under full fine-tuning, and again after a resume or
`load_best_model_at_end`). The random
draws JAX takes by splitting its trainer key (keep-1-of-N, RAFT's random
selection, the per-epoch permutation, the LoRA inits) come from
generators seeded from (seed, stream, index): same distributions, other
bits.

Unported knobs raise (`check_trainer_supported`): the async orchestrator
and fleet, rollout_ahead, environments, telemetry, lineage, the status
port, fault injection and profiling windows. The sentinel, the
health plane and the latency histograms are on by default in JAX but only
observe a healthy run; the port does not run them yet (ROADMAP).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.core.lora import (
    LoraConfig,
    init_lora_params,
    trainable_mask,
    value_trainable_mask,
)
from nanorlhf_tpu_torch.core.params import export_hf_checkpoint
from nanorlhf_tpu_torch.core.quant import quantize_layers, rollout_view
from nanorlhf_tpu_torch.trainer.bucketing import shape_menu
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig
from nanorlhf_tpu_torch.trainer.metrics import MetricsLogger
from nanorlhf_tpu_torch.trainer.optim import AdamWState, build_optimizer, flatten
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM,
    PERM_STREAM,
    assemble_batch,
    check_supported,
    rollout_and_score,
    rollout_generator,
    stream_generator,
)
from nanorlhf_tpu_torch.trainer.scoring import value_pass
from nanorlhf_tpu_torch.trainer.update import check_update_supported, update_minibatch

# seed streams of the policy's and the value tree's LoRA inits (the JAX
# trainer splits its key for them)
LORA_STREAM = 0x10AA
VALUE_LORA_STREAM = 0x7A1E


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


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _unshared(tree: dict, others) -> dict:
    """`tree` with a copy of every leaf whose storage a leaf of `others`
    shares: a value tree built by aliasing the policy's leaves would
    otherwise step the policy's embeddings (or be stepped by them)."""
    taken = {_storage(t) for o in others for t in flatten(o).values()}

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (v.detach().clone() if _storage(v) in taken else v)
                for k, v in node.items()}

    return walk(tree)


class RLTrainer:
    """The trainer on one device. Args mirror the JAX trainer's: config,
    model config, tokenizer, base params (the port's layout, on the device
    to train on), a dataset with `loader(batch, seed)` and `input_ids`,
    `reward_func(list[str], eos_token) -> scores`, and for PPO the value
    tree (`entrypoints/ppo.make_value_params`)."""

    def __init__(self, config: RLConfig, model_config, tokenizer, params: dict,
                 dataset, reward_func, value_params: dict | None = None):
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
        # in self.params / self.value_params): frozen weights get no
        # moments and never move
        self.trainable = _trainable_leaves(
            self.params, trainable_mask(self.params, self.lora_cfg))
        self._build_value(value_params, ref)
        groups = self._groups()
        for t in flatten(groups).values():
            t.requires_grad_(True)
        self.optimizer = build_optimizer(config)
        self.opt_state = self.optimizer.init(groups)
        # int8 rollout weights (core/quant.py): the frozen base quantized
        # once under LoRA; full fine-tuning re-quantizes at each rollout
        self._quant_layers = None
        if config.rollout_quant == "int8":
            self._refresh_quant_layers()

        self.ckpt = CheckpointManager(config.output_dir, config.save_total_limit,
                                      config.greater_is_better,
                                      io_retries=config.ckpt_io_retries,
                                      retry_backoff=config.ckpt_retry_backoff)
        self.logger = MetricsLogger(config.output_dir, config.report_to)
        self.state = {"episode": 0, "global_step": 0, "opt_steps": 0, "rollouts": 0}
        # the latest update's kernel launches per half (and the rollout
        # half split into generate / score; a decode loop's graph replays
        # count what each replay launched), phase timings (wall s,
        # device-synchronized; with the decode loop's graph_capture_s,
        # graph_steps_run and graph_replays) and per-minibatch stats; and
        # the seconds the latest checkpoint save blocked the loop (the
        # write itself runs on the manager's writer: `ckpt.last_write_s`)
        self.last_launches: dict = {}
        self.last_timings: dict = {}
        self.last_stats: list = []
        self.last_save_s = None
        # the latest paged rollout's pool snapshot and session status
        self.pages_status: dict | None = None
        self.session_status: dict | None = None
        self._iter = dataset.loader(config.batch_size, config.seed)
        self.ctx_menu = shape_menu(dataset.input_ids.shape[1], min_value=16)

    def _build_value(self, value_params: dict | None, ref: dict) -> None:
        """PPO's value tree: its own LoRA subtree (from (seed,
        VALUE_LORA_STREAM) unless it carries one) when `value_use_lora`,
        no leaf shared with the policy or the ref, and its trainable
        leaves (the adapters, the score head and the embeddings)."""
        cfg = self.cfg
        self.value_params = self.value_trainable = self.value_lora_cfg = None
        self.value_lora_scale = 1.0
        if value_params is None:
            if cfg.algo == AlgoName.PPO:
                raise ValueError("PPO requires value_params")
            return
        if cfg.value_use_lora:
            self.value_lora_cfg = LoraConfig(r=cfg.value_lora_r, alpha=cfg.value_lora_alpha)
            self.value_lora_scale = self.value_lora_cfg.scale
            if "lora" not in value_params:
                gen = stream_generator(cfg.seed, VALUE_LORA_STREAM, device=self.device)
                value_params = {**value_params, "lora": init_lora_params(
                    self.mcfg, self.value_lora_cfg, gen,
                    dtype=value_params["embed_tokens"].dtype, device=self.device)}
        self.value_params = _unshared(value_params, (self.params, ref))
        self.value_trainable = _trainable_leaves(
            self.value_params, value_trainable_mask(self.value_params,
                                                    self.value_lora_cfg))

    def _refresh_quant_layers(self) -> None:
        self._quant_layers = quantize_layers(self.params["layers"])

    def _rollout_params(self) -> dict:
        """The tree generation samples from: the live policy, with int8
        base projections when `rollout_quant` is on (LoRA, embeddings and
        norms stay the live tensors). Under full fine-tuning the base moved
        since the last rollout, so it is quantized anew."""
        if self._quant_layers is None:
            return self.params
        if not self.cfg.use_lora:
            self._refresh_quant_layers()
        return rollout_view(self.params, self._quant_layers)

    def _groups(self) -> dict:
        """The trainable leaves by optimizer group."""
        if self.value_trainable is None:
            return {"policy": self.trainable}
        return {"policy": self.trainable, "value": self.value_trainable}

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
                    self.params, self._groups(), self.optimizer, self.opt_state,
                    mb, self.mcfg, cfg, context_length,
                    self.tokenizer.pad_token_id, self.lora_scale,
                    value=self.value_params, value_lora_scale=self.value_lora_scale)
                self.state["opt_steps"] += 1
                all_stats.append(stats)
        return all_stats

    def train(self, num_updates: int | None = None) -> dict:
        cfg, tok = self.cfg, self.tokenizer
        pad_id, eos_id = tok.pad_token_id, tok.eos_token_id
        stop_id = eos_id if cfg.stop_token == "eos" else None
        n_updates = (max(0, cfg.num_total_batches - self.state["global_step"])
                     if num_updates is None else num_updates)
        for _ in range(n_updates):
            t_start = time.perf_counter()
            queries = np.asarray(next(self._iter))
            index = self.state["rollouts"]
            self.state["rollouts"] += 1
            self.state["episode"] += cfg.batch_size
            t: dict = {}
            ro_launches: dict = {}
            counts0 = launch_counts()
            # GRPO draws its keep in the rollout, RLOO and RAFT ("random")
            # theirs in the batch assembly: one stream an update
            keep_gen = stream_generator(cfg.seed, KEEP_STREAM, index)
            ro = rollout_and_score(
                self.params, self.ref_params, self.mcfg, cfg, tok, queries,
                self.reward_func, rollout_generator(cfg.seed, index, self.device),
                self.lora_scale, keep_gen,
                ctx_menu=self.ctx_menu, timings=t, launches=ro_launches,
                rollout_params=self._rollout_params())
            self._snapshot_pages(ro.get("paged_stats"))
            context_length = ro["context_length"]
            t0 = time.perf_counter()
            counts_v = launch_counts()
            batch, info = assemble_batch(
                ro, cfg, stop_id, pad_id, eos_id, keep_generator=keep_gen,
                value_fn=lambda qr: value_pass(self.value_params, self.mcfg, qr,
                                               context_length, pad_id,
                                               self.value_lora_scale))
            t["assemble_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            counts1 = launch_counts()
            lr_step = self.state["opt_steps"]
            all_stats = self._update(batch, context_length)
            t["update_s"] = time.perf_counter() - t0
            counts2 = launch_counts()
            self.last_launches = {
                "rollout_and_score": {k: counts1[k] - counts0[k] for k in counts0},
                **ro_launches,
                "value": {k: counts1[k] - counts_v[k] for k in counts0},
                "update": {k: counts2[k] - counts1[k] for k in counts0}}
            self.last_timings, self.last_stats = t, all_stats
            agg = {k: float(np.mean([s[k] for s in all_stats]))
                   for k in (all_stats[0] if all_stats else {})}
            metrics = self._metrics(ro, batch, info, agg, all_stats, lr_step, t,
                                    t_start, context_length)
            self.state["global_step"] += 1
            step = self.state["global_step"]
            if step % cfg.logging_steps == 0:
                self.logger.log(step, self.state["episode"], metrics)
                kept = batch["responses"]
                keep = info["keep"]
                scores = ro["scores"] if keep is None else ro["scores"].reshape(
                    -1, cfg.sample_n)[np.arange(kept.shape[0]), keep]
                queries_dec = [q.replace(tok.pad_token, "")
                               for q in tok.batch_decode(ro["queries"])]
                if keep is None:
                    queries_dec = [q for q in queries_dec for _ in range(cfg.sample_n)]
                limit = (cfg.log_samples_limit if cfg.log_samples_limit is not None
                         else cfg.num_printed_samples)
                self.logger.log_samples(step, queries_dec, tok.batch_decode(kept),
                                        scores, limit)
            if cfg.save_steps and step % cfg.save_steps == 0:
                t0 = time.perf_counter()
                self.save_checkpoint(metrics)
                self.last_save_s = time.perf_counter() - t0
        # train() returning means every checkpoint is durable: the final
        # write's failure raises here
        self.ckpt.wait()
        if cfg.load_best_model_at_end and num_updates is None:
            best = self.ckpt.best_step()
            if best is not None and best != self.state["global_step"]:
                self._load_trainable(self.ckpt.restore(best, self.device))
                if self._quant_layers is not None:
                    self._refresh_quant_layers()
                print(f"loaded best checkpoint (step {best})")
        if cfg.export_hf_dir and num_updates is None:
            # after load_best: the exported policy is the one the run deploys
            print(f"exporting HF checkpoint to {cfg.export_hf_dir}")
            self.export_model(cfg.export_hf_dir)
        return self.state

    def _metrics(self, ro, batch, info, agg, all_stats, lr_step, t, t_start,
                 context_length) -> dict:
        """The `_old`/`_new` rows of the JAX trainer that this path computes
        (names and semantics per docs/METRICS.md). The `_old` rollout rows
        read every scored row (all B·N for RLOO and RAFT)."""
        cfg = self.cfg
        pm = info["padding_mask"]
        logprobs, ref_logprobs = info["logprobs"], info["ref_logprobs"]
        kl_rollout = float(np.where(pm, 0.0, logprobs - ref_logprobs).sum(1).mean())
        # GRPO's kl_old is the update pass's new-vs-ref KL; the KL-in-reward
        # algorithms report the rollout's
        kl_old = (agg.get("refkl_mean", kl_rollout) if cfg.algo == AlgoName.GRPO
                  else kl_rollout)
        if self._ref_free:
            kl_old = 0.0
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
            "objective/non_score_reward_old": info.get("non_score_reward_old", 0.0),
            "eval_objective/rlhf_reward_old": info.get("rlhf_reward_old", scores_all),
            "eval_objective/scores_old": scores_all,
            "policy/approxkl_avg_new": agg.get("approxkl", 0.0),
            "policy/clipfrac_avg_new": agg.get("pg_clipfrac", 0.0),
            "policy/entropy_avg_new": agg.get("entropy", 0.0),
            "loss/policy_avg_new": agg.get("pg_loss", 0.0),
            "val/ratio_new": agg.get("ratio_mean", 1.0),
            "val/ratio_var_new": float(np.var([s.get("ratio_mean", 1.0)
                                               for s in all_stats]))
            if all_stats else 0.0,
            "val/num_eos_tokens_old": float((info["post"] == self.tokenizer.eos_token_id).sum()),
            "lr": self.optimizer.groups["policy"].schedule(lr_step),
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
        if "vf_loss" in agg:
            metrics["loss/value_avg_new"] = agg["vf_loss"]
            metrics["val/clipfrac_avg_new"] = agg.get("vf_clipfrac", 0.0)
        metrics.update(self._paged_metrics(ro.get("paged_stats")))
        metrics.update(self._spec_decode_metrics(ro.get("spec_stats")))
        return metrics

    @staticmethod
    def _spec_decode_metrics(spec_stats) -> dict:
        """rollout/draft_acceptance (accepted / drafted tokens),
        rollout/accepted_per_step (tokens emitted per live row per verify
        forward; identically 1 without speculative decode) and
        rollout/spec_verify_steps (the verify forwards) from a speculative
        rollout's stats — the one definition of these rows. {} when the
        rollout is not speculative."""
        if spec_stats is None:
            return {}
        return {
            "rollout/draft_acceptance": (float(spec_stats["accepted"])
                                         / max(float(spec_stats["drafted"]), 1.0)),
            "rollout/accepted_per_step": (float(spec_stats["emitted"])
                                          / max(float(spec_stats["row_steps"]), 1.0)),
            "rollout/spec_verify_steps": float(spec_stats["verify_steps"]),
        }

    @staticmethod
    def _paged_metrics(paged_stats) -> dict:
        """rollout/page_utilization, pages_recycled, admitted_midloop from a
        paged rollout's stats (the monolithic paged path reports utilization
        with no recycling or admissions), plus the decode session's
        counters on the continuous-batching path: session/dispatch_events
        (admission prefills + decode iterations), chunked_admissions and
        prefill_backlog (0: chunked prefill is not ported). {} when the
        rollout is not paged."""
        if paged_stats is None:
            return {}
        out = {
            "rollout/page_utilization": float(paged_stats["page_utilization"]),
            "rollout/pages_recycled": float(paged_stats["pages_recycled"]),
            "rollout/admitted_midloop": float(paged_stats["admitted_midloop"]),
        }
        if "dispatch_events" in paged_stats:
            out["session/dispatch_events"] = float(paged_stats["dispatch_events"])
            out["session/chunked_admissions"] = float(
                paged_stats["chunked_admissions"])
            out["session/prefill_backlog"] = float(
                paged_stats["prefill_backlog_peak"])
        return out

    def _snapshot_pages(self, pstats) -> None:
        """Keep the latest paged rollout's pool snapshot (`pages_status`:
        utilization, recycling, admissions, decode iterations, shape) and
        the decode session's end-of-call status (`session_status`) — what
        the JAX trainer serves on /statusz; the port keeps them on the
        trainer and serves nothing."""
        if pstats is None:
            return
        self.pages_status = {
            k: (None if pstats[k] is None else float(pstats[k]))
            for k in ("page_utilization", "pages_recycled",
                      "admitted_midloop", "decode_iterations")}
        self.pages_status.update(rows=pstats["rows"],
                                 num_pages=pstats["num_pages"],
                                 page_size=pstats["page_size"])
        self.session_status = pstats.get("session")

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, metrics: dict | None = None) -> str:
        """The trainable leaves of the policy (`params`) and, when
        `save_value_model`, of the value tree (`value`), with each group's
        optimizer state when `save_optimizer_state`."""
        cfg = self.cfg
        opt = None
        if cfg.save_optimizer_state:
            opt = {g: {"count": st.count, "mu": st.mu, "nu": st.nu}
                   for g, st in self.opt_state.items()}
        value = (self.value_trainable
                 if cfg.save_value_model and self.value_trainable is not None else None)
        metrics = metrics or {}
        return self.ckpt.save(
            self.state["global_step"], self.trainable, opt_state=opt,
            metric_old=metrics.get(cfg.metric_for_best_model),
            extra_state={k: self.state[k] for k in ("episode", "opt_steps", "rollouts")},
            value=value)

    @torch.no_grad()
    def _load_trainable(self, tree: dict) -> None:
        """Copy a checkpoint tree's `params` (and `value`) into the live
        trainable leaves."""
        for key, live_tree in (("params", self.trainable), ("value", self.value_trainable)):
            if key not in tree:
                continue
            live = flatten(live_tree)
            for path, t in flatten(tree[key]).items():
                live[path].copy_(t)

    @torch.no_grad()
    def resume_from_checkpoint(self, step: int | None = None) -> dict:
        """Load the trainable leaves (the value tree's too), the optimizer
        state and the step counters saved at `step` (default: the latest)
        into this trainer, and fast-forward the data stream to the saved
        rollout cursor. A checkpoint that will not load falls back to an
        older intact one, whose step is adopted; resuming an earlier step
        than the latest abandons the newer trajectory (`truncate_after`).
        The random streams are functions of (seed, stream, step or rollout
        index), so the restored counters restore them too."""
        latest = self.ckpt.latest_step()
        step = latest if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.cfg.output_dir}")
        tree = self.ckpt.restore(step, self.device)
        step = self.ckpt.last_restored_step
        if latest is not None and step < latest:
            self.ckpt.truncate_after(step)
        self._load_trainable(tree)
        if self._quant_layers is not None:
            self._refresh_quant_layers()  # the restored base
        for group, opt in tree.get("opt_state", {}).items():
            st = self.opt_state[group]
            for name in ("mu", "nu"):
                live = flatten(getattr(st, name))
                for path, t in flatten(opt[name]).items():
                    live[path].copy_(t)
            self.opt_state[group] = AdamWState(int(opt["count"]), st.mu, st.nu)
        state = self.ckpt.load_trainer_state(step)
        self.state.update(global_step=state["step"],
                          **{k: state[k] for k in ("episode", "opt_steps", "rollouts")})
        self._iter = self.dataset.loader(self.cfg.batch_size, self.cfg.seed)
        for _ in range(self.state["rollouts"]):
            next(self._iter)
        return self.state

    def restore_checkpoint(self, step: int | None = None) -> int:
        """`resume_from_checkpoint`, returning the step that loaded."""
        return self.resume_from_checkpoint(step)["global_step"]

    def export_model(self, out_dir: str, dtype: str = "bfloat16") -> str:
        """Write the current policy as an HF checkpoint directory, LoRA
        folded into the base kernels at `lora_scale`, with the tokenizer's
        special ids (and its files, when it can save them)."""
        return export_hf_checkpoint(
            self.mcfg, self.params, out_dir,
            lora_scale=self.lora_scale if self.cfg.use_lora else None,
            dtype=dtype, tokenizer=self.tokenizer)

    def close(self) -> None:
        try:
            self.ckpt.close()
        finally:
            self.logger.close()
