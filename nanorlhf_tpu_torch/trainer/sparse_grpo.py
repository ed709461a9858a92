"""Sparse GRPO — the port of `nanorlhf_tpu/trainer/sparse_grpo.py`, the
long-sequence (8,000-token responses) trainer of the r1 launcher, on one
device and on the fused path.

The four moves that let the reference train 8,000-token responses on one
card, step for step as the JAX loop (`sparse_grpo.py:325-867`):

1. **sparse filter** — drop the kept samples whose z-scored advantage is 0
   (with 0/1 rewards: every all-correct or all-wrong group); an update
   with none left is skipped: a metrics event row, no optimizer step, the
   rollout cursor advanced;
2. **de-padding** — strip the kept prompts' common left pad and cut the
   responses to the batch's longest, both rounded up to a power-of-two
   menu;
3. **bucket batching** — pack rows by length under `max_len × rows ≤
   budget`: scoring under the fused forward budget (22·2316 tokens), the
   update under `BACKWARD_BUDGET` (4·2316), each bucket padded to the rows
   menu with all-pad rows;
4. **bucket-scaled loss** — each bucket's loss is scaled by its real rows
   over the minibatch's, the gradients summed, one optimizer step per
   minibatch.

Scoring runs the existing `score_chunk` (K1 and K10; ref-free when
kl_coef is 0, as in r1), the update `update.microbatch_loss` (K1, K2/K3,
K10 with entropy), on either remat policy. With `fused_logprob=False` both
take the naive full-logits branch (no K10; the forward budget then has
JAX's vocab cap, and the backward budget half of it, so a row wider than
the budget is a bucket of its own). The rollout samples from the
trainer's rollout view (int8 base projections under `rollout_quant`).
Host-side numpy does the ragged filtering and packing.

The draws: keep-1-of-N from (seed, KEEP_STREAM, rollout index), each
epoch's permutation from (seed, PERM_STREAM, rollout index, epoch), the
rollout from (seed, rollout index) — functions of the rollout cursor, so a
resume after a skipped update replays the same streams.

The host planes make the JAX loop's calls (`sparse_grpo.py:380-860`):
the profile-window poll and the `train.update` span, the lineage `lease`,
`generation`, `reward`, `keep_filter` and per-row `sparse_zero_advantage`
drops, `outcome` and `sample` events, `latency/reward_s` and the phase
histograms, `perf/*` and the health plane's rows, a `sparse.skip` instant
on a skipped update, and the SIGTERM poll on both the skip path and the
step's end (an emergency checkpoint, then `Preempted`). As in JAX, the
reward has no retry loop here and the sentinel does not observe the
sparse loop.

A single-turn environment runs (the trainer unwraps it into a plain
reward callable); a multi-turn one raises ValueError, as in JAX.

Not ported (raise NotImplementedError): sequence parallelism (the SP
score and grad functions), rollout_ahead and the orchestrator and sampler
logprob capture.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.algos.advantages import (
    discounted_returns,
    grpo_group_advantage,
    keep_one_of_n_indices,
    sparse_terminal_rewards,
)
from nanorlhf_tpu_torch.ops.masking import (
    INVALID_LOGPROB,
    first_true_indices,
    response_padding_masks,
    truncate_response,
)
from nanorlhf_tpu_torch.sampler.sampler import generate, sync_device
from nanorlhf_tpu_torch.trainer.bucketing import (
    create_batches,
    depad_queries,
    pad_rows,
    round_up_to_menu,
    shape_menu,
)
from nanorlhf_tpu_torch.trainer.optim import flatten, unflatten
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM,
    PERM_STREAM,
    rollout_generator,
    rollout_model_config,
    sampling_params,
    stream_generator,
)
from nanorlhf_tpu_torch.trainer.scoring import forward_token_budget, score_chunk
from nanorlhf_tpu_torch.trainer.trainer import RLTrainer
from nanorlhf_tpu_torch.trainer.update import microbatch_loss

# the reference's backward budget (`grpo_r1_trainer.py:700`); the forward
# budget comes from forward_token_budget
BACKWARD_BUDGET = 4 * 2316


def epoch_permutation(seed: int, rollout_index: int, epoch: int, n: int) -> np.ndarray:
    """The order of the kept rows in one PPO epoch: a permutation drawn
    from (seed, PERM_STREAM, rollout index, epoch)."""
    gen = stream_generator(seed, PERM_STREAM, rollout_index, epoch)
    return torch.randperm(n, generator=gen).numpy()


class SparseGRPOTrainer(RLTrainer):
    """GRPO + sparse filtering + bucketed variable-length passes.

    `accuracy_func(trainer) -> float`, when given, runs before training and
    every `cfg.eval_steps` updates (r1's greedy eval). The reward callable
    may take `(pmt_and_responses, eos_token)` or r1's
    `(pmt_and_responses, responses_ids, tokenizer)`.

    `update_log` keeps one record a rollout: its index, kept rows, whether
    the update was skipped, the phases' wall seconds (device-synchronized;
    the generate's decode steps and graph counters among them), the kernel
    launches of the rollout, the scoring and the update, the buckets each
    pass ran ((real rows, rows_b, width) each), each backward bucket's loss
    stats, the metric row and the seconds the checkpoint save blocked the
    loop."""

    def __init__(self, *args, accuracy_func=None, **kwargs):
        super().__init__(*args, **kwargs)
        if self._env_multi_turn:
            # single-turn environments work (unwrapped into a plain reward
            # callable); the episode driver is wired into the dense
            # trainer's rollout only (JAX sparse_grpo.py:84-91)
            self.close()
            raise ValueError(
                "SparseGRPOTrainer does not drive multi-turn environments "
                "(env_max_turns > 1) — use the dense RLTrainer")
        self.accuracy_func = accuracy_func
        self._len_menu = shape_menu(
            self.cfg.response_length + self.dataset.input_ids.shape[1], min_value=32)
        self._rows_menu = shape_menu(max(self.cfg.batch_size, 1), min_value=1)
        self.update_log: list[dict] = []

    # ------------------------------------------------------------------ #

    def _call_reward(self, pmt_and_responses, responses_ids):
        try:
            return np.asarray(
                self.reward_func(pmt_and_responses, responses_ids, self.tokenizer),
                np.float32)
        except TypeError:
            return np.asarray(
                self.reward_func(pmt_and_responses, self.tokenizer.eos_token),
                np.float32)

    def _bucket_len(self, qr_len: np.ndarray, context_length: int, cap: int) -> int:
        """A bucket's width: its longest row rounded up to the menu, at
        least one response token, at most the batch's width."""
        blen = round_up_to_menu(int(qr_len.max()), self._len_menu)
        return min(max(blen, context_length + 1), cap)

    def score_buckets(self, qr: np.ndarray, qr_len: np.ndarray, context_length: int,
                      max_resp: int, buckets: list | None = None):
        """(policy, ref) logprobs [rows, max_resp] f32 (INVALID past each
        bucket's width) of the query+response rows `qr`, bucket by bucket
        under the fused forward budget (the ref's are the policy's when the
        run is ref-free). `buckets` (when given) receives (real rows,
        rows_b, width) of each."""
        cfg, pad_id = self.cfg, self.tokenizer.pad_token_id
        budget = forward_token_budget(self.mcfg.vocab_size,
                                      fused_logprob=cfg.fused_logprob)
        logprobs = np.full((qr.shape[0], max_resp), INVALID_LOGPROB, np.float32)
        ref_logprobs = logprobs.copy()
        for idxs in create_batches(qr_len, budget):
            blen = self._bucket_len(qr_len[idxs], context_length, qr.shape[1])
            rows_b = round_up_to_menu(len(idxs), self._rows_menu)
            padded = pad_rows({"qr": qr[idxs][:, :blen]}, rows_b, {"qr": pad_id})
            width = blen - context_length
            lp, rlp = score_chunk(
                self.params, self.ref_params, self.mcfg, cfg,
                torch.as_tensor(padded["qr"], device=self.device), context_length,
                pad_id, self.lora_scale)
            logprobs[idxs, :width] = lp[:len(idxs)].float().cpu().numpy()
            ref_logprobs[idxs, :width] = rlp[:len(idxs)].float().cpu().numpy()
            if buckets is not None:
                buckets.append((len(idxs), rows_b, blen))
        return logprobs, ref_logprobs

    def bucket_grads(self, mb: dict, context_length: int, loss_scale: float):
        """(grads {path: f32 tensor} of the trainable leaves, aux) of one
        bucket's GRPO loss × `loss_scale` (its real rows over the
        minibatch's): the dense update's microbatch loss, at the bucket's
        width."""
        leaves = flatten(self._groups())
        paths, tensors = list(leaves), list(leaves.values())
        loss, aux = microbatch_loss(
            self.params, self.mcfg, self.cfg, mb, context_length,
            self.tokenizer.pad_token_id, self.lora_scale,
            remat=self.cfg.gradient_checkpointing)
        grads = torch.autograd.grad(loss * loss_scale, tensors, allow_unused=True)
        return ({p: (torch.zeros_like(t, dtype=torch.float32) if g is None else g.float())
                 for p, t, g in zip(paths, tensors, grads)},
                {k: float(v) for k, v in aux.items()})

    def bucket_batch(self, batch: dict, sel: np.ndarray) -> tuple[dict, int]:
        """The device minibatch of the `kept_batch` rows `sel` at their
        bucket's width, padded to the rows menu with all-pad, fully masked
        rows; and the width."""
        ctx = batch["context_length"]
        blen = self._bucket_len(batch["qr_len"][sel], ctx, batch["qr"].shape[1])
        width = blen - ctx
        rows_b = round_up_to_menu(len(sel), self._rows_menu)
        pad_id = self.tokenizer.pad_token_id
        mb = pad_rows(
            {"query_responses": batch["qr"][sel][:, :blen],
             **{k: batch[k][sel][:, :width] for k in (
                 "responses", "logprobs", "ref_logprobs", "advantages", "padding_mask")}},
            rows_b,
            {"query_responses": pad_id, "responses": pad_id,
             "logprobs": INVALID_LOGPROB, "ref_logprobs": INVALID_LOGPROB,
             "padding_mask": True})
        return {k: torch.as_tensor(v, device=self.device) for k, v in mb.items()}, blen

    def backward_budget(self) -> int:
        return min(BACKWARD_BUDGET, forward_token_budget(
            self.mcfg.vocab_size, fused_logprob=self.cfg.fused_logprob) // 2)

    def kept_batch(self, queries: np.ndarray, responses: np.ndarray,
                   scores: np.ndarray, score_buckets: list | None = None) -> dict:
        """The update's arrays of the kept rows (prompts [rows, Tq], one
        response each [rows, R], their nonzero z-scored advantages [rows]):
        the prompts de-padded and the responses cut to the longest (EOS
        truncation), both menu-rounded; the bucketed scoring pass; the
        padding masks, INVALID-filled logprobs, and each row's advantage
        broadcast over its tokens. Returns numpy arrays `qr`, `responses`,
        `logprobs`, `ref_logprobs`, `advantages`, `padding_mask`, `qr_len`
        [rows] and the ints `context_length`, `max_resp`."""
        pad_id, eos_id = self.tokenizer.pad_token_id, self.tokenizer.eos_token_id
        queries = depad_queries(queries, pad_id, self._len_menu)
        context_length = queries.shape[1]
        post = truncate_response(eos_id, pad_id, torch.as_tensor(responses)).numpy()
        resp_len = first_true_indices(torch.as_tensor(post) == pad_id).numpy()
        max_resp = round_up_to_menu(max(int(resp_len.max()), 1), self._len_menu)
        max_resp = min(max_resp, responses.shape[1])
        responses, post = responses[:, :max_resp], post[:, :max_resp]
        qr = np.concatenate([queries, responses], axis=1)
        qr_len = context_length + resp_len

        logprobs, ref_logprobs = self.score_buckets(qr, qr_len, context_length, max_resp,
                                                    score_buckets)
        if self._ref_free:
            ref_logprobs = logprobs.copy()
        seq_len = first_true_indices(torch.as_tensor(post) == pad_id) - 1
        padding_mask = response_padding_masks(torch.as_tensor(post), seq_len)[0].numpy()
        rewards = sparse_terminal_rewards(torch.as_tensor(scores), seq_len, max_resp)
        return {
            "qr": qr, "responses": responses, "padding_mask": padding_mask,
            "logprobs": np.where(padding_mask, INVALID_LOGPROB,
                                 logprobs).astype(np.float32),
            "ref_logprobs": np.where(padding_mask, INVALID_LOGPROB,
                                     ref_logprobs).astype(np.float32),
            "advantages": np.where(padding_mask, 0.0, discounted_returns(
                rewards, 1.0).numpy()).astype(np.float32),
            "qr_len": qr_len, "context_length": context_length, "max_resp": max_resp,
        }

    def minibatch_grads(self, batch: dict, mb_inds: np.ndarray, stats: list | None = None,
                        buckets: list | None = None) -> dict:
        """The summed, loss-scaled gradients {path: f32} of one minibatch's
        rows `mb_inds`, bucket by bucket under the backward budget. `stats`
        receives each bucket's loss stats, `buckets` its (real rows,
        rows_b, width)."""
        ctx, qr_len = batch["context_length"], batch["qr_len"]
        grads_acc = None
        for bidx in create_batches(qr_len[mb_inds], self.backward_budget()):
            sel = mb_inds[bidx]
            mb, blen = self.bucket_batch(batch, sel)
            grads, aux = self.bucket_grads(mb, ctx, len(sel) / len(mb_inds))
            if grads_acc is None:
                grads_acc = grads
            else:
                for p, g in grads.items():
                    grads_acc[p].add_(g)
            if stats is not None:
                stats.append(aux)
            if buckets is not None:
                buckets.append((len(sel), mb["responses"].shape[0], blen))
        return grads_acc

    # ------------------------------------------------------------------ #

    def train(self, num_updates: int | None = None) -> dict:
        cfg, tok = self.cfg, self.tokenizer
        pad_id, eos_id = tok.pad_token_id, tok.eos_token_id
        n = cfg.sample_n
        if self.accuracy_func is not None and self.state["global_step"] == 0:
            acc = float(self.accuracy_func(self))
            self.logger.log(0, 0, {"initial_accuracy": acc})
        sampling = sampling_params(cfg)
        n_updates = (max(0, cfg.num_total_batches - self.state["global_step"])
                     if num_updates is None else num_updates)
        self.lineage.rows_hint = cfg.batch_size * n
        for _ in range(n_updates):
            t_start = time.perf_counter()
            self.profile_window.poll(self.state["global_step"] + 1)
            span_t0 = self.tracer.now_us() if self.tracer.enabled else 0.0
            self.state["episode"] += cfg.batch_size
            index = self.state["rollouts"]
            self.state["rollouts"] += 1
            if self.lineage.enabled:
                self.lineage.lease(index, worker_id=0, cursor=index, length=1)
            record = {"index": index, "skipped": False, "kept": 0}
            self.update_log.append(record)
            t: dict = {}
            counts0 = launch_counts()

            # ---- rollout + reward -----------------------------------------
            queries = depad_queries(np.asarray(next(self._iter)), pad_id, self._len_menu)
            q_t = torch.as_tensor(queries, dtype=torch.int64, device=self.device)
            tp_call = self.tracer.now_us()
            paged_stats: list = []
            spec_stats: list = []
            responses = generate(
                self._rollout_params(), rollout_model_config(self.mcfg, cfg), q_t,
                q_t != pad_id,
                rollout_generator(cfg.seed, index, self.device), sampling,
                eos_token_id=eos_id, pad_token_id=pad_id, lora_scale=self.lora_scale,
                timings=t, paged_stats_out=paged_stats, spec_stats_out=spec_stats,
                tracer=self.tracer if self.tracer.enabled else None,
                latency=self.latency).cpu().numpy()
            t["generate_s"] = time.perf_counter() - t_start
            self._note_rollout({"paged_stats": paged_stats[0] if paged_stats else None,
                                "spec_stats": spec_stats[0] if spec_stats else None},
                               index, t_start, tp_call, t["generate_s"])
            counts1 = launch_counts()
            batch_size = queries.shape[0]
            question_strings = [q.replace(tok.pad_token, "")
                                for q in tok.batch_decode(queries)]
            question_n = [q for q in question_strings for _ in range(n)]
            decoded = tok.batch_decode(responses)
            t0 = time.perf_counter()
            raw_scores = self._call_reward(
                [q + r for q, r in zip(question_n, decoded)], responses)
            t["reward_s"] = time.perf_counter() - t0
            if self.latency.enabled:
                self.latency.record("latency/reward_s", t["reward_s"])
            self.lineage.reward(index, step=self.state["global_step"],
                                scores=[round(float(x), 6) for x in raw_scores.tolist()],
                                attempt=1, wall_s=round(t["reward_s"], 6))
            mean_raw_score = float(raw_scores.mean())
            log_responses_length = float(
                first_true_indices(torch.as_tensor(responses) == pad_id).float().mean())

            # ---- group z-score + keep-1-of-N ------------------------------
            adv_flat = grpo_group_advantage(torch.as_tensor(raw_scores), n).numpy()
            keep = keep_one_of_n_indices(
                stream_generator(cfg.seed, KEEP_STREAM, index), batch_size, n).numpy()
            rows = np.arange(batch_size)
            scores = adv_flat.reshape(batch_size, n)[rows, keep]
            responses = responses.reshape(batch_size, n, -1)[rows, keep]
            if n > 1:
                self.lineage.drop(index, "keep_filter", count=batch_size * (n - 1),
                                  step=self.state["global_step"])

            # ---- sparse filter --------------------------------------------
            nz = np.where(scores != 0)[0]
            kept_frac = len(nz) / max(batch_size, 1)
            record.update(kept=len(nz), raw_score_mean=mean_raw_score)
            if self.lineage.enabled:
                # one drop event per row the filter excludes
                raw_kept = raw_scores.reshape(batch_size, n)[rows, keep]
                for r in np.where(scores == 0)[0]:
                    self.lineage.drop(index, "sparse_zero_advantage", row=int(r),
                                      step=self.state["global_step"],
                                      raw_score=round(float(raw_kept[r]), 6))
            if len(nz) == 0:
                print(f"[sparse-grpo] rollout {index}: all advantages zero, skipping")
                self.tracer.instant("sparse.skip", rollout_index=self.state["rollouts"],
                                    raw_score_mean=mean_raw_score)
                self.logger.log_event(self.state["rollouts"], {
                    "sparse_skip/raw_score_mean": mean_raw_score,
                    "sparse_skip/rollout_index": self.state["rollouts"],
                })
                record.update(skipped=True, timings=t,
                              launches={"generate": _diff(counts1, counts0)})
                # a streak of skips must not swallow SIGTERM
                if self._preemption.triggered:
                    self._preempt(False, {})
                continue

            # ---- de-pad, cut, bucketed logprob pass, advantages -----------
            t0 = time.perf_counter()
            score_buckets: list = []
            batch = self.kept_batch(queries[nz], responses[nz], scores[nz], score_buckets)
            t["score_s"] = time.perf_counter() - t0
            counts2 = launch_counts()

            # ---- bucketed update (budget 4·2316, loss-scaled) -------------
            t0 = time.perf_counter()
            local_bs = len(nz)
            mini = min(cfg.local_mini_batch_size, local_bs)
            lr_step = self.state["opt_steps"]
            all_stats, update_buckets = [], []
            for epoch in range(cfg.num_ppo_epochs):
                perm = epoch_permutation(cfg.seed, index, epoch, local_bs)
                for start in range(0, local_bs, mini):
                    grads = self.minibatch_grads(batch, perm[start:start + mini],
                                                 all_stats, update_buckets)
                    self.opt_state = self.optimizer.step(
                        self._groups(), unflatten(grads), self.opt_state)
                    self.state["opt_steps"] += 1
            sync_device(self.device)
            t["update_s"] = time.perf_counter() - t0
            counts3 = launch_counts()
            context_length, max_resp = batch["context_length"], batch["max_resp"]
            padding_mask = batch["padding_mask"]
            logprobs, ref_logprobs = batch["logprobs"], batch["ref_logprobs"]
            record.update(
                timings=t, context_length=context_length, max_resp=max_resp,
                score_buckets=score_buckets, update_buckets=update_buckets,
                stats=all_stats,
                launches={"generate": _diff(counts1, counts0),
                          "score": _diff(counts2, counts1),
                          "update": _diff(counts3, counts2)})
            self.last_timings, self.last_stats = t, all_stats

            # ---- metrics / eval / checkpoint ------------------------------
            agg = {k: float(np.mean([s[k] for s in all_stats]))
                   for k in (all_stats[0] if all_stats else {})}
            kl_rollout = float(np.where(padding_mask, 0.0,
                                        logprobs - ref_logprobs).sum(1).mean())
            itemsize = self.params["embed_tokens"].element_size()
            metrics = {
                "objective/kl_old": 0.0 if self._ref_free else agg.get("refkl_mean",
                                                                        kl_rollout),
                "objective/kl_rollout_old": kl_rollout,
                "objective/non_score_reward_old": 0.0,
                "eval_objective/rlhf_reward_old": mean_raw_score,
                "eval_objective/scores_old": mean_raw_score,
                "policy/approxkl_avg_new": agg.get("approxkl", 0.0),
                "policy/clipfrac_avg_new": agg.get("pg_clipfrac", 0.0),
                "policy/entropy_avg_new": agg.get("entropy", 0.0),
                "loss/policy_avg_new": agg.get("pg_loss", 0.0),
                "val/ratio_new": agg.get("ratio_mean", 1.0),
                "val/ratio_var_new": float(np.var([s.get("ratio_mean", 1.0)
                                                   for s in all_stats]))
                if all_stats else 0.0,
                "lr": self.optimizer.groups["policy"].schedule(lr_step),
                "eps": cfg.adam_eps,
                "sparse/kept_frac": kept_frac,
                "eval_response_length": log_responses_length,
                "sec_per_episode": (time.perf_counter() - t_start) / cfg.batch_size,
                "mem/peak_bytes_in_use": float(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else 0.0,
                # the logits block the fused path does not hold (0 on the
                # naive branch, which holds it)
                "mem/logits_bytes_saved": float(
                    max(1, self.backward_budget() // (context_length + max_resp))
                    * max_resp * self.mcfg.vocab_size * itemsize)
                if cfg.fused_logprob else 0.0,
                "episode": self.state["episode"],
                "time/rollout_s": t["generate_s"],
                "time/reward_s": t["reward_s"],
                "time/logprob_s": t["score_s"],
                "time/update_s": t["update_s"],
            }
            # the dense loop's napkin model over this update's real work:
            # scoring and the update count only the kept rows
            score_forwards = 1 if self._ref_free else 2
            metrics.update(self._perf_metrics(
                step_wall_s=time.perf_counter() - t_start,
                decode_tokens=batch_size * n * cfg.response_length,
                prefill_tokens=batch_size * n * queries.shape[1],
                score_tokens=score_forwards * local_bs * (context_length + max_resp),
                train_tokens=cfg.num_ppo_epochs * local_bs * (context_length + max_resp),
                rollout_s=t["generate_s"], update_s=t["update_s"]))
            self._record_phases({"time/rollout_s": t["generate_s"],
                                 "time/update_s": t["update_s"]})
            self.state["global_step"] += 1
            step = self.state["global_step"]
            if self.accuracy_func is not None and cfg.eval_steps and \
                    step % cfg.eval_steps == 0:
                metrics["eval_accuracy_new"] = float(self.accuracy_func(self))
            metrics.update(self.health.observe(step, metrics))
            kept_scores = raw_scores.reshape(batch_size, n)[rows, keep]
            kept_decoded = [decoded[i * n + j] for i, j in enumerate(keep)]
            if self.lineage.enabled:
                self.lineage.outcome(
                    index, step=step, policy_version=step, kept=int(local_bs),
                    advantage=round(float(scores[nz].mean()), 6),
                    scores=[round(float(x), 6) for x in kept_scores.tolist()],
                    kept_frac=round(kept_frac, 4))
                for r in nz[:8]:
                    self.lineage.note_sample(index, step=step,
                                             score=round(float(kept_scores[r]), 6),
                                             response_chars=len(kept_decoded[r]),
                                             kept=True)
            if step % cfg.logging_steps == 0:
                self.logger.log(step, self.state["episode"], metrics)
                limit = (cfg.log_samples_limit if cfg.log_samples_limit is not None
                         else cfg.num_printed_samples)
                self.logger.log_samples(step, question_strings, kept_decoded,
                                        kept_scores, limit)
                if self.lineage.enabled:
                    for i, (q, r_txt, sc) in enumerate(zip(
                            question_strings, kept_decoded, kept_scores.tolist())):
                        if i >= limit:
                            break
                        self.lineage.event("sample", index, step=step, row=i,
                                           query=q, response=r_txt,
                                           score=round(float(sc), 6))
            record["metrics"] = metrics
            saved = False
            if cfg.save_steps and step % cfg.save_steps == 0:
                t0 = time.perf_counter()
                self.save_checkpoint(metrics)
                self.last_save_s = record["save_s"] = time.perf_counter() - t0
                saved = True
            if self.tracer.enabled:
                # staleness is 0 here (no orchestrator); kept_rows is the
                # sparse loop's own correlation arg
                self.tracer.add_complete(
                    "train.update", span_t0, self.tracer.now_us() - span_t0,
                    step=step, rollout_index=index, staleness=0,
                    policy_version=step, kept_rows=local_bs)
            if self._preemption.triggered:
                self._preempt(saved, metrics)
        # train() returning means every checkpoint is durable
        self.ckpt.wait()
        self.profile_window.stop()
        self._write_trace()
        if cfg.export_hf_dir and num_updates is None:
            print(f"exporting HF checkpoint to {cfg.export_hf_dir}")
            self.export_model(cfg.export_hf_dir)
        return self.state


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in before}
