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

The host planes, built in JAX's order and wired through the loop as JAX's
(`nanorlhf_tpu/trainer/trainer.py:537-745`): fault injection
(`fault_spec`), the training sentinel (a NaN or spiking update rolls back
to the last checkpoint and quarantines its rollout index, which the replay
skips before dispatch), the producer watchdog (restarts a dead rollout
pipeline, then degrades the run to synchronous rollouts), the SIGTERM guard (an
emergency checkpoint and `Preempted` at the next update boundary), the
span tracer and its flight recorder (`trace.json`, `blackbox_<step>.json`),
the MFU accounting (`perf/*`), the lineage ledger, the latency histograms,
the health plane, the status exporter (`status_port`), the phase timer and
the torch.profiler window (`profile_at_step`). Their journals ride in
`trainer_state.json` and come back on resume. `close()` stops the exporter
and uninstalls the SIGTERM guard: every trainer that is built is closed.

Environments (`env_name`, JAX trainer.py:647-697): a single-turn
environment unwraps into a plain reward callable (`as_reward_func`), so
generation and the reward dispatch stay on the non-env path; a multi-turn
one (`env_max_turns > 1`, GRPO over the paged cache only) swaps the
rollout for the episode driver (`envs/rollout.py`), scores per turn and
trains under the observation `loss_mask`. `close()` closes the
environment (its pooled executor's worker).

Rollout sources (JAX trainer.py:854-1001, 1887-2031): the synchronous
loop generates on the trainer's thread from the live tree; `rollout_ahead`
generates rollout k+1 on a producer thread, from a snapshot taken before
update k, while update k runs (`RolloutStream`); `rollout_orchestrator`
runs the bounded-staleness pipeline (`orchestrator.RolloutOrchestrator`,
or with `rollout_workers > 1` the leased fleet over the in-process or the
loopback-RPC transport), fed one published snapshot after every update
(`_policy_snapshot`: the trainable leaves cloned on the trainer's stream —
the optimizer steps them in place — the frozen ones aliased, an event
recorded after the clones). Producer threads run on CUDA streams of their
own and still launch the kernels; the producer watchdog restarts a dead
pipeline and, past its budget, degrades the run to synchronous rollouts
(`resilience/degraded_mode`). With `sampler_logprob_capture` the sampler's
logprobs replace the policy scoring forward, or, under the truncated-IS
correction (`max_staleness > 0`, `offpolicy_correction="truncated_is"`),
weight the losses as the behavior policy's; `rollout_inflight_swaps`
installs mid-rollout publishes into the queued paged session in place.
The orchestrator's counters ride in `trainer_state.json`.

Sequence parallelism (`cfg.mesh = MeshConfig(1, 1, 1, N)` on N ranks,
`torchrun --nproc-per-node N`; JAX trainer.py:1503-1527): every rank
builds the same trainer; rank 0 generates each rollout and every rank
takes it (`RolloutStream`), grades it and checks a digest of the
query-responses and rewards against the others' (`_sp_agree_rollout`);
scoring, PPO's value pass and the
update go around the ring (`parallel.sp`), the gradients summed over the
group. Metrics, checkpoints and the host planes write on rank 0 only;
every rank reads rank 0's checkpoints (a rollback or a resume waits for
rank 0's writer first), and they agree on the best step at the end.

The data and fsdp axes (`cfg.mesh = MeshConfig(d, f, 1, s)` on d·f·s
ranks; the default `MeshConfig()` puts every rank on data; JAX
trainer.py:513-516): the policy, ref and value trees are sharded over fsdp
(`parallel.mesh.shard_params`) and so are the AdamW moments; every rank
draws the same global batch, generates its own block of prompts from a
rollout view gathered whole once per generate (int8 rollout weights
quantize that view) and freed after it, grades its rows, and the rollout
is all-gathered, so advantages, keeps and permutations are global; every
scoring and update forward splits its rows over the batch ranks
(`scoring.score_chunk`, `update.microbatch_loss`), gathering each layer
over fsdp as it runs. Checkpoints hold the unsharded leaves (gathered,
written by rank 0) and each rank slices its shard on resume, so a
checkpoint moves between meshes. Under data × fsdp > 1 the async
orchestrator and fleet, `rollout_ahead` and multi-turn environments raise
NotImplementedError naming A14c.

Unported knobs raise (`check_trainer_supported`): disaggregated rollout
devices and the tensor axis (A14c); the JAX trainer's ValueErrors on the
orchestrator's, the fleet's and the environments' knobs come first.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from nanorlhf_tpu_torch._build import launch_counts
from nanorlhf_tpu_torch.core.lora import (
    LoraConfig,
    init_lora_params,
    trainable_mask,
    value_trainable_mask,
)
from nanorlhf_tpu_torch.core.params import export_hf_checkpoint
from nanorlhf_tpu_torch.core.quant import quantize_layers, rollout_view
from nanorlhf_tpu_torch.resilience import (
    FaultInjector,
    Preempted,
    PreemptionGuard,
    ProducerWatchdog,
    SentinelConfig,
    TrainingSentinel,
    WatchdogConfig,
    null_guard,
)
from nanorlhf_tpu_torch.telemetry import (
    DEFAULT_RULES,
    SLO_RULES,
    HealthConfig,
    HealthMonitor,
    LatencyHub,
    LineageLedger,
    OverlapMeter,
    SpanTracer,
    StatusExporter,
    flops_param_count,
    peak_flops_per_chip,
    recompile_counter,
    update_flops,
)
from nanorlhf_tpu_torch.telemetry.lineage import segments_summary, spec_summary
from nanorlhf_tpu_torch.trainer.bucketing import shape_menu
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig
from nanorlhf_tpu_torch.orchestrator.orchestrator import (
    SnapshotTree,
    adopt_payload,
    device_ready,
    producer_stream,
    reader_wait,
)
from nanorlhf_tpu_torch.orchestrator.sample_queue import ProducerFailed
from nanorlhf_tpu_torch.parallel.distributed import any_rank, world_size
from nanorlhf_tpu_torch.parallel.fsdp import full_tree, shard_of
from nanorlhf_tpu_torch.parallel.mesh import A14C, make_mesh, shard_params
from nanorlhf_tpu_torch.trainer.metrics import MetricsLogger, staleness_histogram_metrics
from nanorlhf_tpu_torch.trainer.optim import AdamWState, build_optimizer, flatten
from nanorlhf_tpu_torch.trainer.rollout import (
    KEEP_STREAM,
    PERM_STREAM,
    assemble_batch,
    check_supported,
    generate_rollout,
    rollout_generator,
    score_rollout,
    stream_generator,
    uses_truncated_is,
)
from nanorlhf_tpu_torch.trainer.scoring import value_pass
from nanorlhf_tpu_torch.trainer.update import check_update_supported, update_minibatch
from nanorlhf_tpu_torch.utils.profiling import PhaseTimer, ProfileWindow

# seed streams of the policy's and the value tree's LoRA inits (the JAX
# trainer splits its key for them)
LORA_STREAM = 0x10AA
VALUE_LORA_STREAM = 0x7A1E


def check_multi_turn_config(cfg: RLConfig) -> None:
    """The JAX trainer's ValueErrors on a multi-turn environment
    (`nanorlhf_tpu/trainer/trainer.py:670-697`, with its messages): GRPO
    only, the paged cache only, none of the knobs the episode driver
    cannot share the rollout with, and an episode budget that fits the
    response. `_build_env` runs it when the built environment takes more
    than one turn, as JAX does."""
    if cfg.algo != AlgoName.GRPO:
        raise ValueError(
            "multi-turn environments (env_max_turns > 1) are "
            "wired for GRPO only: per-turn advantages ride the "
            "group z-score path")
    if cfg.rollout_page_size <= 0:
        raise ValueError(
            "env_max_turns > 1 requires rollout_page_size > 0: "
            "continuation turns are admitted through the paged "
            "single-row bucketed prefill")
    if (cfg.rollout_orchestrator or cfg.rollout_workers > 1
            or cfg.rollout_spec_k > 0 or cfg.sampler_logprob_capture
            or cfg.rollout_prefix_cache):
        raise ValueError(
            "env_max_turns > 1 is incompatible with the "
            "orchestrator fleet, spec decode, sampler logprob "
            "capture, and the prefix cache — the episode driver "
            "owns the rollout phase")
    tt = cfg.env_turn_tokens or cfg.response_length
    budget = tt * cfg.env_max_turns + cfg.env_obs_budget * (cfg.env_max_turns - 1)
    if budget > cfg.response_length:
        raise ValueError(
            f"episode budget {budget} (env_turn_tokens={tt} * "
            f"{cfg.env_max_turns} turns + env_obs_budget="
            f"{cfg.env_obs_budget} * "
            f"{cfg.env_max_turns - 1} observations) exceeds "
            f"response_length={cfg.response_length} — the "
            "packed episode must fit the scored batch")


def check_trainer_supported(cfg: RLConfig) -> None:
    """`check_supported` (the orchestrator's and the fleet's ValueErrors,
    then the rollout's knobs) and the update's knobs."""
    check_supported(cfg)
    check_update_supported(cfg, {})


def check_mesh_supported(cfg: RLConfig, mesh) -> None:
    """The paths that do not run on this mesh raise NotImplementedError
    naming A14c rather than fall back: the async orchestrator and fleet on
    more than one rank (their producers would run on every rank), and
    `rollout_ahead` and multi-turn environments on batch ranks."""
    if mesh.sp * mesh.batch > 1 and cfg.rollout_orchestrator:
        raise NotImplementedError(
            f"rollout_orchestrator on a mesh of {mesh.sp * mesh.batch} ranks is not "
            f"ported to nanorlhf_tpu_torch: it waits for {A14C}")
    if mesh.batch > 1:
        for knob, on in (("rollout_ahead", cfg.rollout_ahead),
                         ("env_max_turns > 1", cfg.env_name and cfg.env_max_turns > 1)):
            if on:
                raise NotImplementedError(
                    f"{knob} on data x fsdp = {mesh.batch} ranks is not ported to "
                    f"nanorlhf_tpu_torch: it waits for {A14C}")


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


class _Prefetch:
    """One rollout generating on a producer thread (its own CUDA stream):
    `result()` waits for it and returns its payload, or raises what it
    raised."""

    def __init__(self, fn, device):
        self._payload = self._error = None

        def run():
            try:
                with producer_stream(device):
                    self._payload = fn()
            except BaseException as e:  # surfaces in result()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="rollout-ahead")
        self._thread.start()

    def result(self):
        self._thread.join()
        if self._error is not None:
            raise self._error
        adopt_payload(self._payload)
        return self._payload


class RolloutStream:
    """The rollout source of the synchronous and `rollout_ahead` loops (JAX
    `RolloutStream`, trainer.py:189-274). `fetch_or_dispatch()` returns the
    prefetched rollout when one is pending, else generates the next one on
    the calling thread from the live tree; `prefetch()` draws the next
    batch now and generates it on a producer thread from a snapshot of the
    current weights (one update stale once the caller steps), while the
    caller goes on with its update. Either way it records the consumed
    index in `trainer.state["rollouts"]`. The data cursor advances on the
    calling thread, in index order.

    Under sequence parallelism the first rank of each sp line generates
    and every rank of the line takes its payload (a collective on the
    calling thread, after the generation or the prefetch's join); the
    other ranks draw the same batches and generate nothing. Batch ranks
    each generate their block inside `generate_rollout` and gather the
    rows there."""

    def __init__(self, trainer):
        self._t = trainer
        self._idx = trainer.state["rollouts"]
        self._pending = None   # (index, _Prefetch)

    def _draw(self) -> tuple[int, np.ndarray]:
        t = self._t
        queries = np.asarray(next(t._iter))
        idx = self._idx
        self._idx += 1
        if t.lineage.enabled:
            # no coordinator: the dispatch is the lease (worker 0, cursor ==
            # index)
            t.lineage.lease(idx, worker_id=0, cursor=idx, length=1)
        return idx, queries

    def fetch_or_dispatch(self) -> tuple[int, dict, bool]:
        """(index, payload, prefetched)."""
        t = self._t
        generates = t.mesh.sp_rank == 0
        if self._pending is not None:
            idx, job = self._pending
            self._pending = None
            payload, prefetched = (job.result() if job is not None else None), True
        else:
            idx, queries = self._draw()
            payload = None
            if generates:
                t_call, tp_call = time.perf_counter(), t.tracer.now_us()
                payload = t._rollout_body(queries, idx)
                t._note_generation(idx, t_call, tp_call, payload["timings"]["generate_s"])
            prefetched = False
        payload = t._sp_line_value(payload)
        t.state["rollouts"] = idx + 1
        return idx, payload, prefetched

    def prefetch(self) -> None:
        t = self._t
        idx, queries = self._draw()
        if t.mesh.sp_rank > 0:
            self._pending = (idx, None)  # the line's payload arrives at the fetch
            return
        tree = t._policy_snapshot()
        tp_call = t.tracer.now_us()

        def job():
            t0 = time.perf_counter()
            payload = t._rollout_body(queries, idx, tree)
            device_ready(payload)
            t._note_generation(idx, t0, tp_call, time.perf_counter() - t0)
            return payload

        self._pending = (idx, _Prefetch(job, t.device))

    @property
    def next_index(self) -> int:
        return self._pending[0] if self._pending is not None else self._idx

    def skip(self) -> int:
        """Consume the next data batch without generating it (a
        quarantined index); only with no prefetch pending."""
        assert self._pending is None
        t = self._t
        next(t._iter)
        idx = self._idx
        self._idx += 1
        t.state["rollouts"] = self._idx
        t.lineage.drop(idx, "sentinel_quarantine",
                       step=t.state["global_step"], dispatched=False)
        return idx

    def close(self) -> None:
        """Wait out a pending prefetch (its thread holds the card)."""
        if self._pending is not None:
            try:
                self._pending[1].result()
            except BaseException:  # noqa: BLE001 — abandoned with the stream
                pass
            self._pending = None


class RLTrainer:
    """The trainer on one device. Args mirror the JAX trainer's: config,
    model config, tokenizer, base params (the port's layout, on the device
    to train on), a dataset with `loader(batch, seed)` and `input_ids`,
    `reward_func(list[str], eos_token) -> scores`, and for PPO the value
    tree (`entrypoints/ppo.make_value_params`)."""

    def __init__(self, config: RLConfig, model_config, tokenizer, params: dict,
                 dataset, reward_func, value_params: dict | None = None):
        check_trainer_supported(config)
        # the mesh over the torch.distributed world: `_par` is what the
        # scoring and update passes read (None on one rank), `_sp` the ring
        self.mesh = make_mesh(config.mesh)
        self._sp = self.mesh if self.mesh.sp > 1 else None
        self._par = self.mesh if world_size() > 1 else None
        check_mesh_supported(config, self.mesh)
        self._sp_hops = (0, 0.0)  # the transport's hops and wait at the last row
        self._mesh_s: dict = {}  # the batch/fsdp transports' seconds at the last row
        if not self.mesh.writer:
            # metrics, checkpoints and the host planes write on rank 0 only
            config = dataclasses.replace(config, report_to="none", telemetry=False,
                                         lineage=False, status_port=0,
                                         profile_at_step=None)
        # the rollout source (built by train()) and the orchestrator
        # journal a resumed checkpoint carried
        self._orchestrator = self._stream = self._orch_restore_state = None
        # JAX's `_use_is` / `_use_seg`: static for the run, so the update's
        # minibatch key set never changes
        self._use_is = uses_truncated_is(config)
        self._use_seg = self._use_is and config.rollout_inflight_swaps
        self.cfg, self.mcfg = config, model_config
        self.tokenizer, self.reward_func, self.dataset = tokenizer, reward_func, dataset
        self._build_env(reward_func)
        self.device = params["embed_tokens"].device
        if config.total_episodes is None:
            config.total_episodes = int(config.num_train_epochs * len(dataset))
        config.finalize(world_size())
        if config.remat_policy != "full" and config.remat_policy != model_config.remat_policy:
            self.mcfg = dataclasses.replace(model_config, remat_policy=config.remat_policy)

        self.params, ref, self.lora_cfg, self.lora_scale = build_policy(
            config, self.mcfg, params)
        # fsdp: params (and below, the value tree) sharded at rest; the memo
        # keeps the ref's frozen base the policy's shards
        self._shard_memo: dict = {}
        # the MFU model's parameter count: the unsharded tree's
        self._flops_params = flops_param_count(self.params)
        if self.mesh.fsdp > 1:
            self.params = shard_params(self.params, self.mesh, self._shard_memo)
            ref = shard_params(ref, self.mesh, self._shard_memo)
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
        self._shard_memo.clear()  # releases the whole leaves
        groups = self._groups()
        for t in flatten(groups).values():
            t.requires_grad_(True)
        self.optimizer = build_optimizer(config, self._par)
        self.opt_state = self.optimizer.init(groups)
        # int8 rollout weights (core/quant.py): the frozen base quantized
        # once under LoRA; full fine-tuning re-quantizes at each rollout
        self._quant_layers = None
        if config.rollout_quant == "int8" and self.mesh.fsdp == 1:
            # (under fsdp each generate quantizes its gathered view)
            self._refresh_quant_layers()

        self._build_planes()
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
        # the latest compacting rollout's menu of batch sizes (None otherwise)
        self.last_compaction = None
        self.last_stats: list = []
        self.last_save_s = None
        # the latest paged rollout's pool snapshot and session status
        self.pages_status: dict | None = None
        self.session_status: dict | None = None
        # the radix prefix cache (rollout_prefix_cache, serving/radix.py):
        # one long-lived object, so its cumulative stats feed pages/shared
        # and /statusz "prefix_cache"; the scheduler resets its pool and
        # tree at every generate call (cached K/V is tied to the weights)
        self.prefix_cache = None
        if config.rollout_prefix_cache:
            from nanorlhf_tpu_torch.serving.radix import RadixCache
            self.prefix_cache = RadixCache()
        self._iter = dataset.loader(config.batch_size, config.seed)
        self.ctx_menu = shape_menu(dataset.input_ids.shape[1], min_value=16)

    def _build_env(self, reward_func) -> None:
        """`env_name` builds an `Environment` around `reward_func` (JAX
        trainer.py:647-697): a single-turn one unwraps back into a plain
        reward callable, a multi-turn one drives the rollout
        (`_env_multi_turn`, after JAX's ValueErrors on its config)."""
        self.env = None
        self._env_multi_turn = False
        if not self.cfg.env_name:
            return
        from nanorlhf_tpu_torch.envs import build_env

        self.env = build_env(self.cfg.env_name, reward_func,
                             max_turns=self.cfg.env_max_turns,
                             tool_timeout=self.cfg.env_tool_timeout,
                             eos_token=self.tokenizer.eos_token)
        if self.env.max_turns == 1:
            self.reward_func = self.env.as_reward_func()
        else:
            check_multi_turn_config(self.cfg)
            self._env_multi_turn = True

    def _build_planes(self) -> None:
        """The resilience layer, the telemetry planes, the checkpoint manager
        and the metrics logger, in the JAX trainer's order. A knob that
        cannot be honoured raises here (a port that will not bind, a
        tensorboard sink without tensorboard)."""
        config = self.cfg
        self.faults = FaultInjector.from_spec(config.fault_spec)
        self.sentinel = TrainingSentinel(SentinelConfig(
            enabled=config.sentinel,
            spike_zscore=config.sentinel_spike_zscore,
            ewma_alpha=config.sentinel_ewma_alpha,
            warmup_steps=config.sentinel_warmup_steps,
            rollback_budget=config.rollback_budget,
        ))
        # the jitter de-correlates replicas that share a seed: mix in the
        # process identity (one process, rank 0, here)
        self.watchdog = ProducerWatchdog(WatchdogConfig(
            restart_budget=config.producer_restart_budget,
            backoff_base=config.producer_backoff_base,
            backoff_max=config.producer_backoff_max,
            backoff_jitter=config.producer_backoff_jitter,
            degrade_to_sync=config.degrade_to_sync,
        ), seed=(config.seed << 20) ^ os.getpid())
        self._preemption = (PreemptionGuard() if config.graceful_preemption
                            else null_guard())
        try:
            self._build_observers()
        except BaseException:
            self._preemption.uninstall()  # a trainer that failed to build
            raise

    def _build_observers(self) -> None:
        """The telemetry planes, the checkpoint manager and the logger (the
        rest of `_build_planes`)."""
        config = self.cfg
        self.tracer = SpanTracer(enabled=config.telemetry,
                                 max_events=config.telemetry_max_events,
                                 ring_len=config.flight_recorder_len)
        self._telemetry_dir = config.telemetry_dir or config.output_dir
        # the analytic MFU model's inputs (telemetry/mfu.py)
        self._peak_flops, self._peak_flops_known = peak_flops_per_chip(self.device)
        self._n_devices = 1
        self._recompiles = recompile_counter()
        self.ckpt = CheckpointManager(config.output_dir, config.save_total_limit,
                                      config.greater_is_better,
                                      io_retries=config.ckpt_io_retries,
                                      retry_backoff=config.ckpt_retry_backoff,
                                      faults=self.faults, tracer=self.tracer)
        self.logger = MetricsLogger(config.output_dir, config.report_to)
        self.lineage = LineageLedger(
            self._telemetry_dir, enabled=config.lineage,
            sample_rate=config.lineage_sample_rate,
            key_path="stream_generator(seed, 0x5E11, rollout_index)")
        self.latency = LatencyHub(enabled=config.latency)
        self.health = HealthMonitor(
            HealthConfig(
                enabled=config.health, fast_alpha=config.health_fast_alpha,
                slow_alpha=config.health_slow_alpha,
                warmup=config.health_warmup_steps,
                window_s=config.health_window_s,
                max_events=config.health_max_events,
                blackbox_on_crit=config.health_blackbox_on_crit,
                rules=DEFAULT_RULES + (SLO_RULES if config.latency else ())),
            tracer=self.tracer, blackbox_fn=self._health_blackbox,
            on_crit=self._on_health_crit, latency=self.latency)
        self.exporter = StatusExporter(
            config.status_port, host=config.status_host,
            metrics_fn=self._export_metrics, health=self.health,
            statusz_fn=self._statusz, latency=self.latency)
        self.timer = PhaseTimer(tracer=self.tracer)
        self.profile_window = ProfileWindow(
            config.profile_dir or os.path.join(config.output_dir, "profile"),
            at_step=config.profile_at_step, num_steps=config.profile_num_steps,
            trigger_file=config.profile_trigger_file
            or os.path.join(config.output_dir, "PROFILE"))
        # rollout/train overlap over the trainer's lifetime
        self._rollout_meter = OverlapMeter()

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
        if self.mesh.fsdp > 1:
            self.value_params = shard_params(self.value_params, self.mesh,
                                             self._shard_memo)
        self.value_trainable = _trainable_leaves(
            self.value_params, value_trainable_mask(self.value_params,
                                                    self.value_lora_cfg))

    def _refresh_quant_layers(self) -> None:
        self._quant_layers = quantize_layers(self.params["layers"])

    def _rollout_params(self, tree: dict | None = None) -> dict:
        """The tree generation samples from: the live policy (or a published
        snapshot `tree`), with int8 base projections when `rollout_quant`
        is on (LoRA, embeddings and norms stay the tree's tensors). Under
        full fine-tuning the base moved since the last rollout, so it is
        quantized anew (a snapshot's own layers, for a snapshot). Under fsdp
        the live tree is gathered whole (the caller frees it after its
        generate) and int8 weights quantize that view."""
        if self.mesh.fsdp > 1:
            full = full_tree(self.params, self.mesh)
            if self.cfg.rollout_quant == "int8":
                return rollout_view(full, quantize_layers(full["layers"]))
            return full
        if self._quant_layers is None:
            return self.params if tree is None else tree
        if tree is not None:
            layers = (self._quant_layers if self.cfg.use_lora
                      else quantize_layers(tree["layers"]))
            return rollout_view(tree, layers)
        if not self.cfg.use_lora:
            self._refresh_quant_layers()
        return rollout_view(self.params, self._quant_layers)

    # ------------------------------------------------------------------ #
    # the async rollout sources
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _policy_snapshot(self) -> SnapshotTree:
        """An immutable view of the current policy for the weight store
        (JAX `_policy_snapshot`): every trainable leaf is CLONED — the
        optimizer steps those in place — and every frozen leaf aliases the
        live tensor, which nothing writes. The clones run on this thread's
        stream; `ready` is the event recorded after them, which a reader's
        stream waits on. Under LoRA the clone is the adapters and the
        embeddings."""
        mask = trainable_mask(self.params, self.lora_cfg)

        def walk(tree, m):
            return {k: walk(v, m[k]) if isinstance(v, dict)
                    else (v.detach().clone() if m[k] else v)
                    for k, v in tree.items()}

        snap = SnapshotTree(walk(self.params, mask))
        if self.device.type == "cuda":
            snap.ready = torch.cuda.Event()
            snap.ready.record(torch.cuda.current_stream(self.device))
        return snap

    def _frozen_leaf_ids(self) -> set:
        """The live tensors no update writes: the frozen policy leaves and
        the int8 base of a LoRA run."""
        mask = flatten(trainable_mask(self.params, self.lora_cfg))
        ids = {id(t) for path, t in flatten(self.params).items() if not mask[path]}
        if self._quant_layers is not None and self.cfg.use_lora:
            ids |= {id(t) for t in flatten(self._quant_layers).values()}
        return ids

    def _device_tree(self, tree: dict) -> tuple[dict, set]:
        """A published tree ready to read on this thread's stream: its copy
        event waited on, and leaves that crossed the RPC wire (host arrays)
        uploaded to the trainer's device. Returns (tree, ids of the uploaded
        leaves — tensors this dispatch alone holds)."""
        reader_wait(tree)
        uploaded: set = set()

        def walk(node):
            out = {}
            for k, v in node.items():
                if isinstance(v, dict):
                    out[k] = walk(v)
                elif isinstance(v, torch.Tensor) and v.device == self.device:
                    out[k] = v
                else:
                    out[k] = torch.as_tensor(v).to(self.device)
                    uploaded.add(id(out[k]))
            return out

        return walk(tree), uploaded

    def _rollout_body(self, queries: np.ndarray, index: int, tree: dict | None = None,
                      weight_refresh=None) -> dict:
        """Generate rollout `index` (JAX `rollout_body`): from the live tree
        on the trainer's thread, or from a published snapshot `tree` on a
        producer thread, with the index's generation stream, so WHICH thread
        or worker generates a sample never changes WHAT is generated.
        `weight_refresh` (in-flight swaps) polls the store between chunks;
        the dispatch tree then gets private copies of every leaf a publish
        can replace, because the swap writes into it in place."""
        cfg = self.cfg
        keep = set()
        if tree is not None:
            tree, keep = self._device_tree(tree)
        gen_params = self._rollout_params(tree)
        refresh = None
        if weight_refresh is not None:
            keep |= self._frozen_leaf_ids()

            def own(node):
                return {k: own(v) if isinstance(v, dict)
                        else (v if id(v) in keep else v.clone())
                        for k, v in node.items()}

            gen_params = own(gen_params)

            def refresh():
                version, fresh = weight_refresh()
                if fresh is None:
                    return version, None
                return version, self._rollout_params(self._device_tree(fresh)[0])
        on_trainer = tree is None
        return generate_rollout(
            gen_params, self.mcfg, cfg, self.tokenizer, queries,
            rollout_generator(cfg.seed, index, self.device, self.mesh.batch_rank),
            self.lora_scale, mesh=self._par,
            ctx_menu=self._gen_menu(), planes=self,
            # the trainer's radix cache keeps cumulative stats; a producer
            # thread takes a fresh one (the scheduler resets it per call)
            prefix_cache=self.prefix_cache if on_trainer else None,
            env=self.env if self._env_multi_turn else None,
            weight_refresh=refresh)

    def _gen_menu(self) -> list[int]:
        """The menu the rollout de-pads its prompts to."""
        return self.ctx_menu

    def _ensure_orchestrator(self):
        """Create (once) the rollout pipeline — the single producer thread
        (rollout_workers == 1) or the N-worker fleet — over published
        snapshots; it outlives train() calls and is torn down by close(),
        resume_from_checkpoint() and the watchdog (JAX
        `_ensure_orchestrator`)."""
        if self._orchestrator is not None:
            return self._orchestrator
        cfg = self.cfg
        common = dict(
            initial_params=self._policy_snapshot(), start_index=self.state["rollouts"],
            max_staleness=cfg.max_staleness, policy=cfg.staleness_policy,
            meter=self._rollout_meter, restore=self._orch_restore_state,
            heartbeat=cfg.producer_heartbeat, faults=self.faults, tracer=self.tracer,
            lineage=self.lineage, latency=self.latency, device=self.device)
        if cfg.rollout_workers > 1:
            from nanorlhf_tpu_torch.orchestrator.fleet import FleetConfig, FleetOrchestrator

            rpc_cfg = None
            if cfg.rollout_transport == "rpc":
                from nanorlhf_tpu_torch.orchestrator.rpc import RpcConfig

                rpc_cfg = RpcConfig(host=cfg.fleet_rpc_host, port=cfg.fleet_rpc_port,
                                    call_timeout=cfg.fleet_rpc_timeout,
                                    attempts=cfg.fleet_rpc_attempts,
                                    backoff_base=cfg.fleet_rpc_backoff_base)

            def batch_fn():
                # the COORDINATOR is the sole consumer of the data iterator
                # (under its lock, in index order); a reassigned lease
                # replays its cached batches
                return np.asarray(next(self._iter))

            def fleet_dispatch(index, queries, tree, worker_id, weight_refresh=None):
                return self._rollout_body(queries, index, tree, weight_refresh)

            self._orchestrator = FleetOrchestrator(
                dispatch_fn=fleet_dispatch, batch_fn=batch_fn,
                n_workers=cfg.rollout_workers,
                fleet=FleetConfig(
                    lease_size=cfg.fleet_lease_size,
                    failure_budget=cfg.fleet_failure_budget,
                    quarantine_base=cfg.fleet_quarantine_base,
                    quarantine_max=cfg.fleet_quarantine_max,
                    backoff_jitter=cfg.fleet_backoff_jitter,
                    straggler_factor=cfg.fleet_straggler_factor,
                    initial_deadline_s=cfg.fleet_initial_deadline,
                    worker_timeout_s=cfg.fleet_initial_deadline, seed=cfg.seed),
                transport=cfg.rollout_transport, rpc=rpc_cfg,
                inflight_swaps=cfg.rollout_inflight_swaps, **common)
        else:
            from nanorlhf_tpu_torch.orchestrator.orchestrator import RolloutOrchestrator

            def dispatch(index, tree, weight_refresh=None):
                # the producer is the SOLE consumer of the data iterator
                queries = np.asarray(next(self._iter))
                return self._rollout_body(queries, index, tree, weight_refresh)

            self._orchestrator = RolloutOrchestrator(
                dispatch_fn=dispatch, inflight_swaps=cfg.rollout_inflight_swaps, **common)
        self._orch_restore_state = None
        return self._orchestrator

    def _close_orchestrator(self, keep_journal: bool) -> None:
        orch, self._orchestrator = self._orchestrator, None
        if orch is not None:
            if keep_journal:
                self._orch_restore_state = orch.journal()
            orch.close(join_timeout=5.0 if keep_journal else 30.0)

    def _reset_data_iterator(self) -> None:
        """Rebuild the deterministic loader at the consumed-rollout cursor
        (resume, producer restart, degraded fallback: anything a dead or
        closed producer drew past the cursor is drawn again)."""
        self._iter = self.dataset.loader(self.cfg.batch_size, self.cfg.seed)
        for _ in range(self.state["rollouts"]):
            next(self._iter)

    def _close_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def rollout_overlap_frac(self) -> float:
        """Cumulative rollout/train overlap fraction (every mode)."""
        return self._rollout_meter.overlap_fraction()

    def _fetch_sample(self, use_orch: bool) -> dict:
        """One finished rollout, supervised (JAX `fetch_sample`): a dead
        producer is restarted with backoff up to the watchdog budget, then
        the run degrades to synchronous rollouts; quarantined indices are
        skipped before dispatch, or discarded when a producer already made
        them. Returns {index, payload, prefetched, staleness, queue_depth,
        version}."""
        while True:
            if use_orch:
                orch = self._ensure_orchestrator()
                try:
                    sample = orch.get()
                except ProducerFailed as e:
                    extra = {"error": repr(e.__cause__ or e)}
                    if hasattr(orch, "fleet_stats"):
                        extra["fleet"] = orch.fleet_stats()
                    self.tracer.dump_blackbox(self._telemetry_dir,
                                              self.state["global_step"],
                                              "producer_failure", extra=extra)
                    decision, delay = self.watchdog.on_failure()
                    if decision == ProducerWatchdog.RESTART:
                        cause = e.__cause__ or e
                        print(f"[resilience] rollout producer died "
                              f"({type(cause).__name__}: {cause}) — restart "
                              f"{self.watchdog.restarts_total} in {delay:.1f}s")
                        time.sleep(delay)
                        self._close_orchestrator(keep_journal=True)
                        self._reset_data_iterator()
                        continue
                    if decision == ProducerWatchdog.DEGRADE:
                        print("[resilience] producer restart budget "
                              f"({self.cfg.producer_restart_budget}) exhausted — "
                              "degrading to synchronous rollouts (staleness 0)")
                        self._close_orchestrator(keep_journal=True)
                        self._reset_data_iterator()
                        use_orch = False
                        continue
                    raise
                self.watchdog.on_success()
                got = {"index": sample.index, "payload": sample.payload,
                       "prefetched": True, "staleness": orch.version - sample.version,
                       "queue_depth": orch.queue.depth(), "version": sample.version}
                self.state["rollouts"] = sample.index + 1
            else:
                if self._stream is None:
                    self._stream = RolloutStream(self)
                stream = self._stream
                while (stream._pending is None
                       and stream.next_index in self.sentinel.quarantined):
                    idx = stream.skip()
                    print(f"[resilience] skipping quarantined rollout {idx} "
                          "(sentinel rollback; not dispatched)")
                idx, payload, prefetched = stream.fetch_or_dispatch()
                got = {"index": idx, "payload": payload, "prefetched": prefetched,
                       "staleness": 0, "queue_depth": 0,
                       "version": self.state["global_step"]}
            if got["index"] in self.sentinel.quarantined:
                # already generated (the pipeline or a prefetch): discard it;
                # the producer gate gets a skip credit
                print(f"[resilience] skipping quarantined rollout {got['index']} "
                      "(sentinel rollback)")
                self.lineage.drop(got["index"], "sentinel_quarantine",
                                  step=self.state["global_step"], dispatched=True)
                if use_orch:
                    self._orchestrator.consumed_without_update()
                continue
            return got


    # ------------------------------------------------------------------ #
    # sequence parallelism (JAX trainer.py:1503-1527)
    # ------------------------------------------------------------------ #

    def _sp_on(self) -> bool:
        return self._sp is not None

    def _sp_check_widths(self, context_length: int) -> None:
        """The sequence dim shards evenly over the sp ring: the context and
        response widths must divide by sp (JAX's ValueError)."""
        n_sp = self.mesh.sp
        for name, width in (("context", context_length),
                            ("response_length", self.cfg.response_length)):
            if width % n_sp != 0:
                raise ValueError(
                    f"{name} width {width} not divisible by sp={n_sp}; pick "
                    f"prompt/response widths as multiples of sp")

    def _sp_agree_rollout(self, *arrays) -> None:
        """Every rank holds rank 0's rollout and graded it itself: hold a
        digest of its arrays (query-responses, rewards) against every
        other rank's; a rank that differs fails the step on every rank."""
        if self._sp is None:
            return
        h = hashlib.sha1()
        for a in arrays:
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype, a.shape)).encode() + a.tobytes())
        digests = self._sp.transport.all_gather_object(h.hexdigest())
        if len(set(digests)) != 1:
            raise RuntimeError(f"sp ranks generated different rollouts (digests by "
                               f"rank {digests}): the ring would train on mixed data")

    def _sp_line_value(self, value):
        """The value of this sp line's first rank on every rank of the line
        (a collective under sp)."""
        if self._sp is None:
            return value
        return self._sp.transport.all_gather_object(value)[0]

    def _rank0_value(self, value):
        """Rank 0's `value` on every rank (a collective over the world)."""
        if self._par is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, 0)
        return box[0]

    def _sp_metrics(self) -> dict:
        """The sp transport's rows: the group's size, the backend (gloo or
        NCCL; host staging of CUDA tensors under gloo) and this update's
        ring hops and the seconds spent waiting for them."""
        if self._sp is None:
            return {}
        tr = self._sp.transport
        hops, hop_s = tr.hops - self._sp_hops[0], tr.hop_s - self._sp_hops[1]
        self._sp_hops = (tr.hops, tr.hop_s)
        return {"sp/size": float(self.mesh.sp),
                "sp/backend_nccl": float(tr.backend == "nccl"),
                "sp/host_staged": float(tr.backend != "nccl" and self.device.type == "cuda"),
                "sp/hops": float(hops), "sp/hop_wait_s": hop_s}

    def _mesh_metrics(self) -> dict:
        """The batch and fsdp lines' rows: their sizes and this update's
        seconds in each transport's collectives (`Transport.op_s`: the
        gathers, the reduce-scatters and the gradient all-reduces, host
        staging included)."""
        m = self.mesh
        if m.batch == 1:
            return {}
        out = {"mesh/data": float(m.data), "mesh/fsdp": float(m.fsdp)}
        lines = {"data": m.data_transport, "fsdp": m.fsdp_transport}
        if m.batch_transport not in lines.values():
            lines["batch"] = m.batch_transport
        for name, tr in lines.items():
            if tr is None:
                continue
            for op, sec in tr.op_s.items():
                key = f"mesh/{name}_{op}_s"
                out[key] = sec - self._mesh_s.get(key, 0.0)
                self._mesh_s[key] = sec
        return out

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
                    value=self.value_params, value_lora_scale=self.value_lora_scale,
                    mesh=self._par)
                self.state["opt_steps"] += 1
                all_stats.append(stats)
        return all_stats

    def _note_generation(self, index: int, t_call: float, tp_call: float,
                         gen_s: float) -> None:
        """A rollout generated outside the orchestrator (which notes its
        own): its window into the overlap meter and, as a
        `rollout.generate` async span, the trace."""
        self._rollout_meter.note_gen(t_call, t_call + gen_s)
        self.tracer.add_async("rollout.generate", tp_call, gen_s * 1e6, aid=index,
                              track="rollout", rollout_index=index)

    def _note_payload(self, payload: dict, index: int, orchestrated: bool) -> None:
        """A fetched rollout's provenance: the lineage `generation` event
        (the orchestrator's producer emits its own), one mid-loop `lease`
        event per queued admission, the paged snapshot."""
        if self.lineage.enabled:
            if not orchestrated:
                self.lineage.generation(
                    index, policy_version=self.state["global_step"], worker_id=0,
                    spec=spec_summary(payload), segments=segments_summary(payload),
                    swap_wait_s=payload.get("swap_wait_s"))
            for adm in (payload.get("paged_stats") or {}).get("admissions") or []:
                self.lineage.event("lease", index, midloop=True, row=adm["row"],
                                   queue_index=adm["queue_index"],
                                   iteration=adm["iteration"])
        self._snapshot_pages(payload.get("paged_stats"))

    def _preempt_requested(self) -> bool:
        """SIGTERM's flag at an update boundary, agreed over the world:
        a signal on any rank stops every rank at the same step (under fsdp
        the emergency save gathers the leaves, a collective)."""
        return any_rank(self._preemption.triggered)

    def _preempt(self, saved: bool, metrics: dict) -> None:
        """At an update boundary after SIGTERM: commit an emergency
        checkpoint (unless this step saved one), flush the writer, dump the
        flight recorder and the trace, raise `Preempted`."""
        if not saved:
            self.save_checkpoint(metrics)
        self.ckpt.wait()
        self.tracer.dump_blackbox(self._telemetry_dir, self.state["global_step"],
                                  "preemption")
        self._write_trace()
        raise Preempted(
            f"SIGTERM at step {self.state['global_step']}: emergency "
            f"checkpoint committed to {self.cfg.output_dir}")

    def train(self, num_updates: int | None = None) -> dict:
        cfg, tok = self.cfg, self.tokenizer
        pad_id, eos_id = tok.pad_token_id, tok.eos_token_id
        stop_id = eos_id if cfg.stop_token == "eos" else None
        n = cfg.sample_n if cfg.algo in (AlgoName.GRPO, AlgoName.RLOO,
                                          AlgoName.RAFT) else 1
        n_updates = (max(0, cfg.num_total_batches - self.state["global_step"])
                     if num_updates is None else num_updates)
        self.lineage.rows_hint = cfg.batch_size * n
        target_step = self.state["global_step"] + n_updates
        try:
            while self.state["global_step"] < target_step:
                self._train_step(n, stop_id, pad_id, eos_id, target_step)
        finally:
            # a rollout_ahead prefetch lives inside one train() call (the
            # orchestrator's pipeline outlives it)
            self._close_stream()
        # train() returning means every checkpoint is durable: the final
        # write's failure raises here
        self.ckpt.wait()
        self.profile_window.stop()
        self._write_trace()
        if cfg.load_best_model_at_end and num_updates is None:
            best = self._rank0_value(self.ckpt.best_step())
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

    def _train_step(self, n: int, stop_id, pad_id: int, eos_id: int,
                    target_step: int) -> None:
        """One update: fetch a rollout (generated here, prefetched, or from
        the orchestrator), score it, update, publish, log, save."""
        cfg, tok = self.cfg, self.tokenizer
        t_start = time.perf_counter()
        # the profile window for the update about to run, and its span
        # (recorded at the end: a with-block could not survive the
        # rollback's early return)
        self.profile_window.poll(self.state["global_step"] + 1)
        span_t0 = self.tracer.now_us() if self.tracer.enabled else 0.0
        use_orch = cfg.rollout_orchestrator and not self.watchdog.degraded
        counts0 = launch_counts()
        with self.timer.phase("rollout"):
            got = self._fetch_sample(use_orch)
        use_orch = use_orch and not self.watchdog.degraded
        index, payload = got["index"], got["payload"]
        staleness = got["staleness"]
        t: dict = dict(payload["timings"])
        t["fetch_s"] = time.perf_counter() - t_start
        t_busy0 = time.perf_counter()
        self._note_payload(payload, index, orchestrated=use_orch)
        self.last_compaction = payload.get("compaction_stats")
        self.state["episode"] += cfg.batch_size
        if (not use_orch and cfg.rollout_ahead
                and self.state["global_step"] + 1 < target_step):
            # rollout k+1 generates NOW, from the pre-update-k weights, on a
            # producer thread, while this thread grades, scores and updates
            self._stream.prefetch()
        counts1 = launch_counts()
        if self._sp_on():
            self._sp_check_widths(payload["queries"].shape[1])
        # GRPO draws its keep in the scoring half, RLOO and RAFT ("random")
        # theirs in the batch assembly: one stream an update
        keep_gen = stream_generator(cfg.seed, KEEP_STREAM, index)
        ro = score_rollout(
            payload, self.params, self.ref_params, self.mcfg, cfg, tok,
            self.reward_func, self.lora_scale, keep_gen, timings=t, planes=self,
            rollout_index=index, step=self.state["global_step"],
            use_is=self._use_is, use_seg=self._use_seg, mesh=self._par)
        self._sp_agree_rollout(payload["queries"], payload["responses"], ro["scores"])
        if ro["keep"] is not None and n > 1:
            # the other n−1 completions per prompt left the batch
            self.lineage.drop(index, "keep_filter",
                              count=len(ro["keep"]) * (n - 1),
                              step=self.state["global_step"])
        context_length = ro["context_length"]
        t0 = time.perf_counter()
        counts_v = launch_counts()
        batch, info = assemble_batch(
            ro, cfg, stop_id, pad_id, eos_id, keep_generator=keep_gen,
            value_fn=lambda qr: value_pass(self.value_params, self.mcfg, qr,
                                           context_length, pad_id,
                                           self.value_lora_scale, mesh=self._par))
        t["assemble_s"] = time.perf_counter() - t0
        if cfg.algo in (AlgoName.RLOO, AlgoName.RAFT):
            self.lineage.drop(index, "keep_filter",
                              count=len(info["keep"]) * (n - 1),
                              step=self.state["global_step"])

        t0 = time.perf_counter()
        counts_u = launch_counts()
        lr_step = self.state["opt_steps"]
        with self.timer.phase("update"):
            all_stats = self._update(batch, context_length)
        t["update_s"] = time.perf_counter() - t0
        counts2 = launch_counts()
        # under a producer thread the counters also take its concurrent
        # launches: the process's launches in each window
        self.last_launches = {
            "rollout_and_score": {k: counts_v[k] - counts0[k] for k in counts0},
            "generate": {k: counts1[k] - counts0[k] for k in counts0},
            "score": {k: counts_v[k] - counts1[k] for k in counts0},
            "value": {k: counts_u[k] - counts_v[k] for k in counts0},
            "update": {k: counts2[k] - counts_u[k] for k in counts0}}
        self.last_timings, self.last_stats = t, all_stats
        agg = {k: float(np.mean([s[k] for s in all_stats]))
               for k in (all_stats[0] if all_stats else {})}
        version = (self._orchestrator.version if use_orch
                   else self.state["global_step"])

        # ---- the sentinel, before the publish: a tripped update never
        # feeds poisoned weights to the producer. `update.step` poisons the
        # observed stats (action=nan), the path a real NaN loss takes
        if self.faults.fire("update.step") == "nan":
            agg["pg_loss"] = float("nan")
            agg["grad_norm"] = float("nan")
        verdict = self.sentinel.observe(agg.get("pg_loss", 0.0), agg.get("grad_norm"))
        if verdict is not None:
            # the tripped update's span closes BEFORE the rollback dumps the
            # flight recorder, tagged with the quarantined index
            self.tracer.add_complete(
                "train.update", span_t0, self.tracer.now_us() - span_t0,
                step=self.state["global_step"] + 1, rollout_index=index,
                staleness=staleness, policy_version=version,
                sentinel_verdict=verdict, quarantined=True)
            self._sentinel_rollback(verdict, index)
            # drop the tripped update's phase splits
            self.timer.summary()
            return
        if use_orch:
            # one version per optimizer update: snapshot the trainable
            # leaves and open the producer's gate
            with self.timer.phase("publish"):
                self._orchestrator.publish(self._policy_snapshot())

        metrics = self._metrics(ro, batch, info, agg, all_stats, lr_step, t,
                                t_start, context_length)
        metrics.update(self._pipeline_metrics(ro, agg, staleness, got["queue_depth"],
                                              use_orch))
        metrics.update(self._host_metrics(t_start, n, context_length, ro, batch))
        metrics.update(self._sp_metrics())
        metrics.update(self._mesh_metrics())
        self.state["global_step"] += 1
        step = self.state["global_step"]
        version = self._orchestrator.version if use_orch else step
        # the health plane folds this row in; its gauges ride along
        metrics.update(self.health.observe(step, metrics))
        keep = info["keep"]
        kept = batch["responses"]
        scores = ro["scores"] if keep is None else ro["scores"].reshape(
            -1, cfg.sample_n)[np.arange(kept.shape[0]), keep]
        kept_decoded = tok.batch_decode(kept)
        if self.lineage.enabled:
            self._lineage_outcome(index, batch, info, scores, kept_decoded,
                                  version=version, staleness=staleness)
            if self._use_is and agg.get("is_trunc_frac", 0.0) > 0:
                # truncated-IS rows stay IN the update with a capped weight:
                # attributed, not excluded
                n_trunc = int(round(agg["is_trunc_frac"] * kept.shape[0]))
                if n_trunc:
                    self.lineage.drop(index, "is_truncated_weight", count=n_trunc,
                                      step=step, partial=True)
        if step % cfg.logging_steps == 0:
            self.logger.log(step, self.state["episode"], metrics)
            queries_dec = [q.replace(tok.pad_token, "")
                           for q in tok.batch_decode(ro["queries"])]
            if keep is None:
                queries_dec = [q for q in queries_dec for _ in range(cfg.sample_n)]
            limit = (cfg.log_samples_limit if cfg.log_samples_limit is not None
                     else cfg.num_printed_samples)
            self.logger.log_samples(step, queries_dec, kept_decoded, scores, limit)
            if self.lineage.enabled:
                for i, (q, r, sc) in enumerate(zip(queries_dec, kept_decoded,
                                                   np.asarray(scores).tolist())):
                    if i >= limit:
                        break
                    self.lineage.event("sample", index, step=step, row=i,
                                       query=q, response=r,
                                       score=round(float(sc), 6))
        saved = False
        if cfg.save_steps and step % cfg.save_steps == 0:
            t0 = time.perf_counter()
            self.save_checkpoint(metrics)
            self.last_save_s = time.perf_counter() - t0
            saved = True
        # the consumer's busy window: everything since the sample arrived
        self._rollout_meter.note_busy(t_busy0, time.perf_counter())
        if self.tracer.enabled:
            self.tracer.add_complete(
                "train.update", span_t0, self.tracer.now_us() - span_t0,
                step=step, rollout_index=index, staleness=staleness,
                policy_version=version)
            self.tracer.counter("staleness", staleness)
        # SIGTERM is polled here, where the state is consistent
        if self._preempt_requested():
            self._preempt(saved, metrics)

    def _pipeline_metrics(self, ro: dict, agg: dict, staleness: int,
                          queue_depth: int, use_orch: bool) -> dict:
        """The async pipeline's rows (JAX trainer.py:2400-2470):
        `orchestrator/*` and the staleness histogram, `fleet/*`,
        `offpolicy/*` under truncated IS, the in-flight swaps' rows, and
        `sampler_capture/ratio_drift_new` when captured logprobs stood for
        the policy's."""
        cfg = self.cfg
        out: dict = {}
        if ro.get("score_capture"):
            # exact scoring gives an epoch-1 ratio of 1: any drift is decode
            # vs scoring numerics
            out["sampler_capture/ratio_drift_new"] = abs(agg.get("ratio_mean", 1.0) - 1.0)
        if use_orch:
            orch = self._orchestrator
            ostats = orch.stats()
            out.update({
                "orchestrator/queue_depth": float(queue_depth),
                "orchestrator/staleness": float(staleness),
                "orchestrator/dropped_total": float(ostats["dropped"]),
                "orchestrator/consumer_wait_s": ostats["consumer_wait_s"],
                "orchestrator/producer_gate_wait_s": ostats["producer_gate_wait_s"],
            })
            out.update(staleness_histogram_metrics(ostats["staleness_counts"]))
            if hasattr(orch, "fleet_stats"):
                out.update({f"fleet/{k}": v for k, v in orch.fleet_stats().items()})
        if self._use_is:
            out["offpolicy/is_weight_mean_new"] = agg.get("is_weight_mean", 1.0)
            out["offpolicy/is_trunc_frac_new"] = agg.get("is_trunc_frac", 0.0)
        if cfg.rollout_inflight_swaps:
            segs = ro.get("segments")
            out.update({
                "rollout/swap_installs": float(ro.get("swap_installs", 0) or 0),
                "rollout/segments_per_sample": (float(np.mean([len(x) for x in segs]))
                                                if segs else 1.0),
                "orchestrator/swap_wait_s": float(ro.get("swap_wait_s", 0.0) or 0.0),
            })
        return out

    def _host_metrics(self, t_start: float, n: int, context_length: int,
                      ro: dict, batch: dict) -> dict:
        """The rows the host planes add to an update's metrics, as JAX's
        loop does: the overlap fraction, the resilience counters,
        `perf/*` (`_perf_metrics`), the phase splits (`time/*_s`, which also
        feed the `latency/phase_*_s` histograms)."""
        cfg = self.cfg
        local_bs, t_resp = batch["responses"].shape
        n_rollout_rows = ro["queries"].shape[0] * n
        capture = bool(ro.get("score_capture"))
        score_forwards = (0 if self._ref_free and capture
                          else 1 if self._ref_free or capture else 2)
        out = {
            "time/rollout_overlap_frac": self._rollout_meter.overlap_fraction(),
            "resilience/producer_restarts": float(self.watchdog.restarts_total),
            "resilience/rollbacks": float(self.sentinel.rollbacks),
            "resilience/degraded_mode": float(self.watchdog.degraded),
            "resilience/ckpt_retries": float(self.ckpt.retry_count),
            "resilience/ckpt_fallbacks": float(self.ckpt.fallback_count),
        }
        out.update(self._perf_metrics(
            step_wall_s=time.perf_counter() - t_start,
            decode_tokens=n_rollout_rows * cfg.response_length,
            prefill_tokens=n_rollout_rows * context_length,
            score_tokens=score_forwards * ro["responses"].shape[0]
            * (context_length + cfg.response_length),
            train_tokens=cfg.num_ppo_epochs * local_bs * (context_length + t_resp),
            rollout_s=self.timer.totals.get("rollout", 0.0),
            update_s=self.timer.totals.get("update", 0.0)))
        phase_rows = self.timer.summary()
        out.update(phase_rows)
        self._record_phases(phase_rows)
        return out

    def _record_phases(self, phase_rows: dict) -> None:
        """Every update's phase seconds into the `latency/phase_*_s`
        histograms ("time/rollout_s" → "latency/phase_rollout_s")."""
        if self.latency.enabled:
            for k, v in phase_rows.items():
                if k.startswith("time/") and k.endswith("_s"):
                    self.latency.record(f"latency/phase_{k[5:-2]}_s", float(v))

    def _lineage_outcome(self, index: int, batch: dict, info: dict, scores,
                         decoded: list[str], version: int | None = None,
                         staleness: int = 0) -> None:
        """The `outcome` event that closes an index's chain, and the first
        rows' `note_sample` records."""
        step = self.state["global_step"]
        version = step if version is None else version
        adv = np.asarray(batch.get("advantages", batch.get("advantages_seq", scores)),
                         dtype=np.float32)
        if adv.ndim > 1:
            adv = adv.mean(axis=tuple(range(1, adv.ndim)))
        contain_eos = (info["post"] == self.tokenizer.eos_token_id).any(axis=1)
        self.lineage.outcome(
            index, step=step, policy_version=version,
            kept=int(batch["responses"].shape[0]),
            advantage=round(float(adv.mean()), 6),
            scores=[round(float(x), 6) for x in np.asarray(scores).tolist()],
            eos_frac=round(float(contain_eos.mean()), 4), staleness=staleness)
        for i, sc in enumerate(np.asarray(scores).tolist()[:8]):
            self.lineage.note_sample(
                index, step=step, score=round(float(sc), 6),
                response_chars=len(decoded[i]) if i < len(decoded) else None,
                kept=True)

    def _perf_metrics(self, *, step_wall_s: float, decode_tokens: float,
                      prefill_tokens: float, score_tokens: float,
                      train_tokens: float, rollout_s: float,
                      update_s: float) -> dict:
        """`perf/*` rows from the analytic model of `telemetry/mfu.py`
        (JAX `_perf_metrics`): MFU against the card's peak
        (`perf/peak_flops_known` 0 when the peak is a fallback), tokens per
        second of the step, the update and the rollout, the model FLOPs, the
        cumulative kernel builds (`perf/recompiles`, seconds) and the spans
        the tracer dropped."""
        flops = update_flops(self._flops_params, decode_tokens=decode_tokens,
                             prefill_tokens=prefill_tokens,
                             score_tokens=score_tokens, train_tokens=train_tokens)
        all_tokens = decode_tokens + prefill_tokens + score_tokens + train_tokens
        return {
            "perf/mfu": flops / max(step_wall_s, 1e-9)
            / (self._peak_flops * self._n_devices),
            "perf/peak_flops_known": 1.0 if self._peak_flops_known else 0.0,
            "perf/tokens_per_sec_step": all_tokens / max(step_wall_s, 1e-9),
            "perf/tokens_per_sec_update": train_tokens / max(update_s, 1e-9),
            "perf/tokens_per_sec_rollout": (decode_tokens + prefill_tokens)
            / max(rollout_s, 1e-9),
            "perf/model_flops_per_step": flops,
            "perf/recompiles": float(self._recompiles.count),
            "perf/recompile_seconds": self._recompiles.seconds,
            "telemetry/spans_dropped": float(self.tracer.dropped),
        }

    # ------------------------------------------------------------------ #
    # the health plane, the exporter, the trace, the rollback
    # ------------------------------------------------------------------ #

    def _health_blackbox(self, step: int, extra: dict):
        """CRIT hook: the flight recorder with reason "health" (None when
        the tracer is off)."""
        return self.tracer.dump_blackbox(self._telemetry_dir, step, "health",
                                         extra=extra)

    def _on_health_crit(self, step: int, rules: list):
        """A CRIT verdict arms the sentinel when it was off and
        `health_arm_sentinel` asks for it."""
        if self.cfg.health_arm_sentinel and not self.sentinel.cfg.enabled:
            self.sentinel.cfg.enabled = True
            print(f"[health] CRIT at step {step} ({', '.join(rules)}): "
                  "arming training sentinel")

    def _statusz(self) -> dict:
        """/statusz (on the exporter's threads: everything read here is
        immutable after __init__ or behind its own lock)."""
        latest = self.logger.latest()
        orch = self._orchestrator  # local ref: the trainer may close it
        out = {
            "unix_time": time.time(),
            "algo": self.cfg.algo.value,
            "step": self.state.get("global_step", 0),
            "episode": self.state.get("episode", 0),
            "policy_version": (orch.version if orch is not None
                               else self.state.get("global_step", 0)),
            "devices": self._n_devices,
            "mfu": latest.get("perf/mfu"),
            "mfu_trusted": bool(self._peak_flops_known),
            "peak_flops_per_chip": self._peak_flops,
            "staleness_avg": latest.get("orchestrator/staleness"),
            "health": self.health.snapshot(),
            "lineage": self.lineage.statusz(),
            "latency": self.latency.snapshot(),
            "pages": self.pages_status,
            "prefix_cache": (self.prefix_cache.snapshot()
                             if self.prefix_cache is not None else None),
            "session": self.session_status,
        }
        if orch is not None:
            out.update(orch.status_snapshot())
        return out

    def _export_metrics(self) -> dict:
        """/metrics: the latest metric row and the ledger's drop gauges."""
        return {**self.logger.latest(), **self.lineage.metric_rows()}

    def _write_trace(self):
        """Rewrite `<telemetry_dir>/trace.json` from the whole span buffer
        (nothing when telemetry is off)."""
        path = self.tracer.write_trace(os.path.join(self._telemetry_dir, "trace.json"))
        if path is not None:
            print(f"[telemetry] trace written: {path}")
        return path

    def _sentinel_rollback(self, verdict: str, rollout_index: int) -> None:
        """A sentinel trip: the flight recorder first, then charge the
        budget (raises when spent), quarantine the index and restore the
        last committed checkpoint through `resume_from_checkpoint`; the
        trip's accounting (and the watchdog's) survive the restore, the
        EWMA statistics rewind with it."""
        step_attempted = self.state["global_step"] + 1
        last = self.ckpt.latest_step()
        print(f"[resilience] sentinel tripped ({verdict}) at step "
              f"{step_attempted} (rollout {rollout_index}) — rolling back to "
              f"checkpoint {last}")
        self.tracer.instant("sentinel.trip", verdict=verdict,
                            rollout_index=rollout_index, step=step_attempted)
        self.tracer.dump_blackbox(
            self._telemetry_dir, step_attempted, "sentinel_trip",
            extra={"verdict": verdict, "rollout_index": int(rollout_index),
                   "rollback_to_step": last})
        if last is None:
            raise RuntimeError(
                f"sentinel tripped ({verdict}) at step {step_attempted} with "
                "no committed checkpoint to roll back to — enable save_steps "
                "or disable cfg.sentinel")
        self.sentinel.note_rollback(step_attempted, rollout_index, verdict)
        keep_sentinel = self.sentinel.journal()
        keep_watchdog = self.watchdog.journal()
        self.sentinel.steps, self.sentinel.ewma, self.sentinel.var = 0, 0.0, 0.0
        self.resume_from_checkpoint(last)
        self.sentinel.restore_accounting(keep_sentinel)
        self.watchdog.restore(keep_watchdog)
        self.logger.log_event(rollout_index, {
            "resilience/rollback": 1.0,
            "resilience/rollback_to_step": float(last),
            "resilience/rollbacks": float(self.sentinel.rollbacks),
        })

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
        }
        if "vf_loss" in agg:
            metrics["loss/value_avg_new"] = agg["vf_loss"]
            metrics["val/clipfrac_avg_new"] = agg.get("vf_clipfrac", 0.0)
        metrics.update(self._paged_metrics(ro.get("paged_stats")))
        metrics.update(self._spec_decode_metrics(ro.get("spec_stats")))
        if "env" in ro:
            metrics.update(ro["env"]["stats"])
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
        (admission forwards + decode iterations), chunked_admissions and
        prefill_backlog (the peak backlog of chunked prefill), and under the
        radix prefix cache rollout/prefix_hit_frac and pages/shared. {} when
        the rollout is not paged."""
        if paged_stats is None:
            return {}
        out = {
            "rollout/page_utilization": float(paged_stats["page_utilization"]),
            "rollout/pages_recycled": float(paged_stats["pages_recycled"]),
            "rollout/admitted_midloop": float(paged_stats["admitted_midloop"]),
        }
        if "prefix_hit_frac" in paged_stats:
            out["rollout/prefix_hit_frac"] = float(paged_stats["prefix_hit_frac"])
            out["pages/shared"] = float(paged_stats["shared_pages"])
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
        optimizer state when `save_optimizer_state`. The leaves are the
        unsharded ones: under fsdp every rank takes part in gathering them.
        Only rank 0 writes (the others return None)."""
        cfg = self.cfg
        opt = None
        if cfg.save_optimizer_state:
            opt = {g: {"count": st.count, "mu": self._whole(st.mu, g),
                       "nu": self._whole(st.nu, g)}
                   for g, st in self.opt_state.items()}
        value = (self._whole(self.value_trainable, "value")
                 if cfg.save_value_model and self.value_trainable is not None else None)
        trainable = self._whole(self.trainable, "policy")
        if not self.mesh.writer:
            return None
        metrics = metrics or {}
        extra = {k: self.state[k] for k in ("episode", "opt_steps", "rollouts")}
        # the planes' journals: recovery itself resumes (rollback spend,
        # quarantine, restart counters), and so do the health baselines,
        # the ledger's event index and the latency histograms
        extra.update(
            resilience={"sentinel": self.sentinel.journal(),
                        "watchdog": self.watchdog.journal()},
            health=self.health.journal(), lineage=self.lineage.journal(),
            latency=self.latency.journal())
        # the orchestrator's queue (pending indices, cumulative drop and
        # staleness counters, the fleet's): a resume draws the pending
        # samples again from the rollout cursor; in degraded mode the closed
        # pipeline's counters stay journaled
        orch = self._orchestrator
        journal = orch.journal() if orch is not None else self._orch_restore_state
        if journal is not None:
            extra["orchestrator"] = journal
        return self.ckpt.save(
            self.state["global_step"], trainable, opt_state=opt,
            metric_old=metrics.get(cfg.metric_for_best_model),
            extra_state=extra, value=value)

    def _whole(self, tree: dict, group: str) -> dict:
        """A trainable-shaped tree (leaves or moments) of `group` with its
        fsdp shards gathered whole (the tree itself without fsdp)."""
        return full_tree(tree, self._par, (group,))

    @torch.no_grad()
    def _load_trainable(self, tree: dict) -> None:
        """Copy a checkpoint tree's `params` (and `value`) into the live
        trainable leaves (this rank's shard of each whole leaf)."""
        for key, live_tree in (("params", self.trainable), ("value", self.value_trainable)):
            if key not in tree:
                continue
            live = flatten(live_tree)
            for path, t in flatten(tree[key]).items():
                live[path].copy_(shard_of(t, path, self._par))

    @torch.no_grad()
    def resume_from_checkpoint(self, step: int | None = None) -> dict:
        """Load the trainable leaves (the value tree's too), the optimizer
        state and the step counters saved at `step` (default: the latest)
        into this trainer, and fast-forward the data stream to the saved
        rollout cursor; the host planes' journals come back too (the
        sentinel's rollback spend and quarantine, the watchdog's counters,
        the health baselines, the ledger's index, the latency histograms). A checkpoint that will not load falls back to an
        older intact one, whose step is adopted; resuming an earlier step
        than the latest abandons the newer trajectory (`truncate_after`).
        The random streams are functions of (seed, stream, step or rollout
        index), so the restored counters restore them too."""
        if self._par is not None:
            # every rank reads rank 0's checkpoints: its writes land first
            if self.mesh.writer:
                self.ckpt.wait()
            self._rank0_value(None)
        latest = self.ckpt.latest_step()
        step = latest if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.cfg.output_dir}")
        # queued samples came from pre-restore weights and the producer's
        # cursor ran ahead: tear the pipeline (and a prefetch) down; train()
        # rebuilds it from the restored cursor and journal
        self._close_orchestrator(keep_journal=False)
        self._close_stream()
        tree = self.ckpt.restore(step, self.device)
        step = self.ckpt.last_restored_step
        if latest is not None and step < latest and self.mesh.writer:
            self.ckpt.truncate_after(step)
        self._load_trainable(tree)
        if self._quant_layers is not None:
            self._refresh_quant_layers()  # the restored base
        for group, opt in tree.get("opt_state", {}).items():
            st = self.opt_state[group]
            for name in ("mu", "nu"):
                live = flatten(getattr(st, name))
                for path, t in flatten(opt[name]).items():
                    live[path].copy_(shard_of(t, path, self._par))
            self.opt_state[group] = AdamWState(int(opt["count"]), st.mu, st.nu)
        state = self.ckpt.load_trainer_state(step)
        self.state.update(global_step=state["step"],
                          **{k: state[k] for k in ("episode", "opt_steps", "rollouts")})
        res = state.get("resilience")
        if res:
            self.sentinel.restore(res.get("sentinel", {}))
            self.watchdog.restore(res.get("watchdog", {}))
        for key, plane in (("health", self.health), ("lineage", self.lineage),
                           ("latency", self.latency)):
            if state.get(key):
                plane.restore(state[key])
        self._orch_restore_state = state.get("orchestrator")
        self._reset_data_iterator()
        return self.state

    def restore_checkpoint(self, step: int | None = None) -> int:
        """`resume_from_checkpoint`, returning the step that loaded."""
        return self.resume_from_checkpoint(step)["global_step"]

    def export_model(self, out_dir: str, dtype: str = "bfloat16") -> str:
        """Write the current policy as an HF checkpoint directory, LoRA
        folded into the base kernels at `lora_scale`, with the tokenizer's
        special ids (and its files, when it can save them). On a mesh every
        rank takes part (fsdp gathers the leaves) and rank 0 writes (the
        others return None)."""
        params = full_tree(self.params, self._par)
        if not self.mesh.writer:
            return None
        return export_hf_checkpoint(
            self.mcfg, params, out_dir,
            lora_scale=self.lora_scale if self.cfg.use_lora else None,
            dtype=dtype, tokenizer=self.tokenizer)

    def close(self) -> None:
        """Stop the exporter (its handlers read the trainer) and the rollout
        pipeline (its producer threads), close the environment (its
        executor's worker), close an open profile window, write the trace,
        flush the ledger and the writer,
        and uninstall the SIGTERM guard — the last two whatever failed
        before them. A second call does nothing."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        try:
            self.exporter.close()
            # stop + join the producer threads before the planes they write
            self._close_orchestrator(keep_journal=False)
            self._close_stream()
            env = getattr(self, "env", None)
            if hasattr(env, "close"):
                env.close()
            self.profile_window.stop()
            self._write_trace()
            self.lineage.close()
            self.ckpt.close()
        finally:
            try:
                self.logger.close()
            finally:
                self._preemption.uninstall()
