"""Layered run config — the port's jax-free copy of
`nanorlhf_tpu/trainer/config.py`.

Same field names and defaults as the JAX `RLConfig`/`AlgoName` (a test pins
them), so a launcher literal reads the same in both packages. The comments
on each knob live in the JAX module. The paged cache with continuous
batching, speculative decode, the int8 KV cache, int8 rollout weights
(`rollout_quant`), both remat policies (`remat_policy`), the naive
update branch (`fused_logprob=False`), compacting decode and the rest of
the rollout knobs are ported; the knobs that select paths this port has
not ported yet (disaggregated rollout devices, the mesh's tensor axis)
are carried for parity and make the port's trainer raise
NotImplementedError when set.

`MeshConfig` is a copy too: `parallel.mesh.make_mesh` resolves it over the
torch.distributed world (the data, fsdp and sp axes), and `finalize`
counts the world's data-parallel ranks (data × fsdp) from it.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

from nanorlhf_tpu_torch.ops.masking import exact_div


class AlgoName(str, enum.Enum):
    PPO = "ppo"
    GRPO = "grpo"
    RLOO = "rloo"
    REMAX = "remax"
    REINFORCE = "reinforce"
    RAFT = "raft"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sp: int = 1
    dcn_data: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        d, f, t, s = self.data, self.fsdp, self.tensor, self.sp
        dcn = max(self.dcn_data, 1)
        known = (f if f > 0 else 1) * (t if t > 0 else 1) * (s if s > 0 else 1)
        if d == -1:
            d = n_devices // (known * dcn) * dcn
        if d * f * t * s != n_devices:
            raise ValueError(f"mesh {d}x{f}x{t}x{s} != {n_devices} devices")
        if d % dcn != 0:
            raise ValueError(f"data axis {d} not divisible by dcn_data {dcn}")
        return d, f, t, s


@dataclasses.dataclass
class RLConfig:
    # ---- experiment ----
    exp_name: str = "run"
    seed: int = 1
    output_dir: str = "output"
    algo: AlgoName = AlgoName.GRPO

    # ---- models ----
    sft_model_path: str = ""
    reward_model_path: str = ""

    # ---- data ----
    train_dataset_name: str = "Anthropic/hh-rlhf"
    train_dataset_split: str = "train"
    dataset_cache_dir: Optional[str] = None

    # ---- rollout / sampling ----
    response_length: int = 1500
    temperature: float = 0.9
    top_p: float = 0.95
    sample_n: int = 4
    stop_token: str = "eos"
    missing_eos_penalty: Optional[float] = None
    rollout_top_k: int = 64
    # the port's top-k is always exact (torch.topk); kept for parity
    rollout_approx_top_k: bool = True
    rollout_shared_prefill: bool = True
    rollout_spec_k: int = 0
    rollout_spec_ngram: int = 3

    # ---- batch hierarchy ----
    total_episodes: Optional[int] = 10000
    num_train_epochs: float = 1.0
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 8
    num_mini_batches: int = 16
    num_ppo_epochs: int = 1
    local_rollout_forward_batch_size: Optional[int] = None
    sampler_logprob_capture: bool = False
    rollout_ahead: bool = False
    rollout_devices: int = 0
    rollout_mesh: Optional[MeshConfig] = None
    rollout_orchestrator: bool = False
    max_staleness: int = 1
    staleness_policy: str = "wait"
    offpolicy_correction: str = "truncated_is"
    offpolicy_is_truncation: float = 2.0
    rollout_inflight_swaps: bool = False
    rollout_workers: int = 1
    fleet_lease_size: int = 1
    fleet_failure_budget: int = 2
    fleet_quarantine_base: float = 0.5
    fleet_quarantine_max: float = 30.0
    fleet_backoff_jitter: float = 0.25
    fleet_straggler_factor: float = 4.0
    fleet_initial_deadline: float = 600.0
    rollout_transport: str = "inprocess"
    fleet_rpc_host: str = "127.0.0.1"
    fleet_rpc_port: int = 0
    fleet_rpc_timeout: float = 30.0
    fleet_rpc_attempts: int = 4
    fleet_rpc_backoff_base: float = 0.05

    # ---- optimization ----
    learning_rate: float = 6e-6
    value_learning_rate: Optional[float] = None
    warmup_steps: int = 0
    min_lr_rate: float = 0.1
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None

    # ---- RL coefficients ----
    kl_coef: float = 0.01
    score_ref_logprobs: Optional[bool] = None
    cliprange: float = 0.2
    cliprange_value: float = 0.01
    vf_coef: float = 0.1
    gamma: float = 1.0
    lam: float = 0.95
    whiten_rewards: bool = False
    advantage_whiten: bool = False
    raft_selection: str = "best"

    # ---- LoRA ----
    use_lora: bool = True
    lora_r: int = 64
    lora_alpha: int = 16
    value_use_lora: bool = True
    value_lora_r: int = 64
    value_lora_alpha: int = 16

    # ---- memory / kernels ----
    fused_logprob: bool = True
    fused_logprob_chunk: Optional[int] = None
    # port reading: "auto" → the Hopper kernel for CUDA tensors, the plain
    # chunked path for CPU tensors; "pallas" → the kernel; "lax" → plain
    fused_logprob_impl: str = "auto"
    gradient_checkpointing: bool = True
    attention_impl: str = "auto"  # xla | pallas | auto (core/config.py)
    remat_policy: str = "full"
    rollout_quant: str = "none"
    kv_cache_quant: str = "none"
    rollout_compaction_segments: int = 0
    rollout_page_size: int = 0
    rollout_decode_rows: int = 0
    rollout_prefix_cache: bool = False
    rollout_prefill_chunk: int = 0

    # ---- environments ----
    env_name: str = ""
    env_max_turns: int = 1
    env_turn_tokens: int = 0
    env_obs_budget: int = 64
    env_tool_timeout: float = 5.0
    env_decode_rows: int = 0

    # ---- resilience ----
    fault_spec: Optional[str] = None
    sentinel: bool = True
    sentinel_spike_zscore: float = 6.0
    sentinel_ewma_alpha: float = 0.1
    sentinel_warmup_steps: int = 20
    rollback_budget: int = 2
    producer_restart_budget: int = 2
    producer_backoff_base: float = 0.5
    producer_backoff_max: float = 30.0
    producer_backoff_jitter: float = 0.1
    producer_heartbeat: float = 30.0
    degrade_to_sync: bool = True
    ckpt_io_retries: int = 2
    ckpt_retry_backoff: float = 0.5
    reward_retries: int = 1
    graceful_preemption: bool = True

    # ---- telemetry ----
    telemetry: bool = False
    telemetry_dir: Optional[str] = None
    telemetry_max_events: int = 200_000
    flight_recorder_len: int = 256
    profile_at_step: Optional[int] = None
    profile_num_steps: int = 1
    profile_dir: Optional[str] = None
    profile_trigger_file: Optional[str] = None
    health: bool = True
    health_fast_alpha: float = 0.5
    health_slow_alpha: float = 0.05
    health_warmup_steps: int = 8
    health_window_s: float = 60.0
    health_max_events: int = 64
    health_blackbox_on_crit: bool = True
    health_arm_sentinel: bool = False
    status_port: int = 0
    status_host: str = "127.0.0.1"
    lineage: bool = False
    lineage_sample_rate: float = 1.0
    latency: bool = True

    # ---- checkpoint / eval / logging ----
    save_steps: int = 1
    save_total_limit: int = 8
    save_optimizer_state: bool = True
    save_value_model: bool = True
    metric_for_best_model: str = "eval_objective/rlhf_reward_old"
    greater_is_better: bool = True
    load_best_model_at_end: bool = True
    export_hf_dir: Optional[str] = None
    eval_steps: int = 1
    logging_steps: int = 1
    num_printed_samples: int = 5
    log_samples_limit: Optional[int] = None
    report_to: str = "jsonl"

    # ---- mesh ----
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    # ---- derived (filled by finalize) ----
    world_size: int = dataclasses.field(default=1, init=False)
    local_batch_size: int = dataclasses.field(default=0, init=False)
    micro_batch_size: int = dataclasses.field(default=0, init=False)
    batch_size: int = dataclasses.field(default=0, init=False)
    mini_batch_size: int = dataclasses.field(default=0, init=False)
    local_mini_batch_size: int = dataclasses.field(default=0, init=False)
    num_total_batches: int = dataclasses.field(default=0, init=False)

    def finalize(self, n_devices: int = 1) -> "RLConfig":
        """Derive the batch hierarchy from `self.mesh` over n_devices."""
        d, f, _t, _sp = self.mesh.resolve(n_devices)
        return self.finalize_world(d * f)

    def finalize_world(self, world_size: int) -> "RLConfig":
        """The reference's batch-size hierarchy (`GRPOTrainer.__init__`)."""
        self.world_size = world_size
        self.local_batch_size = (
            self.per_device_train_batch_size
            * self.gradient_accumulation_steps
            * self.num_mini_batches
        )
        self.micro_batch_size = self.per_device_train_batch_size * self.world_size
        self.batch_size = self.local_batch_size * self.world_size
        self.mini_batch_size = exact_div(
            self.batch_size, self.num_mini_batches,
            "`batch_size` must be a multiple of `num_mini_batches`",
        )
        self.local_mini_batch_size = exact_div(
            self.local_batch_size, self.num_mini_batches,
            "`local_batch_size` must be a multiple of `num_mini_batches`",
        )
        if self.whiten_rewards and self.local_mini_batch_size < 8:
            raise ValueError(
                f"Per-rank minibatch size {self.local_mini_batch_size} is "
                "insufficient for whitening"
            )
        self.num_total_batches = math.ceil(self.total_episodes / self.batch_size)
        return self
