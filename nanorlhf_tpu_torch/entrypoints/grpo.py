"""GRPO launcher — the port of `nanorlhf_tpu/entrypoints/grpo.py`.

`build_config` is the JAX launcher's config literal, field for field. The
knobs that select paths not ported yet (sequence parallelism, the
orchestrator and fleet, disaggregated rollouts) are accepted for parity
and make `run` raise NotImplementedError. `env_name="python_tool",
env_max_turns > 1` trains multi-turn GRPO over the paged cache
(`env_budgets` splits the response into turns and observations).

Run (one GRPO update on the card, with the batch cut of `one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.grpo [--device cpu]
        [--page-size 128 --decode-rows 32] [--kv-cache-quant int8]
        [--spec-k 4]
`--page-size` rolls out over the paged KV cache, `--decode-rows` (with a
page size) through the continuous-batching scheduler with that many
resident rows, `--kv-cache-quant int8` with the int8 KV cache, `--spec-k`
with speculative decode (n-gram drafts of that many tokens, one verify
forward per iteration). The defaults are the JAX launcher's: contiguous,
exact, no speculative decode.
"""

from nanorlhf_tpu_torch.entrypoints.common import run
from nanorlhf_tpu_torch.trainer.config import AlgoName, MeshConfig, RLConfig


def build_config(sequence_parallel: int = 1,
                 rollout_staleness: int | None = None,
                 rollout_devices: int = 0,
                 rollout_workers: int = 1,
                 rollout_spec_k: int = 0,
                 status_port: int = 0,
                 env_name: str = "",
                 env_max_turns: int = 1) -> RLConfig:
    """The reference GRPO launcher's settings (`GRPO/grpo.py:108-155`)."""
    cfg = RLConfig(
        algo=AlgoName.GRPO,
        exp_name="grpo-v1",
        sft_model_path="Qwen/Qwen2.5-1.5B-Instruct",
        reward_model_path="OpenAssistant/reward-model-deberta-v3-large-v2",
        output_dir="output/grpo-v1",
        kl_coef=0.01,
        cliprange=0.2,
        temperature=0.9,
        learning_rate=6e-6,
        warmup_steps=0,
        min_lr_rate=0.1,
        response_length=1500,
        per_device_train_batch_size=4,
        gradient_accumulation_steps=8,
        num_mini_batches=16,
        num_ppo_epochs=1,
        total_episodes=250000,
        whiten_rewards=False,
        advantage_whiten=False,
        sample_n=4,
        use_lora=True,
        lora_r=64,
        lora_alpha=16,
        gradient_checkpointing=True,
        missing_eos_penalty=None,
        save_steps=1,
        save_total_limit=8,
        metric_for_best_model="eval_objective/rlhf_reward_old",
        greater_is_better=True,
        load_best_model_at_end=True,
        stop_token="eos",
    )
    if sequence_parallel > 1:
        cfg.mesh = MeshConfig(data=-1, sp=sequence_parallel)
    if rollout_staleness is not None:
        cfg.rollout_orchestrator = True
        cfg.max_staleness = rollout_staleness
        cfg.sampler_logprob_capture = True
    if rollout_workers > 1:
        cfg.rollout_orchestrator = True
        cfg.rollout_workers = rollout_workers
        cfg.sampler_logprob_capture = True
        if rollout_staleness is None:
            cfg.max_staleness = rollout_workers
    if rollout_devices > 0:
        cfg.rollout_devices = rollout_devices
    cfg.rollout_spec_k = rollout_spec_k
    cfg.status_port = status_port
    if env_name:
        cfg.env_name = env_name
        cfg.env_max_turns = env_max_turns
        if env_max_turns > 1:
            if cfg.rollout_page_size <= 0:
                cfg.rollout_page_size = 128
            if cfg.rollout_decode_rows <= 0:
                cfg.rollout_decode_rows = cfg.batch_size * cfg.sample_n // 2
            cfg.rollout_orchestrator = False
            cfg.rollout_workers = 1
            cfg.sampler_logprob_capture = False
            cfg.rollout_spec_k = 0
            env_budgets(cfg)
    return cfg


def env_budgets(cfg: RLConfig) -> RLConfig:
    """The launcher's multi-turn budgets from `response_length`: half of it
    split evenly into `env_max_turns` model turns, the rest into the
    observations between them, at most 256 tokens each."""
    turns = cfg.env_max_turns
    cfg.env_turn_tokens = cfg.response_length // (2 * turns)
    cfg.env_obs_budget = min(
        256, (cfg.response_length - cfg.env_turn_tokens * turns) // max(1, turns - 1))
    return cfg


def one_card_cut(cfg: RLConfig) -> RLConfig:
    """The batch one card runs. The launcher's update (4 rows per
    microbatch × 8 accumulation steps × 16 minibatches = 512 prompts × 4
    samples at 1500 tokens) needs a KV cache of 2048 rows × 1510 slots,
    which does not fit one card. Cut to 16 prompts × 4 samples: the
    launcher's own microbatch of 4 rows, gradient_accumulation_steps=2 and
    num_mini_batches=2, i.e. 2 optimizer steps of 2 microbatches each."""
    cfg.gradient_accumulation_steps = 2
    cfg.num_mini_batches = 2
    return cfg


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="one GRPO update (one_card_cut)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--page-size", type=int, default=0,
                    help="rollout_page_size: > 0 rolls out over the paged KV cache")
    ap.add_argument("--decode-rows", type=int, default=0,
                    help="rollout_decode_rows: resident rows of continuous "
                         "batching (needs --page-size)")
    ap.add_argument("--kv-cache-quant", default="none", choices=("none", "int8"),
                    help="kv_cache_quant: the rollout's KV cache in int8")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="rollout_spec_k: > 0 rolls out with speculative decode")
    args = ap.parse_args()
    cfg = one_card_cut(build_config(rollout_spec_k=args.spec_k))
    cfg.rollout_page_size = args.page_size
    cfg.rollout_decode_rows = args.decode_rows
    cfg.kv_cache_quant = args.kv_cache_quant
    state = run(cfg, device=args.device, num_updates=1)
    print(f"trained: {state}")
