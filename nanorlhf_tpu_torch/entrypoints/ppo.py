"""PPO launcher — the port of `nanorlhf_tpu/entrypoints/ppo.py`: a value
model built from the SFT backbone with a fresh score head, separate
policy and value learning rates, and the value-initializer phase before
PPO proper.

Run (the value-init phase, then one PPO update on the card, with the
batch cut of `one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.ppo [--device cpu]
"""

import numpy as np

from nanorlhf_tpu_torch.core.model import init_score_head
from nanorlhf_tpu_torch.entrypoints.common import device_arg, run
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.sampler.sampler import stream_generator
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig
from nanorlhf_tpu_torch.trainer.value_init import ValueInitConfig, finetune_value_model

# seed streams of the score head's init and the value-init rollout
SCORE_STREAM = 0x5C0E
VALUE_INIT_STREAM = 0x7A11


def build_ppo_config() -> RLConfig:
    cfg = build_config()
    cfg.algo = AlgoName.PPO
    cfg.exp_name = "ppo-v1"
    cfg.output_dir = "output/ppo-v1"
    cfg.sample_n = 1
    cfg.value_learning_rate = 1e-5
    cfg.cliprange_value = 0.01
    cfg.vf_coef = 0.1
    cfg.gamma = 1.0
    cfg.lam = 0.95            # GAE(γ=1.0, λ=0.95)
    return cfg


def make_value_params(mcfg, params: dict) -> dict:
    """The value model: a COPY of the SFT backbone (no lm_head, no LoRA; its
    embeddings train, so no leaf may alias the policy's) with a fresh score
    head."""

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.detach().clone()
                for k, v in tree.items()}

    value = copy({k: v for k, v in params.items() if k not in ("lm_head", "lora")})
    embed = params["embed_tokens"]
    value["score"] = init_score_head(
        mcfg, stream_generator(1, SCORE_STREAM, device=embed.device), dtype=embed.dtype)
    return value


def value_init_phase(cfg: RLConfig, run_value_init: bool = True,
                     value_init_cfg: ValueInitConfig | None = None):
    """The `post_build` hook: regress the trainer's value tree onto the
    returns of the frozen, freshly built policy's rollout."""

    def hook(trainer, dataset, reward_func):
        if not run_value_init:
            return
        vcfg = value_init_cfg or ValueInitConfig()
        finetune_value_model(
            trainer.value_params, trainer.params,
            # None in ref-free mode: the value init then skips the ref forward
            trainer.ref_params, reward_func,
            np.asarray(dataset.input_ids[: vcfg.train_data_size]),
            trainer.tokenizer, trainer.mcfg,
            response_length=cfg.response_length, temperature=cfg.temperature,
            kl_coef=cfg.kl_coef, gamma=cfg.gamma, vcfg=vcfg,
            whiten_rewards=cfg.whiten_rewards, lora_scale=trainer.lora_scale,
            value_lora_cfg=trainer.value_lora_cfg,
            generator=stream_generator(cfg.seed, VALUE_INIT_STREAM,
                                       device=trainer.device),
            fused_logprob_scoring=cfg.fused_logprob, mesh=trainer._par)

    return hook


def main(run_value_init: bool = True, value_init_cfg: ValueInitConfig | None = None,
         *, cfg: RLConfig | None = None, device="cuda",
         num_updates: int | None = None) -> dict:
    """The value-init phase, then PPO training on `cfg` (default: the
    launcher's)."""
    cfg = cfg or build_ppo_config()
    return run(cfg, device=device, num_updates=num_updates,
               value_params_fn=make_value_params,
               post_build=value_init_phase(cfg, run_value_init, value_init_cfg))


if __name__ == "__main__":
    state = main(cfg=one_card_cut(build_ppo_config()),
                 device=device_arg("value init, then one PPO update (one_card_cut)"),
                 num_updates=1)
    print(f"trained: {state}")
