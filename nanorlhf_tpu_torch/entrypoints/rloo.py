"""RLOO launcher — the port of `nanorlhf_tpu/entrypoints/rloo.py`: the GRPO
launcher's settings with RLOO's sample count and λ.

Run (one RLOO update on the card, with the batch cut of `one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.rloo [--device cpu]
"""

from nanorlhf_tpu_torch.entrypoints.common import device_arg, run
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig


def build_rloo_config() -> RLConfig:
    cfg = build_config()
    cfg.algo = AlgoName.RLOO
    cfg.exp_name = "rloo-v1"
    cfg.output_dir = "output/rloo-v1"
    cfg.sample_n = 4          # rloo_sample_N
    cfg.lam = 0.95
    return cfg


if __name__ == "__main__":
    state = run(one_card_cut(build_rloo_config()),
                device=device_arg("one RLOO update (one_card_cut)"), num_updates=1)
    print(f"trained: {state}")
