"""REINFORCE launcher — the port of `nanorlhf_tpu/entrypoints/reinforce.py`:
the only launcher that whitens its advantages by default (whitening is
its baseline).

Run (one REINFORCE update on the card, with the batch cut of
`one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.reinforce [--device cpu]
"""

from nanorlhf_tpu_torch.entrypoints.common import device_arg, run
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig


def build_reinforce_config() -> RLConfig:
    cfg = build_config()
    cfg.algo = AlgoName.REINFORCE
    cfg.exp_name = "reinforce-v1"
    cfg.output_dir = "output/reinforce-v1"
    cfg.sample_n = 1
    cfg.advantage_whiten = True
    cfg.gamma = 1.0
    cfg.lam = 0.95
    return cfg


if __name__ == "__main__":
    state = run(one_card_cut(build_reinforce_config()),
                device=device_arg("one REINFORCE update (one_card_cut)"), num_updates=1)
    print(f"trained: {state}")
