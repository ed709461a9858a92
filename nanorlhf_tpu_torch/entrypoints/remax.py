"""ReMax launcher — the port of `nanorlhf_tpu/entrypoints/remax.py`: one
sampled rollout per prompt, baselined by a greedy rollout of the same
prompt.

Run (one ReMax update on the card, with the batch cut of `one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.remax [--device cpu]
"""

from nanorlhf_tpu_torch.entrypoints.common import device_arg, run
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig


def build_remax_config() -> RLConfig:
    cfg = build_config()
    cfg.algo = AlgoName.REMAX
    cfg.exp_name = "remax-v1"
    cfg.output_dir = "output/remax-v1"
    cfg.sample_n = 1          # single sampled rollout; the baseline is greedy
    return cfg


if __name__ == "__main__":
    state = run(one_card_cut(build_remax_config()),
                device=device_arg("one ReMax update (one_card_cut)"), num_updates=1)
    print(f"trained: {state}")
