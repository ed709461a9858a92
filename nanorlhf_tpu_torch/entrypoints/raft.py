"""RAFT launcher — the port of `nanorlhf_tpu/entrypoints/raft.py`: K samples
per prompt, the best one (by shaped reward) trained on with the SFT loss.

Run (one RAFT update on the card, with the batch cut of `one_card_cut`):
    python -m nanorlhf_tpu_torch.entrypoints.raft [--device cpu]
"""

from nanorlhf_tpu_torch.entrypoints.common import device_arg, run
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig


def build_raft_config() -> RLConfig:
    cfg = build_config()
    cfg.algo = AlgoName.RAFT
    cfg.exp_name = "raft-v1"
    cfg.output_dir = "output/raft-v1"
    cfg.sample_n = 4          # raft_sample_K
    # "best" is the documented intent; "random" is the reference as shipped
    cfg.raft_selection = "best"
    return cfg


if __name__ == "__main__":
    state = run(one_card_cut(build_raft_config()),
                device=device_arg("one RAFT update (one_card_cut)"), num_updates=1)
    print(f"trained: {state}")
