"""The rollout fleet's knobs that the JAX trainer refuses at construction
(`nanorlhf_tpu/trainer/trainer.py:390-411`) are refused by the port's with
the same ValueError and message — before any unported path could raise
NotImplementedError, and instead of training silently, as the port did
before these checks existed. Each bad config is built against both
packages: the port through `common.build_trainer(..., device="cpu")`, JAX
through `tests/test_trainer_smoke.py`'s `make_trainer`."""

import re

import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.trainer import AlgoName
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.rollout import check_supported
from test_trainer_smoke import make_trainer

torch.set_num_threads(1)

BAD = {
    "no_workers": dict(rollout_workers=0),
    "fleet_without_orchestrator": dict(rollout_workers=2),
    "unknown_transport": dict(rollout_transport="carrier-pigeon"),
    "rpc_with_one_worker": dict(rollout_transport="rpc"),
    "unknown_offpolicy_correction": dict(offpolicy_correction="bogus"),
}


def _port_cfg(tmp_path, knobs):
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "port")
    cfg.response_length = 4
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 16
    for k, v in knobs.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("case", sorted(BAD))
def test_fleet_knobs_jax_refuses_are_refused_with_its_message(case, tmp_path):
    knobs = BAD[case]
    with pytest.raises(ValueError) as jax_err:
        make_trainer(AlgoName.GRPO, tmp_path / "jax", **knobs)
    with pytest.raises(ValueError) as port_err:
        common.build_trainer(_port_cfg(tmp_path, knobs), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    # the rollout's own gate (run at every rollout) raises it too
    with pytest.raises(ValueError, match="^" + re.escape(str(jax_err.value))):
        check_supported(_port_cfg(tmp_path, knobs))
