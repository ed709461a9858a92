"""The port's config dataclasses against the JAX package's: same field
names, order and defaults (ModelConfig minus the three spmd_* mesh hints)."""

import dataclasses

import pytest
import torch

from nanorlhf_tpu.core.config import ModelConfig as JaxModelConfig
from nanorlhf_tpu.trainer.config import AlgoName as JaxAlgoName
from nanorlhf_tpu.trainer.config import RLConfig as JaxRLConfig
from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.trainer.config import AlgoName, RLConfig

torch.set_num_threads(1)

_SPMD = ("spmd_mesh", "spmd_batch_axes", "spmd_head_axis")


def _defaults(cls, skip=()):
    out = []
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        if f.default is not dataclasses.MISSING:
            d = f.default
        elif f.default_factory is not dataclasses.MISSING:
            d = f.default_factory()
        else:
            d = dataclasses.MISSING
        if dataclasses.is_dataclass(d):
            d = dataclasses.asdict(d)
        if isinstance(d, JaxAlgoName) or isinstance(d, AlgoName):
            d = d.value
        out.append((f.name, d, f.init))
    return out


def test_model_config_fields_and_defaults():
    assert _defaults(ModelConfig) == _defaults(JaxModelConfig, skip=_SPMD)


@pytest.mark.parametrize("preset", ["qwen2_tiny", "qwen2_0_5b", "qwen2_1_5b",
                                    "qwen2_7b", "llama3_2_1b", "llama3_8b"])
def test_model_config_presets(preset):
    mine = dataclasses.asdict(getattr(ModelConfig, preset)())
    ref = dataclasses.asdict(getattr(JaxModelConfig, preset)())
    for k in _SPMD:
        ref.pop(k)
    assert mine == ref
    assert (getattr(ModelConfig, preset)().actual_head_dim
            == getattr(JaxModelConfig, preset)().actual_head_dim)


def test_model_config_from_hf_config():
    hf = {"model_type": "llama", "vocab_size": 100, "hidden_size": 64,
          "intermediate_size": 96, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2}
    mine = dataclasses.asdict(ModelConfig.from_hf_config(hf))
    ref = dataclasses.asdict(JaxModelConfig.from_hf_config(hf))
    for k in _SPMD:
        ref.pop(k)
    assert mine == ref


def test_rl_config_fields_and_defaults():
    assert _defaults(RLConfig) == _defaults(JaxRLConfig)


def test_algo_names():
    assert [a.value for a in AlgoName] == [a.value for a in JaxAlgoName]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_finalize_world_batch_hierarchy(world):
    keys = ("world_size", "local_batch_size", "micro_batch_size", "batch_size",
            "mini_batch_size", "local_mini_batch_size", "num_total_batches")
    mine = RLConfig().finalize_world(world)
    ref = JaxRLConfig().finalize_world(world)
    assert {k: getattr(mine, k) for k in keys} == {k: getattr(ref, k) for k in keys}


def test_grpo_launcher_config_matches():
    from nanorlhf_tpu.entrypoints.grpo import build_config as jax_build_config
    from nanorlhf_tpu_torch.entrypoints.grpo import build_config

    def norm(cfg):
        d = dataclasses.asdict(cfg)
        d["algo"] = cfg.algo.value
        return d

    assert norm(build_config()) == norm(jax_build_config())
    assert norm(build_config(rollout_spec_k=4, rollout_staleness=2)) == norm(
        jax_build_config(rollout_spec_k=4, rollout_staleness=2))
