"""Shared fixtures of the tests/test_torch_*.py parity tests: tiny models
built by the JAX package, bridged into the port through numpy."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorlhf_tpu.core.config import ModelConfig as JaxModelConfig
from nanorlhf_tpu.core.lora import LoraConfig as JaxLoraConfig
from nanorlhf_tpu.core.lora import init_lora_params as jax_init_lora_params
from nanorlhf_tpu.core.model import init_params as jax_init_params
from nanorlhf_tpu_torch.bridge import params_from_numpy
from nanorlhf_tpu_torch.core.config import ModelConfig
from nanorlhf_tpu_torch.trainer import trainer as _port_trainer  # noqa: F401 (closes_trainers)

LORA = JaxLoraConfig(r=4, alpha=8)
KINDS = ("qwen_tied", "llama_untied")


def jax_config(kind: str, vocab_size: int = 128, attention_impl: str = "xla"):
    """Tiny Qwen2 (tied, biases) or a Llama-flavoured tiny (untied, no
    biases, llama rope theta): 2 layers, D=64, H=4, KV=2, hd=16."""
    cfg = JaxModelConfig.qwen2_tiny(vocab_size=vocab_size)
    if kind == "llama_untied":
        cfg = dataclasses.replace(cfg, attention_bias=False, tie_word_embeddings=False,
                                  rope_theta=500_000.0, model_type="llama")
    return dataclasses.replace(cfg, attention_impl=attention_impl)


def port_config(jcfg) -> ModelConfig:
    d = dataclasses.asdict(jcfg)
    for k in ("spmd_mesh", "spmd_batch_axes", "spmd_head_axis"):
        d.pop(k)
    return ModelConfig(**d)


def make_params(jcfg, seed: int = 0, lora: bool = True):
    """(JAX f32 tree, port f32 params). Projection kernels are rescaled from
    the JAX init's N(0, 1/L) to N(0, 1/fan_in), so activations stay O(1)
    and a 1e-5 tolerance measures the code, not f32 rounding of huge
    residuals. Biases, norm weights and LoRA B are perturbed away from their
    init constants so every term computes."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    layers = tree["layers"]
    L = jcfg.num_hidden_layers
    for entry in layers.values():
        if isinstance(entry, dict):
            k = entry["kernel"]
            entry["kernel"] = (k * np.sqrt(L / k.shape[1])).astype(np.float32)
    for name in ("q_proj", "k_proj", "v_proj"):
        if "bias" in layers[name]:
            layers[name]["bias"] = rng.normal(0, 0.1, layers[name]["bias"].shape).astype(np.float32)
    for name in ("input_layernorm", "post_attention_layernorm"):
        layers[name] = (1 + rng.normal(0, 0.1, layers[name].shape)).astype(np.float32)
    tree["norm"] = (1 + rng.normal(0, 0.1, tree["norm"].shape)).astype(np.float32)
    if lora:
        lt = jax.tree.map(np.asarray, jax_init_lora_params(
            jcfg, LORA, jax.random.PRNGKey(seed + 1), dtype=jnp.float32))
        for ab in lt["layers"].values():
            ab["b"] = rng.normal(0, 0.02, ab["b"].shape).astype(np.float32)
        tree["lora"] = lt
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, "cpu", torch.float32)


def left_pad(rows, T, pad=0):
    ids = np.full((len(rows), T), pad, np.int32)
    for i, r in enumerate(rows):
        ids[i, T - len(r):] = r
    return ids


# the trainer classes whose instances `closes_trainers` closes: each
# installs a SIGTERM guard (and may hold a status port, a writer thread and
# open files) until its close()
_TRAINER_CLASSES = (("nanorlhf_tpu_torch.trainer.trainer", "RLTrainer"),
                    ("nanorlhf_tpu.trainer.trainer", "RLTrainer"))


@pytest.fixture(autouse=True)
def closes_trainers(monkeypatch):
    """Close every trainer (the port's and the JAX package's, the sparse
    ones included) that the test built and left open. Import it into a test
    module that builds trainers; it is autouse there."""
    built = []
    for module, name in _TRAINER_CLASSES:
        if module not in sys.modules:
            continue
        cls = getattr(sys.modules[module], name)
        real_init = cls.__init__

        def recording_init(self, *args, _real=real_init, **kwargs):
            built.append(self)
            _real(self, *args, **kwargs)

        monkeypatch.setattr(cls, "__init__", recording_init)
    yield built
    for trainer in built:
        # a trainer whose __init__ raised may lack what close() needs
        guard = getattr(trainer, "_preemption", None)
        try:
            trainer.close()
        except Exception:
            if guard is not None:
                guard.uninstall()
