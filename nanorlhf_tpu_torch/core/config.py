"""Model architecture config (Qwen2-family decoder) — the port's copy of
`nanorlhf_tpu/core/config.py`.

Same fields, defaults and presets, minus the three `spmd_*` mesh hints:
they told the JAX kernels how to shard over a TPU mesh and mean nothing on
one GPU.

`attention_impl` keeps its values for config parity, read the port's way:
"xla" is the plain PyTorch path, "pallas" the hand-written Hopper kernels,
and "auto" the kernels for CUDA tensors and the plain path for CPU tensors.
The TPU "auto" length thresholds are not carried over (they were tuned on
another chip).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // num_attention_heads
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    # Qwen2-family attention projections carry biases; Llama-family do not
    attention_bias: bool = True
    # HF family slug ("qwen2" | "llama"); None for random-init configs
    model_type: Optional[str] = None
    # "int8" selects the quantized KV cache: int8 values with one bf16
    # scale per (kv head, slot), read by the int8 decode kernels
    kv_cache_quant: str = "none"  # none | int8
    attention_impl: str = "auto"  # xla | pallas | auto (see module docstring)
    remat_policy: str = "full"  # full | dots (training slice)

    @property
    def actual_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def qwen2_tiny(cls, vocab_size: int = 512) -> "ModelConfig":
        """Test-size model."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            rope_theta=10_000.0,
            max_position_embeddings=1024,
        )

    @classmethod
    def qwen2_0_5b(cls) -> "ModelConfig":
        return cls(
            hidden_size=896,
            intermediate_size=4864,
            num_hidden_layers=24,
            num_attention_heads=14,
            num_key_value_heads=2,
            tie_word_embeddings=True,
        )

    @classmethod
    def qwen2_1_5b(cls) -> "ModelConfig":
        return cls()  # defaults are Qwen2.5-1.5B

    @classmethod
    def qwen2_7b(cls) -> "ModelConfig":
        return cls(
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            tie_word_embeddings=False,
        )

    @classmethod
    def llama3_2_1b(cls) -> "ModelConfig":
        """Llama-3.2-1B geometry (no attention biases)."""
        return cls(
            vocab_size=128256,
            hidden_size=2048,
            intermediate_size=8192,
            num_hidden_layers=16,
            num_attention_heads=32,
            num_key_value_heads=8,
            head_dim=64,
            rope_theta=500_000.0,
            rms_norm_eps=1e-5,
            tie_word_embeddings=True,
            max_position_embeddings=131072,
            attention_bias=False,
            model_type="llama",
        )

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        return cls(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            rope_theta=500_000.0,
            rms_norm_eps=1e-5,
            tie_word_embeddings=False,
            max_position_embeddings=131072,
            attention_bias=False,
            model_type="llama",
        )

    @classmethod
    def from_hf_config(cls, hf_config) -> "ModelConfig":
        """Build from a `transformers` Qwen2Config / LlamaConfig (or dict)."""
        get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(
            hf_config, dict
        ) else (lambda k, d=None: hf_config.get(k, d))
        model_type = str(get("model_type", "qwen2")).lower()
        attn_bias = get("attention_bias", "qwen" in model_type)
        return cls(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads"),
            head_dim=get("head_dim", None),
            rope_theta=get("rope_theta", 1_000_000.0),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            tie_word_embeddings=get("tie_word_embeddings", False),
            max_position_embeddings=get("max_position_embeddings", 32768),
            attention_bias=bool(attn_bias),
            model_type=model_type,
        )
