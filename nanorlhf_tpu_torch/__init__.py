"""nanorlhf_tpu_torch — the PyTorch/CUDA port of nanorlhf_tpu for one NVIDIA H100.

The JAX package beside it stays the reference: module paths and public
function layouts here mirror it (`core/model.py`, `ops/attention.py`, ...,
`[B, H, T, d]` attention tensors, `[B, KV, T_max, hd]` caches) so that the
parity tests compare like with like. This package imports neither `jax` nor
`nanorlhf_tpu`; it keeps its own copies of the jax-free pieces it needs.

Ported so far: the GRPO rollout-and-score path (prefill, sampled decode,
host reward, group advantage, fused policy/ref scoring) with three
hand-written Hopper kernels under `csrc/` (flash-attention forward, prefix-
bounded decode attention, fused hidden→logprob). Entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
