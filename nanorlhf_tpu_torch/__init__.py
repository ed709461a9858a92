"""nanorlhf_tpu_torch — the PyTorch/CUDA port of nanorlhf_tpu for one NVIDIA H100.

The JAX package beside it stays the reference: module paths and public
function layouts here mirror it (`core/model.py`, `ops/attention.py`, ...,
`[B, H, T, d]` attention tensors, `[B, KV, T_max, hd]` caches) so that the
parity tests compare like with like. This package imports neither `jax` nor
`nanorlhf_tpu`; it keeps its own copies of the jax-free pieces it needs.

Ported so far: the default GRPO run end to end — rollout-and-score
(prefill, sampled decode, host reward, group advantage, fused policy/ref
scoring), the update (loss, flash backward, AdamW on LoRA) and the
checkpoint — and the rollout variants: the paged KV cache with continuous
batching, the int8 KV cache and speculative decode — for all six
algorithms, with HF weights loaded and exported, async checkpoints with
retries, fallback and resume, and the launcher's tokenizer, dataset,
token-cache and reward-model branches; sparse GRPO, the host planes,
serving, multi-turn environments (`envs/`: the python-tool environment
over a pooled executor, the episode driver on the paged session) and the
chaos harness's serving soak (`chaos/`), the rollout orchestrator and
fleet (`orchestrator/`), compacting decode (`sampler/compaction.py`) and
sequence parallelism over `torch.distributed` (`parallel/`: the ring over
the flash kernels, SP scoring and updates). All ten Pallas kernels
of the JAX package have a hand-written Hopper counterpart under `csrc/`:
the flash-attention forward and backward (dQ, dK/dV), the decode attention
over the contiguous, paged and int8 caches, the k-query verify over the
contiguous and paged caches, and the fused hidden→logprob. Entry points run
on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
