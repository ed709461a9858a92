"""The autoregressive sampler (port of nanorlhf_tpu.sampler)."""
