"""Model config, parameters and the decoder (port of nanorlhf_tpu.core)."""
