"""Numerics and the kernel wrappers (port of nanorlhf_tpu.ops)."""
