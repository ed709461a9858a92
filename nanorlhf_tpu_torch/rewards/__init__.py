"""Reward-function builders (port of nanorlhf_tpu.rewards)."""
