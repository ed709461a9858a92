"""Run config and the rollout-and-score path (port of nanorlhf_tpu.trainer)."""
