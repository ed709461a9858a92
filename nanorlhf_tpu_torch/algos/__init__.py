"""Advantage estimators (port of nanorlhf_tpu.algos)."""
