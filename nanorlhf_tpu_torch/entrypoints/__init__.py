"""Launchers (port of nanorlhf_tpu.entrypoints)."""
