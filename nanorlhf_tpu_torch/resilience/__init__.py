"""Host-side resilience helpers (port of nanorlhf_tpu.resilience)."""
