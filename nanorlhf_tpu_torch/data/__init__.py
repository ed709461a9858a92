"""Tokenizer and prompt datasets (port of nanorlhf_tpu.data)."""
