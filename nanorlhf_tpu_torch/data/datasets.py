"""Prompt dataset — the port of `nanorlhf_tpu/data/datasets.py` (the
offline `synthetic:<n>` corpus; the hh-rlhf loader needs a local HF cache
and comes with a later slice).

`PromptDataset` holds pre-tokenized, left-padded prompts and serves the
reference's shuffling, drop-last batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PromptDataset:
    input_ids: np.ndarray   # [N, T] left-padded
    pad_token_id: int

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def loader(self, batch_size: int, seed: int):
        """Infinite shuffling iterator, drop-last."""
        rng = np.random.default_rng(seed)
        n = len(self)
        if n < batch_size:
            raise ValueError(f"dataset ({n}) smaller than batch ({batch_size})")
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield self.input_ids[perm[i : i + batch_size]]


def _left_pad(seqs: list[list[int]], pad_id: int, max_len: int | None = None) -> np.ndarray:
    max_len = max_len or max(len(s) for s in seqs)
    out = np.full((len(seqs), max_len), pad_id, np.int32)
    for i, s in enumerate(seqs):
        s = s[-max_len:]
        out[i, max_len - len(s):] = s
    return out


def synthetic_prompts(n: int, tokenizer, seed: int = 0, min_words: int = 4,
                      max_words: int = 24) -> list[str]:
    """Deterministic offline prompt corpus (the JAX package's, word for word)."""
    rng = np.random.default_rng(seed)
    topics = [
        "how do I learn to cook pasta properly",
        "explain why the sky appears blue at noon",
        "what is a good plan for saving money",
        "describe the history of the printing press",
        "how can I improve my running endurance",
        "what makes a good friendship last long",
        "explain how photosynthesis works in plants",
        "what should I consider when adopting a dog",
    ]
    prompts = []
    for _ in range(n):
        base = topics[int(rng.integers(len(topics)))]
        words = base.split()
        k = int(rng.integers(min_words, min(max_words, len(words)) + 1))
        prompts.append(" ".join(words[:k]))
    return prompts


def load_prompt_dataset(name: str, tokenizer, split: str = "train",
                        max_prompt_len: int = 256, limit: int | None = None,
                        seed: int = 0) -> PromptDataset:
    """`synthetic:<n>`: the offline corpus, chat-templated, tokenized and
    left-padded to the batch max. Other names are HF datasets, not ported."""
    if not name.startswith("synthetic"):
        raise NotImplementedError(
            f"dataset {name!r}: only the offline 'synthetic:<n>' corpus is "
            "ported to nanorlhf_tpu_torch so far")
    _, _, count = name.partition(":")
    texts = synthetic_prompts(int(count) if count else 512, tokenizer, seed)
    if limit:
        texts = texts[:limit]
    templated = [
        tokenizer.apply_chat_template([{"role": "user", "content": t}],
                                      tokenize=False, add_generation_prompt=True)
        for t in texts
    ]
    ids = [tokenizer.encode(t)[:max_prompt_len] for t in templated]
    return PromptDataset(_left_pad(ids, tokenizer.pad_token_id), tokenizer.pad_token_id)
