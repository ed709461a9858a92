"""Prompt dataset — the port of `nanorlhf_tpu/data/datasets.py`.

`PromptDataset` holds pre-tokenized, left-padded prompts and serves the
reference's shuffling, drop-last batches. `load_prompt_dataset` sources
them from the offline `synthetic:<n>` corpus or from an HF dataset (the
first "Human:" turn of each hh-rlhf transcript), chat-templates and
tokenizes them (`encode_texts`), and, given a `cache_dir`, keeps the
encoded corpus in the token cache (`data/token_cache.py`).

Two differences from JAX in `_load_hf_dataset`: it reads only the local
HF cache or a local dataset directory and never goes online (JAX tries the
network after a cache miss; the card's machine has no network, so that
attempt could only fail there, and the launcher then falls back to
synthetic prompts, as JAX's does); and it runs with a `huggingface_hub`
that has no `reset_sessions` (1.x; JAX's import of it fails there, so
JAX never loads a dataset on such a host). `datasets` is imported only inside
that branch.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os

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


def extract_hh_question(chosen: str) -> str:
    """First human turn of an hh-rlhf transcript (the reference launcher's
    string surgery)."""
    text = chosen.split("Human:", 1)[-1]
    return text.split("Assistant:", 1)[0].strip()


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


_WORKER_TOK = None


def _pool_init(tok):
    global _WORKER_TOK
    _WORKER_TOK = tok


def _pool_encode_chunk(args):
    texts, max_len = args
    return [_WORKER_TOK.encode(t)[:max_len] for t in texts]


def encode_texts(tokenizer, texts, max_prompt_len: int,
                 num_proc: int | None = None) -> list[list[int]]:
    """Tokenize a text list (`dataset.map(num_proc=6)` parity), each row
    equal to `tokenizer.encode(t)[:max_prompt_len]`, by one of three tiers:
    - an HF fast tokenizer: one batched call (its Rust backend runs in
      parallel);
    - a picklable slow tokenizer: a fork pool over chunks, its wait bounded
      (a child of a threaded parent can wedge on an inherited lock; the
      timeout turns that into the serial fallback). A tokenizer opts out
      with `parallel_safe = False` (the toy one, whose decode table must
      fill in the parent);
    - otherwise serial."""
    num_proc = num_proc if num_proc is not None else min(6, os.cpu_count() or 1)
    if getattr(tokenizer, "is_fast", False):
        ids = tokenizer(list(texts))["input_ids"]
        return [row[:max_prompt_len] for row in ids]
    if (num_proc > 1 and len(texts) >= 16 * num_proc
            and getattr(tokenizer, "parallel_safe", True)):
        ctx = multiprocessing.get_context("fork")
        chunk = -(-len(texts) // (num_proc * 4))
        chunks = [(texts[i:i + chunk], max_prompt_len)
                  for i in range(0, len(texts), chunk)]
        try:
            with ctx.Pool(num_proc, initializer=_pool_init,
                          initargs=(tokenizer,)) as pool:
                timeout_s = max(60.0, 0.05 * len(texts))
                parts = pool.map_async(_pool_encode_chunk, chunks).get(timeout_s)
            return [row for part in parts for row in part]
        except Exception:
            pass  # unpicklable tokenizer / wedged pool — serial fallback below
    return [tokenizer.encode(t)[:max_prompt_len] for t in texts]


def _load_hf_dataset(name: str, split: str):
    """An HF dataset from the local cache or a local directory, with the
    hub's offline switch on. The switch is flipped on the already-imported
    module constants (`huggingface_hub` and `datasets` read the environment
    at import) and restored after, so it does not leak into later calls."""
    import datasets
    import datasets.config as dcfg
    import huggingface_hub.constants as hub_c

    try:
        from huggingface_hub.utils import reset_sessions
    except ImportError:  # huggingface_hub >= 1.0 has no cached sessions to drop
        def reset_sessions():
            return None

    # datasets < 2.19 names the switch HF_DATASETS_OFFLINE
    attr = "HF_HUB_OFFLINE" if hasattr(dcfg, "HF_HUB_OFFLINE") else "HF_DATASETS_OFFLINE"
    saved = (hub_c.HF_HUB_OFFLINE, getattr(dcfg, attr, False))
    try:
        hub_c.HF_HUB_OFFLINE = True
        setattr(dcfg, attr, True)
        reset_sessions()  # drop cached sessions so they re-read the switch
        return datasets.load_dataset(name, split=split)
    finally:
        hub_c.HF_HUB_OFFLINE = saved[0]
        setattr(dcfg, attr, saved[1])
        reset_sessions()


def load_prompt_dataset(name: str, tokenizer, split: str = "train",
                        max_prompt_len: int = 256, limit: int | None = None,
                        seed: int = 0, num_proc: int | None = None,
                        cache_dir: str | None = None) -> PromptDataset:
    """hh-rlhf-style prompts from an HF dataset, or `synthetic:<n>`:
    chat-templated, tokenized (`encode_texts`) and left-padded to the batch
    max.

    `cache_dir` turns on the token cache: a re-launch with the same
    (source, split, limit, seed, max length, tokenizer) maps the encoded
    corpus instead of re-tokenizing it. An HF corpus is loaded BEFORE the
    cache check so the fingerprint covers its content, not only its name (a
    changed upstream snapshot must miss); a synthetic corpus is fixed by its
    parameters and skips the load."""
    texts = None
    if not name.startswith("synthetic"):
        ds = _load_hf_dataset(name, split)
        texts = [extract_hh_question(row["chosen"]) for row in ds]
        if limit:
            texts = texts[:limit]

    cache_path = fp = None
    if cache_dir is not None:
        import hashlib

        from nanorlhf_tpu_torch.data.token_cache import (
            corpus_fingerprint,
            load_token_cache,
            save_token_cache,
            tokenizer_identity,
        )

        fp_kw = dict(name=name, split=split, limit=limit, seed=seed,
                     max_prompt_len=max_prompt_len, tok=tokenizer_identity(tokenizer))
        if texts is not None:
            h = hashlib.blake2b(digest_size=8)
            for t in texts:
                h.update(t.encode())
                h.update(b"\x1f")
            fp_kw["content"] = h.hexdigest()
        fp = corpus_fingerprint(**fp_kw)
        cache_path = os.path.join(cache_dir, f"prompts-{fp:016x}.tok")
        cached = load_token_cache(cache_path, fp)
        if cached is not None:
            return PromptDataset(_left_pad(cached, tokenizer.pad_token_id),
                                 tokenizer.pad_token_id)

    if texts is None:
        _, _, count = name.partition(":")
        texts = synthetic_prompts(int(count) if count else 512, tokenizer, seed)
        if limit:
            texts = texts[:limit]
    templated = [
        tokenizer.apply_chat_template([{"role": "user", "content": t}],
                                      tokenize=False, add_generation_prompt=True)
        for t in texts
    ]
    ids = encode_texts(tokenizer, templated, max_prompt_len, num_proc=num_proc)
    if cache_path is not None:
        save_token_cache(cache_path, ids, fp)
    return PromptDataset(_left_pad(ids, tokenizer.pad_token_id), tokenizer.pad_token_id)
