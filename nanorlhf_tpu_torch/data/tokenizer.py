"""Tokenizers — a copy of `nanorlhf_tpu/data/tokenizer.py` (the port does
not import the JAX package): the toy tokenizer (deterministic hashed vocab,
`[PAD]`=0 and EOS `</s>`=1, reversible for its own output) and
`load_tokenizer`, which imports `transformers` only when it is asked for
an HF tokenizer.
"""

from __future__ import annotations

import re
import zlib


class ToyTokenizer:
    """Whitespace toy tokenizer with a stable crc32-hashed vocabulary."""

    def __init__(self, vocab_size: int = 4096):
        self.vocab_size = vocab_size
        self.pad_token = "[PAD]"
        self.eos_token = "</s>"
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.unk_token_id = 2
        self._id_to_word: dict[int, str] = {}
        self.parallel_safe = False  # the decode table fills during encode

    def _word_id(self, word: str) -> int:
        if word == self.pad_token:
            return self.pad_token_id
        if word == self.eos_token:
            return self.eos_token_id
        # crc32, not hash(): str hashes are salted per process
        h = 3 + (zlib.crc32(word.encode()) % (self.vocab_size - 3))
        self._id_to_word.setdefault(h, word)
        return h

    def encode(self, text: str) -> list[int]:
        return [self._word_id(w) for w in re.findall(r"\S+", text)]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.pad_token_id:
                if not skip_special_tokens:
                    out.append(self.pad_token)
            elif i == self.eos_token_id:
                if not skip_special_tokens:
                    out.append(self.eos_token)
            else:
                out.append(self._id_to_word.get(i, f"<unk:{i}>"))
        return " ".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        text = " ".join(m["content"] for m in messages)
        return f"<user> {text} <assistant>"


def load_tokenizer(name_or_path: str):
    """`toy:<vocab_size>` (or `toy`) → the toy tokenizer; anything else → an
    HF `AutoTokenizer` padding on the left, with a `[PAD]` token added when
    it has none (the reference's move)."""
    if name_or_path.startswith("toy"):
        _, _, size = name_or_path.partition(":")
        return ToyTokenizer(int(size) if size else 4096)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name_or_path, padding_side="left")
    if tok.pad_token is None:
        tok.add_special_tokens({"pad_token": "[PAD]"})
    return tok
