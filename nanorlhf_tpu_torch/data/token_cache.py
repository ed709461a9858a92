"""Tokenized-corpus cache — a copy of `nanorlhf_tpu/data/token_cache.py`
(the port does not import the JAX package).

One binary file (format defined by `native/token_cache.cpp`) holds the
ragged encoded corpus, keyed by a fingerprint of everything that could
change the tokens; readers mmap it. The C++ path (ctypes) and the Python
fallback here read and write the SAME bytes as each other and as the JAX
package's, so a cache written by either package loads in the other."""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

from nanorlhf_tpu_torch.native import (
    flatten_rows,
    token_cache_open_native,
    token_cache_write_native,
)

_MAGIC = 0x4E524C48544F4B31
_HEADER = struct.Struct("<QQQ")  # magic, n_rows, fingerprint


def corpus_fingerprint(**kwargs) -> int:
    """Stable 64-bit fingerprint of the tokenization inputs (source name,
    split, limit, seed, max len, tokenizer identity...)."""
    text = "\x1f".join(f"{k}={kwargs[k]}" for k in sorted(kwargs))
    return int.from_bytes(
        hashlib.blake2b(text.encode(), digest_size=8).digest(), "little"
    )


def tokenizer_identity(tokenizer) -> str:
    """Best-effort identity string: class, vocab size, name/path, AND a hash
    of the chat template — the pipeline templates before encoding, so a
    changed/custom `chat_template` under the same name_or_path must miss."""
    template = getattr(tokenizer, "chat_template", None)
    template_h = hashlib.blake2b(
        str(template).encode(), digest_size=8
    ).hexdigest() if template is not None else None
    return "/".join(
        str(x) for x in (
            type(tokenizer).__name__,
            getattr(tokenizer, "vocab_size", None),
            getattr(tokenizer, "name_or_path", None),
            template_h,
        )
    )


def _write_py(path: str, rows, fingerprint: int) -> bool:
    """Python fallback writer — byte-identical to token_cache_write (both
    flatten via the shared `native.flatten_rows`)."""
    offsets, flat = flatten_rows(rows)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(_MAGIC, len(rows), fingerprint & (2**64 - 1)))
            f.write(offsets.tobytes())
            f.write(flat.tobytes())
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _read_py(path: str, fingerprint: int):
    """Python fallback reader: validated np.memmap views (zero-copy)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
        magic, n, fp = _HEADER.unpack(head)
        if magic != _MAGIC or fp != (fingerprint & (2**64 - 1)):
            return None
        # bound the u64 n_rows BEFORE any offset arithmetic: a corrupt
        # header otherwise overflows the memmap length (OverflowError, not
        # the ValueError the old catch assumed) — mirror of the native
        # reader's check
        if n >= (size - _HEADER.size) // 8:
            return None
        offsets = np.memmap(path, "<i8", "r", _HEADER.size, (n + 1,))
        total = int(offsets[n])
        if total < 0:
            return None
        expect = _HEADER.size + (n + 1) * 8 + total * 4
        if size != expect:
            return None
        flat = np.memmap(path, "<i4", "r", _HEADER.size + (n + 1) * 8,
                         (total,)) if total else np.empty(0, np.int32)
        return offsets, flat, int(n)
    except (OSError, ValueError, struct.error):
        return None


def save_token_cache(path: str, rows, fingerprint: int) -> bool:
    """Write the corpus cache (native writer, Python fallback)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if token_cache_write_native(path, rows, fingerprint):
        return True
    return _write_py(path, rows, fingerprint)


def load_token_cache(path: str, fingerprint: int):
    """Return list-like of int32 row arrays, or None on miss/mismatch.

    Rows are zero-copy views into the mapping; the mapping lives as long as
    the returned list holds references (native views carry the TokenCacheView
    keeper; memmap rows keep the memmap alive)."""
    view = token_cache_open_native(path, fingerprint)
    if view is not None:
        # the list keeps the mmap alive; rows are zero-copy views into it
        return _KeptList([view.row(i) for i in range(view.n_rows)], view)
    got = _read_py(path, fingerprint)
    if got is None:
        return None
    offsets, flat, n = got
    return _KeptList([flat[offsets[i]:offsets[i + 1]] for i in range(n)],
                     (offsets, flat))


class _KeptList(list):
    """List that keeps the underlying mapping object alive."""

    def __init__(self, rows, keeper):
        super().__init__(rows)
        self._keeper = keeper
