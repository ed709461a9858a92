"""Native (C++) host code, loaded through ctypes — the token-cache half of
`nanorlhf_tpu/native/__init__.py` (its bucketing half comes with sparse
GRPO).

`token_cache.cpp` (a copy of the JAX package's) is compiled with g++ at
first use into `_build/` beside the kernels' libraries (git-ignored), named
by a hash of the source and written through a pid-unique temporary file, so
concurrent processes never load a half-written library and an edited source
never loads a stale one. Nothing is built at import time. Every entry point
returns None / False without the library (no toolchain), and
`data/token_cache.py` then uses its pure-Python twin, which reads and writes
the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "token_cache.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libtoken_cache-{digest}.so"


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so_path = library_path()
    try:
        if not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                            str(_SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        lib.token_cache_write.restype = ctypes.c_int
        lib.token_cache_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.token_cache_stat.restype = ctypes.c_int
        lib.token_cache_stat.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.token_cache_open.restype = ctypes.c_int
        lib.token_cache_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.token_cache_close.restype = None
        lib.token_cache_close.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        _LIB = lib
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain → Python twin
        detail = ""
        stderr = getattr(e, "stderr", None)
        if stderr:
            detail = ": " + stderr.decode(errors="replace")[-500:]
        print(f"[native] build/load failed ({type(e).__name__}{detail}), "
              "using Python fallbacks")
        _LIB = None
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


class TokenCacheView:
    """Zero-copy view over an open native token cache. `offsets` and `flat`
    are numpy arrays aliasing the mapping — valid until `close()`."""

    def __init__(self, base, length, offsets, flat, n_rows):
        self._base, self._len = base, length
        self.offsets, self.flat, self.n_rows = offsets, flat, n_rows

    def row(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i]:self.offsets[i + 1]]

    def close(self):
        lib = _build_and_load()
        if lib is not None and self._base:
            lib.token_cache_close(self._base, self._len)
            self._base = None

    def __del__(self):  # cache-hit loads must not leak the mapping
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: module globals may be gone

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def flatten_rows(rows) -> tuple[np.ndarray, np.ndarray]:
    """(offsets int64 [n+1], flat int32) of a ragged corpus — the one
    flattening both cache writers share, so they write identical bytes."""
    lens = np.asarray([len(r) for r in rows], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(r, np.int32) for r in rows])
        if len(rows) and offsets[-1] else np.empty(0, np.int32)
    )
    return offsets, flat


def token_cache_write_native(path: str, rows, fingerprint: int) -> bool:
    """Write a ragged int32 corpus to the cache file (atomic). False
    without the library or on a write error."""
    lib = _build_and_load()
    if lib is None:
        return False
    offsets, flat = flatten_rows(rows)
    rc = lib.token_cache_write(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(rows), ctypes.c_uint64(fingerprint & (2**64 - 1)),
    )
    return rc == 0


def token_cache_open_native(path: str, fingerprint: int) -> TokenCacheView | None:
    """mmap an existing cache; None when missing, corrupt, of another
    fingerprint, or without the library."""
    lib = _build_and_load()
    if lib is None or not os.path.exists(path):
        return None
    base = ctypes.c_void_p()
    length = ctypes.c_int64()
    off_p = ctypes.POINTER(ctypes.c_int64)()
    flat_p = ctypes.POINTER(ctypes.c_int32)()
    n_rows = ctypes.c_int64()
    rc = lib.token_cache_open(
        path.encode(), ctypes.c_uint64(fingerprint & (2**64 - 1)),
        ctypes.byref(base), ctypes.byref(length), ctypes.byref(off_p),
        ctypes.byref(flat_p), ctypes.byref(n_rows),
    )
    if rc != 0:
        return None
    n = n_rows.value
    offsets = np.ctypeslib.as_array(off_p, shape=(n + 1,))
    flat = np.ctypeslib.as_array(flat_p, shape=(int(offsets[n]),)) \
        if offsets[n] else np.empty(0, np.int32)
    return TokenCacheView(base, length.value, offsets, flat, n)
