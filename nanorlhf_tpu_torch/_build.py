"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under `csrc/` is compiled on its own into a shared library with
a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`),
named by a hash of the source so an edited kernel never loads a stale
build. The libraries go to `_build/` beside this file (git-ignored) at first
use; `build_all()` starts one nvcc per source at once. Nothing here runs at
import time: the CPU tests import every module of the port.

`KERNELS` is the registry the wrappers launch through. Each `Kernel` counts
its successful launches (`launches`), which is how `chip_smoke.py` shows
that the main path really ran on the kernels. Several kernels may share
one source (the flash backward's `dq` and `dkv` live in `flash_bwd.cu`):
each keeps its own counter, the source is built once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from csrc/ at first use and cannot run without the CUDA toolkit")


class Kernel:
    """One CUDA source, its shared library, and its launch counter."""

    def __init__(self, name: str, replaces: str, source: str | None = None):
        self.name = name
        self.replaces = replaces  # the Pallas kernel this one ports
        self.source_name = source or name
        self.source = SRC_DIR / f"{self.source_name}.cu"
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fns: dict[str, ctypes._CFuncPtr] = {}

    @property
    def repo_source(self) -> str:
        return f"nanorlhf_tpu_torch/csrc/{self.source_name}.cu"

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source_name}-{digest}.so"

    def compile_command(self, out: Path) -> list[str]:
        return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3",
                "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                "-o", str(out), str(self.source)]

    def start_build(self):
        """Start nvcc (returns the Popen and its temp output), or None when
        the library for this exact source is already built."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(self.compile_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> None:
        proc, tmp = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.library_path())

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            started = self.start_build()
            if started is not None:
                self.finish_build(started)
            self._lib = ctypes.CDLL(str(self.library_path()))
        return self._lib

    def function(self, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(self.load(), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return fn

    def launch(self, symbol: str, argtypes: list, *args) -> None:
        """Call the C launcher; it returns the CUDA error code of the
        launch (0 = launched). Raises on anything else."""
        err = self.function(symbol, argtypes)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}.{symbol} failed to launch: CUDA error {err}")
        self.launches += 1


KERNELS = {
    "flash_fwd": Kernel(
        "flash_fwd", "nanorlhf_tpu/ops/attention.py:91 _flash_kernel"),
    "decode_attention": Kernel(
        "decode_attention",
        "nanorlhf_tpu/ops/decode_attention.py:61 _decode_kernel"),
    "fused_logprob": Kernel(
        "fused_logprob", "nanorlhf_tpu/ops/fused_logprob.py:228 _fused_kernel"),
    "flash_bwd_dq": Kernel(
        "flash_bwd_dq", "nanorlhf_tpu/ops/attention.py:230 _dq_kernel",
        source="flash_bwd"),
    "flash_bwd_dkv": Kernel(
        "flash_bwd_dkv", "nanorlhf_tpu/ops/attention.py:282 _dkv_kernel",
        source="flash_bwd"),
}


def build_all() -> float:
    """Compile every kernel not yet built, all nvcc processes at once, and
    load them. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    by_source = {k.source_name: k for k in KERNELS.values()}
    started = {src: k.start_build() for src, k in by_source.items()}
    failures = []
    for src, s in started.items():
        if s is None:
            continue
        try:
            by_source[src].finish_build(s)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    for k in KERNELS.values():
        k.build_log = by_source[k.source_name].build_log
        k.load()
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def cuda_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())
