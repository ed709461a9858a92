"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under `csrc/` is compiled on its own into a shared library with
a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`),
named by a hash of the source and of every `csrc/` header it includes
(`hopper_ptx.cuh`, shared by the flash kernels), so an edited kernel or
header never loads a stale build. The libraries go to `_build/` beside this
file (git-ignored) at first use; `build_all()` starts one nvcc per source at
once. Nothing here runs at import time: the CPU tests import every module of
the port.

`KERNELS` is the registry the wrappers launch through. Each `Kernel` counts
its successful launches (`launches`), which is how `chip_smoke.py` shows
that the main path really ran on the kernels. A launch made while a CUDA
graph is captured enqueues nothing: inside `recording_launches()` it is
recorded instead of counted, and each replay of the graph adds what was
recorded (`add_launches`), so the counts stay the launches the device
ran. Recording is per thread (a rollout thread capturing its decode chunk
does not swallow the launches the trainer's thread makes meanwhile), and
the counters and the library loads are guarded by one lock. Several kernels may share one source (the flash backward's `dq` and
`dkv` live in `flash_bwd.cu`, the four decode and two verify kernels in
`decode_attention.cu`): each keeps its own counter, the source is built
once.

A build and a library load each report their seconds to the listeners
registered with `on_compile` (the trainer's `perf/recompiles` counter,
`telemetry/mfu.py`): the port's counterpart of XLA's backend compiles.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_closure(source: Path) -> list[Path]:
    """`source` and every header beside it that it includes, directly or
    through another such header, in the order first reached."""
    order: list[Path] = []
    todo = [source]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / name.decode()
            if dep.is_file():
                todo.append(dep)
    return order


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


_compile_listeners: list = []


def on_compile(listener) -> None:
    """Call `listener(what, seconds)` after every nvcc build and every
    library load of this process from now on."""
    _compile_listeners.append(listener)


def _notify_compile(what: str, seconds: float) -> None:
    for listener in list(_compile_listeners):
        listener(what, seconds)


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
        h = hashlib.sha1()
        for path in source_closure(self.source):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"lib{self.source_name}-{h.hexdigest()[:12]}.so"

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
        t0 = time.perf_counter()
        proc = subprocess.Popen(self.compile_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, t0

    def finish_build(self, started) -> None:
        proc, tmp, t0 = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.library_path())
        _notify_compile(f"nvcc {self.source_name}", time.perf_counter() - t0)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with _LOAD_LOCK:  # one build and one load, whichever thread asks
                if self._lib is None:
                    started = self.start_build()
                    if started is not None:
                        self.finish_build(started)
                    t0 = time.perf_counter()
                    self._lib = ctypes.CDLL(str(self.library_path()))
                    _notify_compile(f"load {self.name}", time.perf_counter() - t0)
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
        recording = _stack()
        if recording:
            recording[-1][self.name] += 1
            recording[-1].last = self.name
        else:
            with _COUNT_LOCK:
                self.launches += 1


KERNELS = {
    "flash_fwd": Kernel(
        "flash_fwd", "nanorlhf_tpu/ops/attention.py:91 _flash_kernel"),
    "decode_attention": Kernel(
        "decode_attention",
        "nanorlhf_tpu/ops/decode_attention.py:61 _decode_kernel"),
    "paged_decode_attention": Kernel(
        "paged_decode_attention",
        "nanorlhf_tpu/ops/decode_attention.py:537 _paged_decode_kernel",
        source="decode_attention"),
    "decode_attention_q8": Kernel(
        "decode_attention_q8",
        "nanorlhf_tpu/ops/decode_attention.py:124 _decode_q8_kernel",
        source="decode_attention"),
    "paged_decode_attention_q8": Kernel(
        "paged_decode_attention_q8",
        "nanorlhf_tpu/ops/decode_attention.py:546 _paged_decode_q8_kernel",
        source="decode_attention"),
    "decode_verify_attention": Kernel(
        "decode_verify_attention",
        "nanorlhf_tpu/ops/decode_attention.py:280 _verify_kernel",
        source="decode_attention"),
    "paged_decode_verify_attention": Kernel(
        "paged_decode_verify_attention",
        "nanorlhf_tpu/ops/decode_attention.py:555 _paged_verify_kernel",
        source="decode_attention"),
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


class LaunchRecord(collections.Counter):
    """Kernel launches recorded during a capture, by kernel name; `last`
    names the latest (the kernel at fault when a capture fails)."""
    last: str | None = None


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_tls = threading.local()


def _stack() -> list[LaunchRecord]:
    """This thread's open recordings, innermost last."""
    return _tls.__dict__.setdefault("items", [])


@contextlib.contextmanager
def recording_launches():
    """Inside, this thread's launches are recorded into the yielded
    `LaunchRecord` instead of counted (a CUDA-graph capture: nothing runs
    yet)."""
    rec = LaunchRecord()
    _stack().append(rec)
    try:
        yield rec
    finally:
        _stack().remove(rec)


def add_launches(counts: dict[str, int]) -> None:
    """Count one run of recorded launches (a replay of a graph)."""
    with _COUNT_LOCK:
        for name, n in counts.items():
            KERNELS[name].launches += n


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return {name: k.launches for name, k in KERNELS.items()}


def cuda_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())
