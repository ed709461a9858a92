"""The compiled decode loop — the port's counterpart of the `jax.jit` around
JAX's decode `while_loop`s (the monolithic loop, `sampler.py`; speculative
decode, `speculative.py`; the queued session's chunks, `paged/session.py`).

Each loop has one body: one iteration over state that lives on the device,
updated in place, predicated on a device flag (an inactive iteration
changes nothing a later iteration or the caller reads), and reading nothing
back to the host. The loop runs it in chunks of `sync_every` iterations
with one host check between chunks — the counterpart of JAX's loop, whose
condition the device evaluates, and of its queued session's `sync_every`
chunks:

  * on CUDA tensors the first chunk runs eagerly — the warm-up: kernels
    build, load and set their attributes, cuBLAS picks its plans, outside
    capture — then one chunk is captured into a `torch.cuda.CUDAGraph`
    and replayed until the host check says stop. The rollout's generator
    is registered with the graph, so each replay draws fresh Philox
    offsets. A capture or replay that fails raises, naming the error and
    the last kernel the capture launched: nothing falls back to an eager
    loop on the card;
  * on CPU tensors every chunk runs eagerly (the path the CPU tests hold).

`decode_loop="per_step"` runs the same body once per step with a host
check before each — the plain version the chunked loop is held against.

Kernel launches: a capture enqueues nothing, so its launches are recorded
(`_build.recording_launches`) and each replay adds them to the counts
(`_build.add_launches`): `launch_counts()` counts what the device ran,
a chunk's predicated-off tail included. `steps_run` is sync_every × the
chunks run (the warm-up chunk and every replay); `pool_bytes` is the
device memory the capture reserved, the graph's private pool of the
chunk's temporaries, held until the loop is dropped.

Threads: rollout producers and fleet workers capture their decode chunks
on their own threads while the trainer's thread runs the update. A
capture begins in CUDA's "thread_local" error mode, so only the capturing
thread is barred from calls that are unsafe during a capture (an
allocation, a synchronize, a host read); in the default "global" mode the
trainer's allocations would fail while any worker captures. The cyclic
collector is paused across every capture in flight by one shared count
(`_collector_paused`): the last capture to end re-enables it, and the
collection before a capture runs only when no other capture is in flight.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

from nanorlhf_tpu_torch._build import add_launches, recording_launches

SYNC_EVERY = 8          # iterations between host checks (JAX's default)
DECODE_LOOPS = ("chunked", "per_step")


_GC_LOCK = threading.Lock()
_gc_pause = {"depth": 0, "was_enabled": False}


@contextlib.contextmanager
def _collector_paused():
    """Pause the cyclic collector for one capture, counting the captures in
    flight on every thread: an unreachable cycle holding a CUDA graph (an
    earlier session's loop) destroyed mid-capture invalidates the capture.
    The first capture collects (as `torch.cuda.graph` does) and disables
    the collector; the last to end restores it."""
    with _GC_LOCK:
        if _gc_pause["depth"] == 0:
            gc.collect()
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["depth"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _gc_pause["depth"] -= 1
            if _gc_pause["depth"] == 0 and _gc_pause["was_enabled"]:
                gc.enable()


def check_decode_loop(decode_loop: str, sync_every: int) -> None:
    if decode_loop not in DECODE_LOOPS:
        raise ValueError(f"decode_loop={decode_loop!r}: must be one of {DECODE_LOOPS}")
    if int(sync_every) < 1:
        raise ValueError(f"sync_every={sync_every}: must be >= 1")


class CudaGraphChunk:
    """One captured chunk on the card: a `torch.cuda.CUDAGraph` with the
    generator its body draws from registered, captured on a side stream."""

    def __init__(self, device, generator=None):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            register = getattr(self.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    f"torch {torch.__version__} has no "
                    "CUDAGraph.register_generator_state: the decode loop's "
                    "draws cannot come from the rollout's generator inside a "
                    "graph")
            register(generator)

    def capture(self, fn) -> None:
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # "thread_local": other threads (the trainer, other workers)
            # may allocate and synchronize while this thread captures
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:  # noqa: BLE001 — the body's error is the one to raise
                    pass
                raise
            self.graph.capture_end()
        current.wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()


class ChunkedLoop:
    """Runs `body` in chunks of `sync_every` iterations: the first eagerly,
    every later one as a replay of one captured graph when `use_graph`
    (CUDA tensors), all eagerly otherwise. `graph_factory()` makes the
    graph object (`capture(fn)`, `replay()`); tests pass a stand-in."""

    def __init__(self, body, *, sync_every: int, device, generator=None,
                 what: str = "decode", use_graph: bool | None = None,
                 graph_factory=None):
        self.body = body
        self.sync_every = int(sync_every)
        self.what = what
        self.device = device = torch.device(device)
        self.use_graph = device.type == "cuda" if use_graph is None else use_graph
        self.graph_factory = graph_factory or (lambda: CudaGraphChunk(device, generator))
        self.graph = None
        self.captured: dict[str, int] = {}   # kernel launches of one replay
        self.chunks = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0   # device memory the capture reserved (its private pool)

    @property
    def steps_run(self) -> int:
        """Body iterations launched: sync_every per chunk."""
        return self.chunks * self.sync_every

    def _chunk(self) -> None:
        for _ in range(self.sync_every):
            self.body()

    def _reserved(self) -> int:
        on_card = self.device.type == "cuda"
        return torch.cuda.memory_reserved(self.device) if on_card else 0

    def _capture(self) -> None:
        t0 = time.perf_counter()
        reserved = self._reserved()
        graph = self.graph_factory()
        # the cyclic collector must not run inside a capture: an unreachable
        # cycle that holds a CUDA graph (an earlier session's loop) would be
        # destroyed mid-capture, which CUDA forbids and which invalidates
        # the capture — collected first, paused until every capture ends
        with _collector_paused(), recording_launches() as rec:
            try:
                graph.capture(self._chunk)
            except Exception as e:
                at = f"; last kernel launched in the capture: {rec.last}" if rec.last else ""
                raise RuntimeError(f"CUDA graph capture of the {self.what} chunk failed: "
                                   f"{type(e).__name__}: {e}{at}") from e
        self.graph, self.captured = graph, dict(rec)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes = self._reserved() - reserved

    def run_chunk(self) -> None:
        """One chunk of `sync_every` iterations, with no host read."""
        if self.use_graph and self.chunks > 0:
            if self.graph is None:
                self._capture()
            try:
                self.graph.replay()
            except Exception as e:
                raise RuntimeError(f"CUDA graph replay of the {self.what} chunk failed: "
                                   f"{type(e).__name__}: {e}") from e
            add_launches(self.captured)
            self.replays += 1
        else:
            self._chunk()
        self.chunks += 1

    def record(self, timings: dict | None) -> None:
        """Add this loop's `graph_capture_s`, `graph_steps_run` and
        `graph_replays` to `timings`, and its `graph_pool_bytes`."""
        if timings is None:
            return
        timings["graph_capture_s"] = timings.get("graph_capture_s", 0.0) + self.capture_s
        timings["graph_steps_run"] = timings.get("graph_steps_run", 0) + self.steps_run
        timings["graph_replays"] = timings.get("graph_replays", 0) + self.replays
        timings["graph_pool_bytes"] = timings.get("graph_pool_bytes", 0) + self.pool_bytes


def run_loop(body, is_active, *, sync_every: int, decode_loop: str, device,
             generator=None, what: str = "decode", timings: dict | None = None) -> None:
    """Run `body` until `is_active()` (the loop's host check) is False:
    chunked (`ChunkedLoop`, one check per chunk) or per step (one check
    before every iteration)."""
    check_decode_loop(decode_loop, sync_every)
    loop = ChunkedLoop(body, sync_every=sync_every, device=device, generator=generator,
                       what=what)
    step = body if decode_loop == "per_step" else loop.run_chunk
    while is_active():
        step()
    loop.record(timings)
