"""Process groups over `torch.distributed` — the port of
`nanorlhf_tpu/parallel/distributed.py` (`initialize_multihost`,
`broadcast_host_value`), plus the transport the sequence-parallel ring and
the gradient sum ride on, and `spawn`, which runs a function on N ranks.

The backend is explicit, so nothing changes transport silently:

  * NCCL where every rank owns its own GPU;
  * gloo on the CPU;
  * gloo for ranks that share one card (NCCL refuses two ranks on one
    device): each CUDA tensor is staged through pinned host memory for the
    collective (`Transport`).

`initialize_multihost` reads the `torchrun` environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`) or explicit arguments, and
does nothing for a world of 1.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))


def ranks_share_card() -> bool:
    """More ranks on this host than visible cards: they share one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return n > 0 and _local_world() > n


def choose_backend(device) -> str:
    """NCCL for CUDA ranks that each own a card; gloo on the CPU and for
    ranks that share a card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "gloo" if ranks_share_card() else "nccl"


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on: `cuda:<LOCAL_RANK mod cards>` (one
    card shared by all ranks when there is only one), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def initialize_multihost(init_method: str | None = None, world: int | None = None,
                         rank: int | None = None, backend: str | None = None,
                         device="cuda") -> dict:
    """Bring up the default process group (no-op for a world of 1 or when it
    is up already). Returns JAX's summary dict plus the backend:
    process_index, process_count, local_device_count, global_device_count,
    backend."""
    world = int(world if world is not None else os.environ.get("WORLD_SIZE", 1))
    if world > 1 and not is_distributed():
        rank = int(rank if rank is not None else os.environ["RANK"])
        backend = backend or choose_backend(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank)
        print(f"[distributed] rank {rank}/{world}: backend {backend}"
              + (", ranks share one card (tensors staged through pinned host memory)"
                 if backend == "gloo" and torch.device(device).type == "cuda" else ""))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "process_index": dist.get_rank() if is_distributed() else 0,
        "process_count": world_size(),
        "local_device_count": max(1, cards),
        "global_device_count": world_size(),
        "backend": dist.get_backend() if is_distributed() else None,
    }


def broadcast_host_value(value: int) -> int:
    """Agree on rank 0's value (the run-timestamp broadcast)."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        t = t.to(rank_device())
    dist.broadcast(t, 0)
    return int(t.item())


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank of the world (a MAX all-reduce;
    every rank must call it at the same point)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        t = t.to(rank_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class Transport:
    """The collectives of one group over its backend. Under gloo a CUDA
    tensor goes through a pinned host buffer (`_host` / `_back`); under
    NCCL and for CPU tensors it goes as it is. `hop_s` accumulates the
    seconds spent waiting for ring hops, `hops` counts them; `op_s` the
    seconds of the gathers, reduce-scatters and all-reduces by op."""

    def __init__(self, group, backend: str):
        self.group = group
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)
        self._pinned: dict = {}
        self.hop_s = 0.0
        self.hops = 0
        self.op_s: dict = {}

    def _timed(self, op: str, t0: float) -> None:
        self.op_s[op] = self.op_s.get(op, 0.0) + time.perf_counter() - t0

    def staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend != "nccl"

    def _buffer(self, key, nbytes: int) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=torch.cuda.is_available())
            self._pinned[key] = buf
        return buf[:nbytes]

    def _host(self, flat: torch.Tensor, key) -> torch.Tensor:
        """A flat device byte tensor copied into a pinned host buffer."""
        host = self._buffer(key, flat.numel())
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        return host

    def all_reduce_sum_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor over the group, in place (one flat f32 buffer)."""
        if not tensors:
            return
        t0 = time.perf_counter()
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        if self.staged(flat):
            host = self._host(flat.view(torch.uint8), "reduce").view(torch.float32)
            dist.all_reduce(host, group=self.group)
            flat.copy_(host, non_blocking=True)
        else:
            dist.all_reduce(flat, group=self.group)
        i = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[i:i + n].view(t.shape))
            i += n
        if flat.is_cuda:
            torch.cuda.current_stream(flat.device).synchronize()
        self._timed("all_reduce", t0)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's copy of `t` (detached), in rank order."""
        t = t.detach().contiguous()
        if self.staged(t):
            host = t.cpu()
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            return [p.to(t.device, non_blocking=True) for p in parts]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The tiled all-gather: every rank's `t` concatenated along `dim`
        in rank order (detached; the bytes travel, so any dtype goes)."""
        t0 = time.perf_counter()
        x = t.detach().movedim(dim, 0).contiguous()
        flat = x.reshape(-1).view(torch.uint8)
        staged = self.staged(flat)
        src = self._host(flat, "gather_in") if staged else flat
        out = torch.empty((self.size, flat.numel()), dtype=torch.uint8, device=src.device)
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        if staged:
            out = out.to(t.device, non_blocking=True)
        full = out.view(t.dtype).reshape((self.size * x.shape[0],) + tuple(x.shape[1:]))
        self._timed("all_gather", t0)
        return full.movedim(0, dim).contiguous()

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of `t` over the group, cut along `dim` into `size`
        contiguous blocks: this rank's block, in f32 (the transpose of
        `all_gather_dim`). NCCL reduce-scatters; gloo all-reduces the whole
        tensor and keeps the block (it has no reduce-scatter)."""
        t0 = time.perf_counter()
        x = t.detach().float().movedim(dim, 0).contiguous()
        n = x.shape[0] // self.size
        if self.backend == "nccl":
            out = torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x, group=self.group)
        else:
            if self.staged(x):
                host = self._host(x.reshape(-1).view(torch.uint8), "scatter")
                host = host.view(torch.float32)
                dist.all_reduce(host, group=self.group)
                out = host.view(x.shape)[self.rank * n:(self.rank + 1) * n].to(
                    t.device, non_blocking=True)
            else:
                dist.all_reduce(x, group=self.group)
                out = x[self.rank * n:(self.rank + 1) * n]
        self._timed("reduce_scatter", t0)
        return out.movedim(0, dim).contiguous()

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` with the group's rank `src`'s copy, in place."""
        flat = t.detach().reshape(-1).view(torch.uint8)
        if self.staged(flat):
            host = self._host(flat, "broadcast")
            dist.broadcast(host, dist.get_global_rank(self.group, src), group=self.group)
            flat.copy_(host, non_blocking=True)
        else:
            dist.broadcast(flat, dist.get_global_rank(self.group, src), group=self.group)
        return t

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def ring_start(self, tensors: list[torch.Tensor], tag: int) -> "_Hop":
        """Send `tensors` to the next rank and receive the previous rank's
        (same shapes and dtypes), asynchronously: one packed message each way
        (`dist.batch_isend_irecv`). `.wait()` returns the received tensors."""
        return _Hop(self, tensors, tag)


def _pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, i = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[i:i + n].view(t.dtype).view(t.shape))
        i += n
    return out


class _Hop:
    def __init__(self, tr: Transport, tensors: list[torch.Tensor], tag: int):
        self.tr, self.like, self.t0 = tr, tensors, time.perf_counter()
        flat = _pack(tensors)
        self.device = flat.device
        if tr.staged(flat):
            send = tr._host(flat, ("send", tag))
            recv = tr._buffer(("recv", tag), flat.numel())
        else:
            send, recv = flat, torch.empty_like(flat)
        self.recv = recv
        self._send = send  # held until the hop completes
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, tr._next, tr.group, tag),
            dist.P2POp(dist.irecv, recv, tr._prev, tr.group, tag)])

    def wait(self) -> list[torch.Tensor]:
        for w in self.works:
            w.wait()
        flat = self.recv
        if flat.device != self.device:
            # out of the pinned buffer; the next hop's staging synchronizes
            # the stream before it reuses the buffer
            flat = flat.to(self.device, non_blocking=True)
        self.tr.hop_s += time.perf_counter() - self.t0
        self.tr.hops += 1
        return _unpack(flat, self.like)


# ---------------------------------------------------------------------------
# spawn: a function on N ranks (chip_smoke.py and the tests)
# ---------------------------------------------------------------------------

def _spawned(fn, rank: int, world: int, store_path: str, backend: str, timeout: float,
             args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which kills the group
        results.put((rank, False, traceback.format_exc()))
    finally:
        if is_distributed():
            dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, timeout: float = 120.0,
          store_dir: str | None = None, backend: str = "gloo") -> list:
    """Run `fn(rank, world, *args)` on `world` spawned processes (never
    forked) joined into one process group through a `FileStore` under
    `store_dir` (a fresh temporary directory by default), and return the
    results in rank order. `fn` must be importable by name in a fresh
    interpreter and its result picklable. The first rank that fails, a rank
    that dies, or the `timeout` (seconds) kills every rank and raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store_dir = store_dir or tempfile.mkdtemp(prefix="spawn_store_")
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(fn, r, world, store_path, backend, timeout, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict = {}

    def kill_all():
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)

    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world - len(got)} of {world} ranks did not "
                                   f"finish within {timeout:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} exited "
                                       f"({[procs[r].exitcode for r in dead]}) "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{val}")
            got[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        kill_all()
    return [got[r] for r in range(world)]
