"""Isolated-subprocess execution of model-emitted Python — program-of-thought
grading.

(the port's copy of `nanorlhf_tpu/rewards/python_executor.py`.)

Capability parity with the vendored Qwen eval toolkit's `PythonExecutor`
(the reference's `examples/r1-v0/utils/eval/python_executor.py:42`): run a
code snippet in a killable subprocess with a wall-clock timeout, capture the
value of an `answer` variable (or stdout), never let model code crash the
training process. Host-side only.

Containment = process isolation + wall-clock timeout + child resource limits
(CPU seconds, address space, file size) + a scratch working directory. This
is NOT a security sandbox: the child still has host filesystem/network
access with the parent's credentials (same as the reference toolkit) — run
untrusted-model graders inside a containerized host if that matters.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from io import StringIO


@dataclass
class ExecutionResult:
    ok: bool
    answer: str = ""
    stdout: str = ""
    error: str = ""


def _apply_child_limits(cpu_seconds: int, mem_bytes: int | None):
    """Best-effort rlimits in the exec child: bound CPU burn and accidental
    giant file writes. Failures are ignored — limits are hardening, not the
    containment boundary.

    RLIMIT_AS is OPT-IN (`mem_bytes`): under the (non-default) fork context
    the child inherits the training process's mapped virtual address space
    (JAX/TPU runtime), which routinely exceeds any sane fixed cap — a
    default AS limit below the inherited mappings would fail every snippet
    with MemoryError. Spawn children are clean, but the default stays
    opt-in so both contexts behave identically.
    """
    try:
        import resource

        resource.setrlimit(resource.RLIMIT_CPU, (cpu_seconds, cpu_seconds + 1))
        if mem_bytes is not None:
            resource.setrlimit(resource.RLIMIT_AS, (mem_bytes, mem_bytes))
        resource.setrlimit(resource.RLIMIT_FSIZE, (64 * 1024**2, 64 * 1024**2))
    except Exception:
        pass
    try:
        scratch = tempfile.mkdtemp(prefix="nanorlhf_exec_")
        os.chdir(scratch)
    except Exception:
        pass


def _exec_worker(code: str, answer_expr: str | None, q,
                 cpu_seconds: int = 10, mem_bytes: int | None = None,
                 ready=None):
    if ready is not None:
        # bootstrap fence: under the spawn context the child re-imports the
        # parent's __main__ before this line runs (seconds, if the launcher
        # module pulls jax) — the parent starts the snippet's wall-clock
        # timeout only once this fires, so bootstrap cost is never charged
        # against the snippet's budget
        ready.set()
    _apply_child_limits(cpu_seconds, mem_bytes)
    buf = StringIO()
    old_stdout = sys.stdout
    sys.stdout = buf
    try:
        glb: dict = {"__name__": "__main__"}
        exec(code, glb)  # noqa: S102 — isolated subprocess + timeout + rlimits
        answer = ""
        if answer_expr:
            try:
                answer = repr(eval(answer_expr, glb))  # noqa: S307
            except Exception:
                answer = ""
        elif "answer" in glb:
            answer = repr(glb["answer"])
        q.put(("ok", answer, buf.getvalue()))
    except Exception:
        q.put(("err", "", buf.getvalue() + "\n" + traceback.format_exc()))
    finally:
        sys.stdout = old_stdout


def _pool_worker(jobs, results, answer_expr: str | None,
                 cpu_seconds: int, mem_bytes: int | None, ready):
    """Persistent exec loop: one spawn bootstrap, many snippets.

    Same body as `_exec_worker` per job, but the ready handshake and the
    rlimit/scratch-dir setup are paid ONCE; after that each job is a
    (job_id, code) → (job_id, status, answer, stdout) round trip. A None
    job is the shutdown sentinel. NOTE: RLIMIT_CPU is cumulative across
    every snippet this worker ever runs — the parent's per-job wall-clock
    timeout plus terminate→kill reaping is the real per-job bound, and a
    worker killed mid-job is simply respawned on the next call.
    """
    ready.set()
    _apply_child_limits(cpu_seconds, mem_bytes)
    while True:
        job = jobs.get()
        if job is None:
            return
        job_id, code = job
        buf = StringIO()
        old_stdout = sys.stdout
        sys.stdout = buf
        try:
            glb: dict = {"__name__": "__main__"}
            exec(code, glb)  # noqa: S102 — isolated subprocess + timeout + rlimits
            answer = ""
            if answer_expr:
                try:
                    answer = repr(eval(answer_expr, glb))  # noqa: S307
                except Exception:
                    answer = ""
            elif "answer" in glb:
                answer = repr(glb["answer"])
            results.put((job_id, "ok", answer, buf.getvalue()))
        except Exception:
            results.put((job_id, "err", "",
                         buf.getvalue() + "\n" + traceback.format_exc()))
        finally:
            sys.stdout = old_stdout


class PythonExecutor:
    """`run(code)` → ExecutionResult; `timeout` seconds per snippet.

    Children come from the `spawn` multiprocessing context: grader workers
    run inside the training process, and a fork would duplicate the mapped
    JAX/TPU runtime state (device handles, the libtpu lock, orbax's async
    machinery) into a child that then exec's arbitrary model code — the
    classic fork-after-threads hazard. `spawn` starts from a clean
    interpreter, BUT its bootstrap re-imports the parent's __main__ module
    — seconds when training launched via `python -m nanorlhf_tpu_torch.
    entrypoints.*` (the `__main__` guard stops re-training, not the
    module-level jax imports). The snippet timeout therefore only starts
    at the child's ready handshake; `bootstrap_timeout` bounds the respawn
    itself. Pass mp_context="fork" only in jax-free host tools that need
    the lower startup latency."""

    def __init__(self, timeout: float = 5.0, answer_expr: str | None = None,
                 cpu_seconds: int = 10, mem_bytes: int | None = None,
                 mp_context: str = "spawn", term_grace: float = 2.0,
                 bootstrap_timeout: float = 60.0):
        self.timeout = timeout
        self.answer_expr = answer_expr
        self.cpu_seconds = cpu_seconds
        self.mem_bytes = mem_bytes
        self.mp_context = mp_context
        self.term_grace = term_grace
        self.bootstrap_timeout = bootstrap_timeout

    def run(self, code: str) -> ExecutionResult:
        ctx = multiprocessing.get_context(self.mp_context)
        q = ctx.Queue()
        ready = ctx.Event()
        p = ctx.Process(
            target=_exec_worker,
            args=(code, self.answer_expr, q, self.cpu_seconds, self.mem_bytes,
                  ready),
        )
        p.start()
        # bootstrap is metered separately from the snippet (spawn re-import
        # cost must not eat the grading budget). Poll in short slices with a
        # liveness check: a child that dies during bootstrap never sets
        # `ready`, and a blind wait would stall the full bootstrap budget
        # per snippet; a dead child falls straight through to the result
        # read below ("no result").
        deadline = time.monotonic() + self.bootstrap_timeout
        while (not ready.is_set() and p.is_alive()
               and time.monotonic() < deadline):
            ready.wait(0.05)
        p.join(self.timeout)
        if p.is_alive():
            from nanorlhf_tpu_torch.resilience import reap_process

            reap_process(p, self.term_grace)
            return ExecutionResult(ok=False, error=f"timeout after {self.timeout}s")
        try:
            status, answer, stdout = q.get(timeout=0.5)
        except Exception:
            return ExecutionResult(ok=False, error="no result (crashed?)")
        if status == "ok":
            return ExecutionResult(ok=True, answer=answer, stdout=stdout)
        return ExecutionResult(ok=False, stdout=stdout, error=stdout)


class PooledPythonExecutor:
    """`run(code)` against ONE warm worker process reused across calls.

    The spawn-context bootstrap fence in `PythonExecutor` costs seconds per
    child (the re-import of the parent's __main__ pulls jax); a terminal
    grader pays that once per sample, but a mid-episode tool
    (envs/python_tool.py) would pay it once per TURN. Here the fence is
    paid once at (re)spawn: steady-state calls are a queue round trip into
    the warm worker. The containment story is unchanged — same rlimits,
    same per-call wall-clock `timeout`, same terminate→kill escalation
    (`reap_process`) on overrun; a reaped worker is respawned lazily on
    the next call, and monotonically increasing job ids let the parent
    discard any stale result a killed worker managed to flush.

    `run` is serialized under `make_lock("rewards.executor")` (declared in
    analysis/lockorder.py) so the multi-turn driver's tool threads share
    one warm worker safely; it never acquires other project locks.
    """

    def __init__(self, timeout: float = 5.0, answer_expr: str | None = None,
                 cpu_seconds: int = 60, mem_bytes: int | None = None,
                 mp_context: str = "spawn", term_grace: float = 2.0,
                 bootstrap_timeout: float = 60.0):
        from nanorlhf_tpu_torch.analysis.lockorder import make_lock

        self.timeout = timeout
        self.answer_expr = answer_expr
        # default cpu_seconds is higher than PythonExecutor's: RLIMIT_CPU
        # accumulates over the worker's whole life, not per snippet
        self.cpu_seconds = cpu_seconds
        self.mem_bytes = mem_bytes
        self.mp_context = mp_context
        self.term_grace = term_grace
        self.bootstrap_timeout = bootstrap_timeout
        self._lock = make_lock("rewards.executor")
        self._proc = None
        self._jobs = None
        self._results = None
        self._next_job = 0

    @property
    def worker_pid(self) -> int | None:
        """Pid of the live worker (None before first run / after reap) —
        the pooling regression test pins this constant across calls."""
        p = self._proc
        return p.pid if p is not None and p.is_alive() else None

    def _ensure_worker(self) -> bool:
        if self._proc is not None and self._proc.is_alive():
            return True
        ctx = multiprocessing.get_context(self.mp_context)
        self._jobs = ctx.Queue()
        self._results = ctx.Queue()
        ready = ctx.Event()
        self._proc = ctx.Process(
            target=_pool_worker,
            args=(self._jobs, self._results, self.answer_expr,
                  self.cpu_seconds, self.mem_bytes, ready),
            daemon=True,
        )
        self._proc.start()
        deadline = time.monotonic() + self.bootstrap_timeout
        while (not ready.is_set() and self._proc.is_alive()
               and time.monotonic() < deadline):
            ready.wait(0.05)
        return ready.is_set()

    def _reap(self):
        from nanorlhf_tpu_torch.resilience import reap_process

        if self._proc is not None:
            reap_process(self._proc, self.term_grace)
        self._proc = None

    def run(self, code: str) -> ExecutionResult:
        with self._lock:
            if not self._ensure_worker():
                self._reap()
                return ExecutionResult(ok=False, error="worker bootstrap failed")
            job_id = self._next_job
            self._next_job += 1
            self._jobs.put((job_id, code))
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    rid, status, answer, stdout = self._results.get(
                        timeout=max(0.0, deadline - time.monotonic()) + 0.05)
                except Exception:
                    rid = None
                if rid == job_id:
                    if status == "ok":
                        return ExecutionResult(ok=True, answer=answer,
                                               stdout=stdout)
                    return ExecutionResult(ok=False, stdout=stdout,
                                           error=stdout)
                if rid is not None and rid < job_id:
                    continue  # stale flush from a previously killed job
                if not self._proc.is_alive():
                    self._reap()
                    return ExecutionResult(ok=False,
                                           error="no result (crashed?)")
                # timed out: kill the wedged worker; next call respawns
                self._reap()
                return ExecutionResult(
                    ok=False, error=f"timeout after {self.timeout}s")

    def close(self):
        with self._lock:
            if self._proc is not None and self._proc.is_alive():
                try:
                    self._jobs.put(None)
                    self._proc.join(self.term_grace)
                except Exception:
                    pass
                if self._proc.is_alive():
                    self._reap()
            self._proc = None
