"""Checkpoints with the reference's rotation and best-metric semantics —
the port of `nanorlhf_tpu/trainer/checkpoint.py`'s `CheckpointManager`.

What carries over: a checkpoint every `save_steps`, rotation to
`save_total_limit`, and `load_best_model_at_end` keyed on an `_old` metric,
whose value describes the PREVIOUS checkpoint — so a metric arriving with
save k is recorded against save k−1, and the best checkpoint (and the
newest, whose metric has not arrived yet) is never rotated away. The
metric history lives in `best_metric_history.json` so it survives a resume.
Writes are asynchronous by default with `io_retries` extra attempts each;
a failed write is absorbed at the next save; `restore` falls back from a
checkpoint that will not load to the newest earlier intact one; a resume
from an earlier step truncates the newer ones (`truncate_after`).

What differs: orbax is not on the card's machine, so the tree is one
`torch.save` file, `checkpoint-<step>/tree.pt`, written to a temporary
name and renamed last — a directory counts as committed only once
`tree.pt` exists. It holds the trainable leaves (the LoRA adapters and
the trained embeddings; the frozen base is the run's input, not its
output), PPO's value tree's trainable leaves under `value` (its adapters,
score head and embeddings) and the optimizer state, beside
`trainer_state.json`.

The async write: `save` copies every tensor of the tree into pinned host
buffers (allocated once per tree structure, reused only after the previous
write has joined), issuing the copies on the current stream and recording
an event after them — the optimizer steps the live leaves in place, so the
write must never read them. A writer thread waits on that event, writes
`tree.pt.tmp` and commits by `os.replace`. The next save, `restore`,
`latest_step`, `truncate_after` and `close` join the writer first. The
fault sites and tracer spans of JAX's manager are not ported.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time

import torch

from nanorlhf_tpu_torch.resilience.retry import retry_with_backoff

_TREE = "tree.pt"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _rebuild(tree, staged, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, staged, path + (k,)) for k, v in tree.items()}
    return staged.get(path, tree)


def write_tree(tree: dict, path: str) -> None:
    """Write a staged tree to `path`: a temporary file, renamed last."""
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def read_tree(path: str, device=None) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, output_dir: str, save_total_limit: int = 8,
                 greater_is_better: bool = True, async_save: bool = True,
                 io_retries: int = 2, retry_backoff: float = 0.5):
        self.output_dir = os.path.abspath(output_dir)
        self.save_total_limit = save_total_limit
        self.greater_is_better = greater_is_better
        self.async_save = async_save
        # io_retries EXTRA attempts with exponential backoff around each
        # write and read; retry_count counts them and the absorbed failures
        self.io_retries = io_retries
        self.retry_backoff = retry_backoff
        self.retry_count = 0
        # restore() falls back to older intact checkpoints: fallback_count
        # counts the skipped steps, last_restored_step is the one that loaded
        self.fallback_count = 0
        self.last_restored_step: int | None = None
        # the latest write's seconds on the writer (event wait + file write)
        self.last_write_s: float | None = None
        os.makedirs(self.output_dir, exist_ok=True)
        self._ckpt_dirs: list[str] = self._existing()
        # step -> metric measured ON that step's saved policy (arrives one
        # save later under the `_old` convention)
        self._metric_by_step: dict[int, float] = {}
        self._last_saved_step: int | None = None
        self._load_metric_history()
        self._staging: tuple | None = None  # (tree structure, pinned buffers)
        self._writer: threading.Thread | None = None
        # set by the writer, read by the main thread only after the join
        self._write_error: BaseException | None = None
        self._writer_retries = 0
        # exit barrier: a process that returns right after the last step
        # must not abandon the in-flight write; close() unregisters it
        atexit.register(self.wait)

    # ------------------------------------------------------------------ #
    # the writer
    # ------------------------------------------------------------------ #

    def wait(self) -> None:
        """Join the in-flight write; raise its failure (once)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self.retry_count += self._writer_retries
        self._writer_retries = 0
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    def _absorb_failed_save(self) -> None:
        """Join the in-flight write, ABSORBING its failure: the checkpoint
        never committed (`tree.pt` is renamed last), so only the
        bookkeeping needs repair — count the failure, drop the phantom step
        from the directories, the metrics and the last-saved step (else
        `best_step()` could protect, or the next `metric_old` score, a
        checkpoint with no tree), and remove the partial directory. The
        end-of-run flush (`train()`'s `ckpt.wait()`) stays raw, so a failed
        FINAL save raises."""
        try:
            self.wait()
        except Exception as e:
            self.retry_count += 1
            step = self._last_saved_step
            path = self.path(step)
            if not os.path.isfile(os.path.join(path, _TREE)):
                if path in self._ckpt_dirs:
                    self._ckpt_dirs.remove(path)
                shutil.rmtree(path, ignore_errors=True)
                self._metric_by_step.pop(step, None)
                committed = [self._step_of(d) for d in self._ckpt_dirs]
                self._last_saved_step = max(committed) if committed else None
                self._save_metric_history()
            print(f"[checkpoint] previous async save failed ({type(e).__name__}: "
                  f"{e}) — checkpoint {step} not committed; continuing")

    def _stage(self, tree: dict) -> tuple[dict, list]:
        """(tree with every tensor replaced by its host copy, events the
        writer must wait on). CUDA tensors go to pinned buffers through
        copies on the current stream; CPU tensors are copied at once."""
        tensors = [(p, t) for p, t in _leaves(tree) if isinstance(t, torch.Tensor)]
        key = tuple((p, tuple(t.shape), t.dtype) for p, t in tensors)
        if self._staging is None or self._staging[0] != key:
            self._staging = (key, {p: torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=t.is_cuda)
                                   for p, t in tensors})
        bufs = self._staging[1]
        devices = set()
        with torch.no_grad():
            for p, t in tensors:
                bufs[p].copy_(t.detach(), non_blocking=t.is_cuda)
                if t.is_cuda:
                    devices.add(t.device)
        events = []
        for d in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        return _rebuild(tree, bufs), events

    def _write(self, staged: dict, events: list, path: str) -> None:
        """The writer's body: wait for the staging copies, write, commit;
        each attempt retried `io_retries` times."""
        t0 = time.perf_counter()
        retries = 0

        def on_retry(_attempt, _exc):
            nonlocal retries
            retries += 1

        try:
            for ev in events:
                ev.synchronize()
            retry_with_backoff(lambda: write_tree(staged, os.path.join(path, _TREE)),
                               attempts=self.io_retries + 1,
                               backoff_base=self.retry_backoff, on_retry=on_retry)
        finally:
            self._writer_retries += retries
            self.last_write_s = time.perf_counter() - t0

    def _run_writer(self, staged, events, path) -> None:
        try:
            self._write(staged, events, path)
        except BaseException as e:  # handed to the main thread at the join
            self._write_error = e

    # ------------------------------------------------------------------ #

    @property
    def _history_path(self) -> str:
        return os.path.join(self.output_dir, "best_metric_history.json")

    def _load_metric_history(self):
        if os.path.exists(self._history_path):
            with open(self._history_path) as f:
                data = json.load(f)
            self._metric_by_step = {int(k): v for k, v in data.get("metrics", {}).items()}
            self._last_saved_step = data.get("last_saved_step")
        # the history is written while the tree streams, so a crash mid-save
        # can leave it naming a checkpoint that never committed: clamp to
        # what is on disk (a step that was never set stays unset)
        committed = {self._step_of(d) for d in self._ckpt_dirs}
        if self._last_saved_step is not None and self._last_saved_step not in committed:
            self._last_saved_step = max(committed) if committed else None
        self._metric_by_step = {k: v for k, v in self._metric_by_step.items()
                                if k in committed}

    def _save_metric_history(self):
        with open(self._history_path, "w") as f:
            json.dump({"metrics": self._metric_by_step,
                       "last_saved_step": self._last_saved_step}, f)

    @staticmethod
    def _step_of(path: str) -> int:
        return int(path.rsplit("-", 1)[1])

    def _existing(self) -> list[str]:
        """The committed checkpoint directories (those holding `tree.pt`),
        oldest first."""
        dirs = [os.path.join(self.output_dir, d) for d in os.listdir(self.output_dir)
                if d.startswith("checkpoint-")
                and os.path.isfile(os.path.join(self.output_dir, d, _TREE))]
        return sorted(dirs, key=self._step_of)

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def save(self, step: int, params: dict, opt_state: dict | None = None,
             metric_old: float | None = None,
             extra_state: dict | None = None, value: dict | None = None) -> str:
        """Save `params` (and `opt_state`, and the value tree `value`) at
        `step`. `metric_old`, when given, scores the previous checkpoint and
        is recorded against it. Returns once the tree is staged; the write
        runs on the writer thread unless `async_save` is off."""
        if metric_old is not None and self._last_saved_step is not None:
            self._metric_by_step[self._last_saved_step] = float(metric_old)
        self._absorb_failed_save()
        path = self.path(step)
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        if value is not None:
            tree["value"] = value
        staged, events = self._stage(tree)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"step": step, **(extra_state or {})}, f)
        if self.async_save:
            self._writer = threading.Thread(target=self._run_writer,
                                            args=(staged, events, path),
                                            name=f"ckpt-write-{step}", daemon=True)
            self._writer.start()
        else:
            try:
                self._write(staged, events, path)
            finally:
                self.retry_count += self._writer_retries
                self._writer_retries = 0
        if path in self._ckpt_dirs:  # re-saving a step after a resume
            self._ckpt_dirs.remove(path)
        self._ckpt_dirs.append(path)
        self._last_saved_step = step
        self._save_metric_history()
        self._rotate()
        return path

    def best_step(self) -> int | None:
        if not self._metric_by_step:
            return None
        pick = max if self.greater_is_better else min
        return pick(self._metric_by_step, key=self._metric_by_step.get)

    def _rotate(self):
        keep_always = {self._ckpt_dirs[-1]} if self._ckpt_dirs else set()
        best = self.best_step()
        if best is not None:
            keep_always.add(self.path(best))
        while len(self._ckpt_dirs) > self.save_total_limit:
            victim = next((d for d in self._ckpt_dirs if d not in keep_always), None)
            if victim is None:
                break  # everything left is protected
            shutil.rmtree(victim, ignore_errors=True)
            self._ckpt_dirs.remove(victim)

    def restore(self, step: int, device=None, fallback: bool = True) -> dict:
        """The tree saved at `step` ({"params", "opt_state", "value"}),
        with its tensors on `device`. A checkpoint that will not load after
        every retry counts as corrupt: with `fallback` the newest EARLIER
        committed one is tried next (`fallback_count` counts the skipped
        steps, `last_restored_step` names the one that loaded — a resume
        must adopt it)."""
        self.wait()
        candidates = [step]
        if fallback:
            candidates += [s for s in (self._step_of(d) for d in reversed(self._existing()))
                           if s < step]
        last_exc: Exception | None = None

        def on_retry(_attempt, _exc):
            self.retry_count += 1

        for i, cand in enumerate(candidates):
            try:
                tree = retry_with_backoff(
                    lambda: read_tree(os.path.join(self.path(cand), _TREE), device),
                    attempts=self.io_retries + 1, backoff_base=self.retry_backoff,
                    on_retry=on_retry)
            except Exception as e:
                last_exc = e
                continue
            self.fallback_count += i
            self.last_restored_step = cand
            if i:
                print(f"[checkpoint] checkpoint {step} corrupt/unreadable — fell "
                      f"back to checkpoint {cand}")
            return tree
        raise last_exc

    def truncate_after(self, step: int) -> None:
        """Drop the checkpoints and metric history newer than `step` — on a
        resume from an earlier step, so the abandoned trajectory's saves
        cannot take `latest_step()` / `best_step()` or the next
        `metric_old`."""
        self._absorb_failed_save()
        for d in list(self._ckpt_dirs):
            if self._step_of(d) > step:
                shutil.rmtree(d, ignore_errors=True)
                self._ckpt_dirs.remove(d)
        self._metric_by_step = {k: v for k, v in self._metric_by_step.items()
                                if k <= step}
        self._last_saved_step = step
        self._save_metric_history()

    def load_trainer_state(self, step: int) -> dict:
        with open(os.path.join(self.path(step), "trainer_state.json")) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        self._absorb_failed_save()
        dirs = self._existing()
        return self._step_of(dirs[-1]) if dirs else None

    def close(self) -> None:
        """Flush the in-flight write (raising its failure) and drop the exit
        barrier."""
        try:
            self.wait()
        finally:
            atexit.unregister(self.wait)
