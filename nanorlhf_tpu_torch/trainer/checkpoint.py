"""Checkpoints with the reference's rotation and best-metric semantics —
the port of `nanorlhf_tpu/trainer/checkpoint.py`'s `CheckpointManager`.

What carries over: a checkpoint every `save_steps`, rotation to
`save_total_limit`, and `load_best_model_at_end` keyed on an `_old` metric,
whose value describes the PREVIOUS checkpoint — so a metric arriving with
save k is recorded against save k−1, and the best checkpoint (and the
newest, whose metric has not arrived yet) is never rotated away. The
metric history lives in `best_metric_history.json` so it survives a resume.

What differs: orbax is not on the card's machine, so the tree is one
`torch.save` file, `checkpoint-<step>/tree.pt`, written to a temporary
name and renamed last — a directory counts as committed only once
`tree.pt` exists. It holds the trainable leaves (the LoRA adapters and
the trained embeddings; the frozen base is the run's input, not its
output) and the optimizer state, beside `trainer_state.json`. Writes are
synchronous; async writes, I/O retries, fault sites and tracer spans are
not ported.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

_TREE = "tree.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    def __init__(self, output_dir: str, save_total_limit: int = 8,
                 greater_is_better: bool = True):
        self.output_dir = os.path.abspath(output_dir)
        self.save_total_limit = save_total_limit
        self.greater_is_better = greater_is_better
        os.makedirs(self.output_dir, exist_ok=True)
        self._ckpt_dirs: list[str] = self._existing()
        # step -> metric measured ON that step's saved policy (arrives one
        # save later under the `_old` convention)
        self._metric_by_step: dict[int, float] = {}
        self._last_saved_step: int | None = None
        self._load_metric_history()

    @property
    def _history_path(self) -> str:
        return os.path.join(self.output_dir, "best_metric_history.json")

    def _load_metric_history(self):
        if os.path.exists(self._history_path):
            with open(self._history_path) as f:
                data = json.load(f)
            self._metric_by_step = {int(k): v for k, v in data.get("metrics", {}).items()}
            self._last_saved_step = data.get("last_saved_step")
        # clamp to what actually committed on disk
        committed = {self._step_of(d) for d in self._ckpt_dirs}
        if self._last_saved_step not in committed:
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
        dirs = [os.path.join(self.output_dir, d) for d in os.listdir(self.output_dir)
                if d.startswith("checkpoint-")
                and os.path.isfile(os.path.join(self.output_dir, d, _TREE))]
        return sorted(dirs, key=self._step_of)

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def save(self, step: int, params: dict, opt_state: dict | None = None,
             metric_old: float | None = None,
             extra_state: dict | None = None) -> str:
        """Save `params` (and `opt_state`) at `step`. `metric_old`, when
        given, scores the previous checkpoint and is recorded against it."""
        if metric_old is not None and self._last_saved_step is not None:
            self._metric_by_step[self._last_saved_step] = float(metric_old)
        path = self.path(step)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump({"step": step, **(extra_state or {})}, f)
        tree = {"params": _to_cpu(params)}
        if opt_state is not None:
            tree["opt_state"] = _to_cpu(opt_state)
        tmp = os.path.join(path, _TREE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, _TREE))
        if path in self._ckpt_dirs:
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

    def restore(self, step: int, device=None) -> dict:
        """The tree saved at `step` ({"params": ..., "opt_state": ...}),
        with its tensors on `device`."""
        return torch.load(os.path.join(self.path(step), _TREE),
                          map_location=device, weights_only=True)

    def load_trainer_state(self, step: int) -> dict:
        with open(os.path.join(self.path(step), "trainer_state.json")) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        return self._step_of(self._ckpt_dirs[-1]) if self._ckpt_dirs else None
