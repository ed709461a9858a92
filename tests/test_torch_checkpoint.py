"""The port's `CheckpointManager` against the JAX package's: async writes
through pinned staging equal synchronous ones (rotation and best-metric
results as JAX's manager gives), the staging copy is taken at `save` time,
a write that dies midway commits nothing and is absorbed at the next save,
I/O retries, the fall-back from a checkpoint that will not load,
`truncate_after`, and a `tree.pt` written by the earlier synchronous
manager still restoring."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from nanorlhf_tpu.trainer.checkpoint import CheckpointManager as JaxCheckpointManager
from nanorlhf_tpu_torch.trainer import checkpoint as tck
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager

METRICS = [None, 0.5, 0.9, 0.1, 0.2, 0.3]


def _tree(step: int) -> dict:
    g = torch.Generator().manual_seed(step)
    return {"lora": {"a": torch.randn(3, 4, generator=g),
                     "b": torch.randn(2, 3, generator=g).to(torch.bfloat16)},
            "embed_tokens": torch.randn(5, 4, generator=g)}


def _opt(step: int) -> dict:
    return {"policy": {"count": step, "mu": {"w": torch.full((2,), float(step))},
                       "nu": {"w": torch.full((2,), step * 0.5)}}}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _steps(mgr) -> list[int]:
    return [int(d.rsplit("-", 1)[1]) for d in mgr._existing()]


@pytest.mark.parametrize("limit", [2, 8])
def test_async_save_equals_sync_and_jax_rotation(tmp_path, limit):
    async_mgr = CheckpointManager(str(tmp_path / "async"), save_total_limit=limit)
    sync_mgr = CheckpointManager(str(tmp_path / "sync"), save_total_limit=limit,
                                 async_save=False)
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), save_total_limit=limit,
                                   async_save=False)
    for step, m in enumerate(METRICS, start=1):
        for mgr in (async_mgr, sync_mgr):
            mgr.save(step, _tree(step), opt_state=_opt(step), metric_old=m,
                     extra_state={"episode": 4 * step})
        jax_mgr.save(step, {"w": np.full((2,), float(step))}, metric_old=m)
    async_mgr.close()
    sync_mgr.close()
    jax_mgr.close()
    assert _steps(async_mgr) == _steps(sync_mgr) == _steps(jax_mgr)
    assert async_mgr.best_step() == sync_mgr.best_step() == jax_mgr.best_step() == 2
    for step in _steps(async_mgr):
        got, want = async_mgr.restore(step), sync_mgr.restore(step)
        assert _equal(got, want)
        assert _equal(got, {"params": _tree(step), "opt_state": _opt(step)})
        assert async_mgr.load_trainer_state(step) == {"step": step, "episode": 4 * step}
    assert async_mgr.retry_count == async_mgr.fallback_count == 0
    again = CheckpointManager(str(tmp_path / "async"), save_total_limit=limit)
    assert again.best_step() == 2 and again.latest_step() == 6
    again.close()


def test_staging_copy_is_taken_at_save(tmp_path, monkeypatch):
    """The optimizer steps the live leaves in place right after `save`
    returns: the checkpoint must hold the values at `save`, even while the
    writer has not written yet."""
    gate = threading.Event()
    real = tck.write_tree

    def held_write(tree, path):
        assert gate.wait(30)
        real(tree, path)

    monkeypatch.setattr(tck, "write_tree", held_write)
    mgr = CheckpointManager(str(tmp_path / "run"))
    live = _tree(1)
    want = {k: v.clone() if isinstance(v, torch.Tensor) else
            {kk: vv.clone() for kk, vv in v.items()} for k, v in live.items()}
    mgr.save(1, live)
    with torch.no_grad():
        live["embed_tokens"].add_(1.0)
        live["lora"]["a"].mul_(-2.0)
    gate.set()
    mgr.wait()
    assert _equal(mgr.restore(1)["params"], want)
    mgr.close()


def _dies_midway(tree, path):
    with open(path + ".tmp", "wb") as f:
        f.write(b"partial")
    raise OSError("disk gone")


def test_failed_write_commits_nothing_and_is_absorbed(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "run"), io_retries=2, retry_backoff=0.0)
    mgr.save(1, _tree(1), metric_old=None)
    real = tck.write_tree
    monkeypatch.setattr(tck, "write_tree", _dies_midway)
    mgr.save(2, _tree(2), metric_old=0.7)
    mgr._writer.join()
    monkeypatch.setattr(tck, "write_tree", real)
    assert not os.path.isfile(os.path.join(mgr.path(2), "tree.pt"))
    assert _steps(mgr) == [1]
    # the next save absorbs the failure: 2 retried attempts + the failed save
    mgr.save(3, _tree(3), metric_old=0.1)
    assert mgr.retry_count == 3
    assert not os.path.isdir(mgr.path(2))
    mgr.wait()
    assert _steps(mgr) == [1, 3] and mgr.latest_step() == 3
    # 0.7 (save 2's metric_old) scores checkpoint 1; 0.1 was recorded
    # against the phantom 2 before the absorb dropped it — JAX's order
    assert mgr._metric_by_step == {1: 0.7}
    history = json.load(open(os.path.join(mgr.output_dir, "best_metric_history.json")))
    assert history["last_saved_step"] == 3
    mgr.close()


def test_failed_final_write_raises(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "run"), io_retries=0)
    monkeypatch.setattr(tck, "write_tree", _dies_midway)
    mgr.save(1, _tree(1))
    with pytest.raises(OSError, match="disk gone"):
        mgr.close()
    assert _steps(mgr) == []


@pytest.mark.parametrize("async_save", [True, False])
def test_transient_write_failure_is_retried(tmp_path, monkeypatch, async_save):
    real, calls = tck.write_tree, []

    def flaky(tree, path):
        calls.append(path)
        if len(calls) == 1:
            _dies_midway(tree, path)
        real(tree, path)

    monkeypatch.setattr(tck, "write_tree", flaky)
    mgr = CheckpointManager(str(tmp_path / "run"), async_save=async_save,
                            retry_backoff=0.0)
    mgr.save(1, _tree(1))
    assert mgr.latest_step() == 1 and mgr.retry_count == 1 and len(calls) == 2
    assert _equal(mgr.restore(1)["params"], _tree(1))
    mgr.close()


def test_truncated_tree_falls_back_to_older_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), io_retries=1, retry_backoff=0.0)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    mgr.wait()
    path = os.path.join(mgr.path(3), "tree.pt")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    got = mgr.restore(3)
    assert _equal(got["params"], _tree(2))
    assert mgr.last_restored_step == 2 and mgr.fallback_count == 1
    assert mgr.retry_count == 1  # the unreadable tree was read twice
    with pytest.raises(Exception):
        mgr.restore(3, fallback=False)
    mgr.close()


def test_truncate_after_matches_jax(tmp_path):
    port = CheckpointManager(str(tmp_path / "port"))
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), async_save=False)
    for step, m in enumerate(METRICS[:5], start=1):
        port.save(step, _tree(step), metric_old=m)
        jax_mgr.save(step, {"w": np.full((2,), float(step))}, metric_old=m)
    port.truncate_after(2)
    jax_mgr.truncate_after(2)
    assert _steps(port) == _steps(jax_mgr) == [1, 2]
    assert port._metric_by_step == jax_mgr._metric_by_step
    assert port.best_step() == jax_mgr.best_step()
    assert port._last_saved_step == jax_mgr._last_saved_step == 2
    # the next metric scores checkpoint 2 on both sides
    port.save(3, _tree(3), metric_old=0.4)
    jax_mgr.save(3, {"w": np.full((2,), 3.0)}, metric_old=0.4)
    assert port._metric_by_step == jax_mgr._metric_by_step
    assert port.latest_step() == jax_mgr.latest_step() == 3
    port.close()
    jax_mgr.close()


def test_earlier_synchronous_tree_still_restores(tmp_path):
    """A checkpoint as the synchronous manager wrote it (`torch.save` of
    CPU copies, then the rename) restores through the async manager."""
    out = tmp_path / "run"
    path = out / "checkpoint-4"
    path.mkdir(parents=True)
    tree = {"params": _tree(4), "opt_state": _opt(4)}
    torch.save(tree, str(path / "tree.pt.tmp"))
    os.replace(str(path / "tree.pt.tmp"), str(path / "tree.pt"))
    (path / "trainer_state.json").write_text(json.dumps(
        {"step": 4, "episode": 16, "opt_steps": 8, "rollouts": 4}))
    mgr = CheckpointManager(str(out))
    assert mgr.latest_step() == 4
    assert _equal(mgr.restore(4), tree)
    assert mgr.load_trainer_state(4)["rollouts"] == 4
    mgr.close()
