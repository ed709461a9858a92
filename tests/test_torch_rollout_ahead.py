"""`rollout_ahead` in the port (`trainer/trainer.RolloutStream`): rollout k+1
generates on a producer thread, from a snapshot of the weights before
update k, while update k runs — the counterparts of JAX's
`tests/test_rollout_ahead.py`:

- update 1 equals the synchronous run's (same prompts, same stream, no
  staleness yet), later updates stay finite with the epoch-1 ratio near 1;
- with the policy frozen (lr 0) every rollout equals the synchronous one
  bit for bit: the prefetch draws the same batch and the same stream;
- ReMax's second (greedy) rollout rides the prefetch; the sparse trainer's
  loop prefetches too, and with its policy frozen its prefetched rollouts
  (with and without captured logprobs) equal the synchronous ones bit for
  bit.
"""

import threading

import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu_torch.entrypoints.remax import build_remax_config
from test_torch_orchestrator import assert_same_run, run_trainer

torch.set_num_threads(1)


def test_update1_identical_and_stale_updates_stable(tmp_path, monkeypatch):
    serial = run_trainer(tmp_path / "serial", monkeypatch)
    ahead = run_trainer(tmp_path / "ahead", monkeypatch, rollout_ahead=True)
    np.testing.assert_array_equal(serial[0][0], ahead[0][0])
    assert_same_run(({0: serial[0][0]}, serial[1][:1]), ({0: ahead[0][0]}, ahead[1][:1]))
    assert sorted(ahead[0]) == [0, 1, 2] and ahead[2].state["rollouts"] == 3
    for row in ahead[1][1:]:
        assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))
        assert 0.5 < row["val/ratio_new"] < 2.0
    assert ahead[1][-1]["time/rollout_overlap_frac"] > 0.0
    assert ahead[2]._stream is None      # the prefetch ends with train()


def test_frozen_policy_ahead_equals_synchronous(tmp_path, monkeypatch):
    sync = run_trainer(tmp_path / "sync", monkeypatch, learning_rate=0.0)
    ahead = run_trainer(tmp_path / "ahead", monkeypatch, learning_rate=0.0,
                        rollout_ahead=True)
    assert_same_run(sync[:2], ahead[:2])


def test_remax_ahead_smoke(tmp_path, monkeypatch):
    _, rows, tr = run_trainer(tmp_path, monkeypatch, updates=2, build=build_remax_config,
                              rollout_ahead=True)
    assert tr.state["global_step"] == 2 and len(rows) == 2
    assert all(np.isfinite(r["loss/policy_avg_new"]) for r in rows)


def _sparse_run(tmp_path, monkeypatch=None, updates=2, **over):
    """The sparse trainer at a tiny size with real generation (the r1 cut,
    vocab 256, 8-token responses); with `monkeypatch`, the generated
    tokens (and captured logprobs) of each rollout are recorded in order,
    and whether the main thread generated it."""
    from _torch_parity import jax_config, make_params, port_config
    from nanorlhf_tpu_torch.data.tokenizer import ToyTokenizer
    from nanorlhf_tpu_torch.entrypoints import grpo_r1
    from nanorlhf_tpu_torch.trainer import rollout as trollout
    from nanorlhf_tpu_torch.trainer.sparse_grpo import SparseGRPOTrainer

    jcfg = jax_config("qwen_tied", vocab_size=256)
    _, params = make_params(jcfg, seed=3)
    tok = ToyTokenizer(256)
    ds = grpo_r1.build_prompt_dataset(grpo_r1.synthetic_math_corpus(64), tok,
                                      max_prompt_len=16)
    cfg = grpo_r1.r1_card_cut(grpo_r1.build_config())
    cfg.output_dir = str(tmp_path)
    cfg.response_length, cfg.lora_r, cfg.lora_alpha = 8, 4, 8
    cfg.per_device_train_batch_size, cfg.save_steps = 2, 0
    for k, v in over.items():
        setattr(cfg, k, v)
    generated, on_main = [], []
    if monkeypatch is not None:
        real = getattr(trollout.generate, "__wrapped__", trollout.generate)

        def recorded(*a, **k):
            out = real(*a, **k)
            on_main.append(threading.current_thread() is threading.main_thread())
            generated.append([x.clone() for x in out] if isinstance(out, tuple)
                             else [out.clone()])
            return out

        recorded.__wrapped__ = real
        monkeypatch.setattr(trollout, "generate", recorded)
    tr = SparseGRPOTrainer(cfg, port_config(jcfg), tok, params, ds,
                           lambda texts, eos: np.asarray([len(x) % 3 for x in texts],
                                                         np.float32))
    try:
        tr.train(num_updates=updates)
    finally:
        tr.close()
    return tr, generated, on_main


def test_sparse_grpo_ahead_smoke(tmp_path):
    tr, _, _ = _sparse_run(tmp_path, rollout_ahead=True)
    assert [r["index"] for r in tr.update_log] == [0, 1]
    assert tr.state["rollouts"] == 2
    assert tr._stream is None


@pytest.mark.parametrize("capture", [False, True])
def test_sparse_frozen_policy_ahead_equals_synchronous(capture, tmp_path, monkeypatch):
    """With the policy frozen (lr 0), the sparse loop's prefetched rollouts
    equal the synchronous ones bit for bit (tokens, and the captured
    logprobs under capture), and so do the kept rows, the buckets, every
    bucket's loss stats, the metric rows and the leaves."""
    from nanorlhf_tpu_torch.trainer.optim import flatten

    runs = [_sparse_run(tmp_path / name, monkeypatch, updates=3, learning_rate=0.0,
                        sampler_logprob_capture=capture, rollout_ahead=ahead)
            for name, ahead in (("sync", False), ("ahead", True))]
    (sync, sync_gen, sync_main), (ahead, ahead_gen, ahead_main) = runs
    assert len(sync_gen) == len(ahead_gen) == 3
    # rollouts 1 and 2 were prefetched on the producer thread
    assert sync_main == [True] * 3 and ahead_main == [True, False, False]
    assert all(len(g) == 1 + capture for g in sync_gen)
    for a, b in zip(sync_gen, ahead_gen):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    keys = ("index", "skipped", "kept", "raw_score_mean", "score_buckets",
            "update_buckets", "stats")
    assert [{k: r.get(k) for k in keys} for r in sync.update_log] == \
        [{k: r.get(k) for k in keys} for r in ahead.update_log]
    assert any(not r["skipped"] for r in sync.update_log)
    rows = [[{k: v for k, v in row.items()
              if k.split("/")[0] in ("loss", "policy", "val", "objective", "sparse",
                                     "sampler_capture", "eval_objective")}
             for row in _jsonl(tmp_path / name / "metrics.jsonl") if "episode" in row]
            for name in ("sync", "ahead")]
    assert rows[0] and rows[0] == rows[1]
    assert ahead.state == sync.state
    for p, t in flatten(sync.trainable).items():
        assert torch.equal(t, flatten(ahead.trainable)[p]), p


def _jsonl(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]
