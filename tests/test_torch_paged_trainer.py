"""The port's GRPO trainer over the paged rollout paths on the CPU (tiny
random model, plain versions of every kernel): continuous batching
(`rollout_page_size=4, rollout_decode_rows=4`), exact and with the int8 KV
cache, for two updates — the `rollout/page_*` and `session/*` metric rows,
the pool snapshot kept on the trainer, and checkpoint → restore → one more
update, as `tests/test_paged_cache.py` drives the JAX trainer. And the
rollout over the paged and int8 routes against the contiguous exact one."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer.optim import flatten
from nanorlhf_tpu_torch.trainer.rollout import check_supported, sampling_params

torch.set_num_threads(1)

PAGED_ROWS = ("rollout/page_utilization", "rollout/pages_recycled",
              "rollout/admitted_midloop", "session/dispatch_events",
              "session/chunked_admissions", "session/prefill_backlog")


def _cfg(tmp_path, **over):
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "run")
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 32
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.learning_rate = 1e-3
    cfg.rollout_page_size, cfg.rollout_decode_rows = 4, 4
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(tmp_path, **over):
    tr = common.build_trainer(_cfg(tmp_path, **over), device="cpu")
    tr.reward_func = _varied_reward
    return tr


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_updates_metrics_checkpoint_and_resume(tmp_path, quant):
    tr = _trainer(tmp_path, kv_cache_quant=quant)
    rows = tr.cfg.batch_size * tr.cfg.sample_n
    assert rows > tr.cfg.rollout_decode_rows  # the queued scheduler runs
    state = tr.train(num_updates=2)
    assert state["global_step"] == 2 and state["rollouts"] == 2
    assert tr.last_launches["generate"] == {n: 0 for n in _build.KERNELS}
    logged = [json.loads(line) for line in
              open(os.path.join(tr.cfg.output_dir, "metrics.jsonl"))]
    assert len(logged) == 2
    for row in logged:
        for key in PAGED_ROWS:
            assert np.isfinite(row[key]), key
        assert 0.0 < row["rollout/page_utilization"] <= 1.0
        assert row["rollout/admitted_midloop"] == rows - tr.cfg.rollout_decode_rows
        assert row["rollout/pages_recycled"] > 0
        assert row["session/chunked_admissions"] == 0
        assert row["session/dispatch_events"] >= 1 + row["rollout/admitted_midloop"]
        assert np.isfinite(row["loss/policy_avg_new"])
    assert tr.pages_status["rows"] == tr.cfg.rollout_decode_rows
    assert tr.pages_status["admitted_midloop"] == rows - tr.cfg.rollout_decode_rows
    assert tr.session_status["mode"] == "rollout"
    assert tr.session_status["counters"]["decode_iterations"] == \
        tr.pages_status["decode_iterations"]
    trained = flatten(tr.trainable)
    tr.close()

    tr2 = _trainer(tmp_path, kv_cache_quant=quant)
    assert tr2.restore_checkpoint() == 2
    for p, t in flatten(tr2.trainable).items():
        assert torch.equal(t.detach(), trained[p].detach())
    assert tr2.state == state
    tr2.train(num_updates=1)
    assert tr2.state["global_step"] == 3
    tr2.close()


ROUTES = {
    # name: (rollout_page_size, rollout_decode_rows, kv_cache_quant, equal to)
    "paged": (4, 0, "none", "exact"),
    "queued": (4, 3, "none", "exact"),
    "int8_paged": (5, 0, "int8", "int8"),
    "int8_queued": (4, 3, "int8", "int8"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_rollout_routes_match(route, monkeypatch):
    """The whole rollout-and-score through each paged route with greedy
    sampling: the same responses, scores and logprobs as the contiguous
    route of the same cache type (int8 differs from exact only in its
    cache)."""
    P, R, quant, base = ROUTES[route]
    real = common.rollout_and_score

    def rollout(page_size, decode_rows, kv_cache_quant):
        cfg = build_config()
        cfg.sft_model_path = "tiny-demo"
        cfg.response_length = 6
        cfg.rollout_page_size = page_size
        cfg.rollout_decode_rows = decode_rows
        cfg.kv_cache_quant = kv_cache_quant
        greedy = dataclasses.replace(sampling_params(cfg), greedy=True)
        monkeypatch.setattr(common, "rollout_and_score",
                            lambda *a, **kw: real(*a, sampling=greedy, **kw))
        return common.run_rollout(cfg, device="cpu", num_prompts=2)

    got = rollout(P, R, quant)
    want = rollout(0, 0, "none" if base == "exact" else "int8")
    np.testing.assert_array_equal(got["responses"], want["responses"])
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["logprobs"], want["logprobs"])
    assert "paged_stats" in got and "paged_stats" not in want
    # scoring keeps the exact model config: only the rollout's cache changes
    assert got["mcfg"].kv_cache_quant == "none"


def test_kv_cache_quant_is_validated():
    cfg = build_config()
    cfg.kv_cache_quant = "int4"
    with pytest.raises(ValueError, match="kv_cache_quant"):
        check_supported(cfg)
