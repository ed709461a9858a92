"""The port's GRPO trainer end to end on the CPU (tiny random model, plain
versions of every kernel): one whole update through the launcher's entry
points, the checkpoint it writes and restores, the metrics rows, the two
faults this slice repaired (scoring every sample instead of the kept one;
a ref model that moved with the policy when LoRA was off), checkpoint
rotation against the JAX `CheckpointManager`, the knobs that raise, and the
update's other routes: the naive branch trains, and both remat policies
keep the values and gradients (remat_policy="dots" against JAX's)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import (  # noqa: F401 (closes_trainers: autouse)
    LORA,
    closes_trainers,
    jax_config,
    make_params,
    port_config,
)
from nanorlhf_tpu.core import model as jm
from nanorlhf_tpu.trainer.checkpoint import CheckpointManager as JaxCheckpointManager
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.bridge import params_to_numpy
from nanorlhf_tpu_torch.core import model as tm
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.trainer import rollout as trollout
from nanorlhf_tpu_torch.trainer.checkpoint import CheckpointManager
from nanorlhf_tpu_torch.trainer.optim import flatten, unflatten
from nanorlhf_tpu_torch.trainer.trainer import check_trainer_supported

torch.set_num_threads(1)


def _tiny_cfg(tmp_path, **over):
    cfg = one_card_cut(build_config())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path / "run")
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 16
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.learning_rate = 1e-3
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    """A reward with variance inside every group, so the GRPO advantages
    (and the gradients) are not all zero on a random model."""
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(tmp_path, **over):
    tr = common.build_trainer(_tiny_cfg(tmp_path, **over), device="cpu")
    tr.reward_func = _varied_reward
    return tr


def _snapshot(tree):
    return {p: t.detach().clone() for p, t in flatten(tree).items()}


def test_one_update_on_cpu_trains_saves_and_restores(tmp_path):
    tr = _trainer(tmp_path)
    base, ref = _snapshot(tr.params), _snapshot(tr.ref_params)
    trained = set(flatten(tr.trainable))
    state = tr.train(num_updates=1)
    assert state == {"episode": tr.cfg.batch_size, "global_step": 1,
                     "opt_steps": tr.cfg.num_mini_batches, "rollouts": 1}
    after = flatten(tr.params)
    assert any(not torch.equal(after[p].detach(), base[p])
               for p in trained if p[0] == "lora" and p[-1] == "b")
    assert all(torch.equal(after[p], base[p]) for p in base if p not in trained)
    assert all(torch.equal(t, ref[p]) for p, t in flatten(tr.ref_params).items())
    # the update half ran no kernel: CPU tensors take the plain versions
    assert tr.last_launches["update"] == {n: 0 for n in _build.KERNELS}

    rows = [json.loads(line) for line in open(os.path.join(tr.cfg.output_dir, "metrics.jsonl"))]
    assert len(rows) == 1
    for key in ("policy/approxkl_avg_new", "policy/clipfrac_avg_new",
                "policy/entropy_avg_new", "loss/policy_avg_new", "val/ratio_new",
                "policy/grad_norm_new", "objective/kl_old", "eval_objective/scores_old",
                "lr", "episode"):
        assert np.isfinite(rows[0][key]), key
    assert rows[0]["policy/grad_norm_new"] > 0
    assert rows[0]["lr"] == pytest.approx(tr.cfg.learning_rate)

    # a fresh trainer restores the trained leaves, the moments and the cursor
    tr2 = _trainer(tmp_path)
    assert tr2.restore_checkpoint() == 1
    for p, t in flatten(tr.trainable).items():
        assert torch.equal(flatten(tr2.trainable)[p].detach(), t.detach())
    for m in ("mu", "nu"):
        for p, t in flatten(getattr(tr.opt_state["policy"], m)).items():
            assert torch.equal(flatten(getattr(tr2.opt_state["policy"], m))[p], t)
    assert tr2.opt_state["policy"].count == tr.opt_state["policy"].count == 2
    assert tr2.state == tr.state


def test_run_is_the_launcher_tail(tmp_path):
    state = common.run(_tiny_cfg(tmp_path), device="cpu", num_updates=1)
    assert state["global_step"] == 1
    assert os.path.isfile(os.path.join(str(tmp_path / "run"), "checkpoint-1", "tree.pt"))


def test_run_needs_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        common.run(_tiny_cfg(tmp_path))


def test_grpo_scores_only_the_kept_rows(monkeypatch):
    """Keep-1-of-N happens BEFORE the logprob pass, as in JAX: the scorer
    sees one row per prompt, never all B·N samples."""
    scored = []
    real = trollout.score_chunk

    def spy(params, ref, mcfg, cfg, rows, *args, **kw):
        scored.append(rows.shape[0])
        return real(params, ref, mcfg, cfg, rows, *args, **kw)

    monkeypatch.setattr(trollout, "score_chunk", spy)
    cfg = build_config()
    cfg.sft_model_path = "tiny-demo"
    cfg.response_length = 4
    out = common.run_rollout(cfg, device="cpu", num_prompts=3)
    assert sum(scored) == 3 and out["logprobs"].shape == (3, 4)
    assert out["scores"].shape == (3 * cfg.sample_n,)


def test_ref_stays_frozen_without_lora(tmp_path):
    """With use_lora=False every leaf trains; the ref is a copy, not the
    policy's tensors, so it does not move when the policy steps."""
    tr = _trainer(tmp_path, use_lora=False)
    ref = _snapshot(tr.ref_params)
    pol = flatten(tr.params)
    assert all(t is not pol[p] for p, t in flatten(tr.ref_params).items())
    before = _snapshot(tr.params)
    tr.train(num_updates=1)
    assert any(not torch.equal(t.detach(), before[p]) for p, t in flatten(tr.params).items())
    assert all(torch.equal(t, ref[p]) for p, t in flatten(tr.ref_params).items())


def test_checkpoint_rotation_matches_jax(tmp_path):
    """save_total_limit rotation under the `_old` convention: a metric
    arriving with save k scores save k−1; the best and the newest are
    never rotated away — the same survivors and best step as JAX's."""
    metrics = [None, 0.5, 0.9, 0.1, 0.2, 0.3]
    port = CheckpointManager(str(tmp_path / "port"), save_total_limit=2)
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), save_total_limit=2,
                                   async_save=False)
    for step, m in enumerate(metrics, start=1):
        port.save(step, {"w": torch.full((2,), float(step))}, metric_old=m)
        jax_mgr.save(step, {"w": np.full((2,), float(step))}, metric_old=m)
    jax_mgr.close()
    survivors = [int(d.rsplit("-", 1)[1]) for d in port._existing()]
    assert survivors == [int(d.rsplit("-", 1)[1]) for d in jax_mgr._existing()]
    assert port.best_step() == jax_mgr.best_step() == 2
    assert 2 in survivors and port.latest_step() == 6
    assert torch.equal(port.restore(2)["params"]["w"], torch.full((2,), 2.0))
    # a successor manager reads the history back
    again = CheckpointManager(str(tmp_path / "port"), save_total_limit=2)
    assert again.best_step() == 2 and again.latest_step() == 6


# the host planes' knobs, ported with the telemetry and resilience layers,
# and env_name (a single-turn python_tool environment here), ported with the
# environments
PORTED_TRAINER_KNOBS = {"telemetry", "lineage", "fault_spec", "status_port",
                        "profile_at_step", "health_arm_sentinel", "env_name"}


@pytest.mark.parametrize("knob,value", [
    ("telemetry", True), ("lineage", True), ("fault_spec", "update.step:at=1"),
    ("status_port", -1), ("profile_at_step", 1), ("health_arm_sentinel", True),
    ("rollout_ahead", True), ("env_name", "python_tool"),
    ("rollout_inflight_swaps", True),
])
def test_unported_trainer_knobs_raise(knob, value):
    """The knobs of later slices raise; the host planes' are accepted."""
    cfg = build_config()
    setattr(cfg, knob, value)
    if knob in PORTED_TRAINER_KNOBS:
        check_trainer_supported(cfg)
        return
    with pytest.raises(NotImplementedError):
        check_trainer_supported(cfg)


def test_naive_update_branch_raises(tmp_path, monkeypatch):
    """The naive update branch (`fused_logprob=False`: full logits, then
    `chunked_entropy`) raised until it was ported: it now trains an update,
    scoring and update both without the fused op, and its metric row
    agrees with the fused branch's on the same rollout."""
    calls = []
    real = trollout.score_chunk

    def spy(params, ref, mcfg, cfg, *a, **kw):
        calls.append(cfg.fused_logprob)
        return real(params, ref, mcfg, cfg, *a, **kw)

    monkeypatch.setattr(trollout, "score_chunk", spy)
    rows = {}
    for fused in (True, False):
        tr = _trainer(tmp_path / str(fused), fused_logprob=fused)
        check_trainer_supported(tr.cfg)
        try:
            tr.train(num_updates=1)
        finally:
            tr.close()
        rows[fused] = tr.logger.latest()
    assert calls and set(calls) == {True, False}
    assert rows[False]["mem/logits_bytes_saved"] == 0.0
    assert rows[True]["mem/logits_bytes_saved"] > 0.0
    # bf16 on the CPU: the branches round the logits differently
    for key in ("policy/entropy_avg_new", "loss/policy_avg_new",
                "objective/kl_rollout_old", "policy/grad_norm_new"):
        assert np.isfinite(rows[False][key]), key
        assert rows[False][key] == pytest.approx(rows[True][key], rel=5e-2, abs=5e-3), key
    assert rows[False]["policy/grad_norm_new"] > 0


def test_remat_dots_policy_raises_and_full_keeps_values():
    """Both remat policies keep the forward's values and the gradients of
    no remat bit for bit, through the plain attention and the flash route
    (its plain version); "dots" equals JAX's "dots" gradients (the
    counterpart of tests/test_model_pallas.py's policy test); "dots"
    recomputes no 2-D GEMM in the backward but does recompute the
    attention's batched products; an unknown policy raises ValueError."""
    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for name, op in (("mm", torch.ops.aten.mm.default),
                             ("bmm", torch.ops.aten.bmm.default)):
                self.n[name] += func is op
            return func(*args, **(kwargs or {}))

    ids = np.random.default_rng(5).integers(1, 64, (2, 9)).astype(np.int32)
    for impl in ("xla", "pallas"):
        jcfg = jax_config("qwen_tied", vocab_size=64, attention_impl=impl)
        mcfg = port_config(jcfg)
        jparams, tparams = make_params(jcfg, seed=2)
        plain = tm.padded_forward_logits(tparams, mcfg, torch.as_tensor(ids), 0,
                                         lora_scale=LORA.scale)
        leaves = flatten(tparams)
        for t in leaves.values():
            t.requires_grad_(True)
        grads, ops = {}, {}
        for policy, remat in (("none", False), ("full", True), ("dots", True)):
            c = dataclasses.replace(mcfg, remat_policy="full" if policy == "none" else policy)
            lg = tm.padded_forward_logits(tparams, c, torch.as_tensor(ids), 0,
                                          lora_scale=LORA.scale, remat=remat)
            torch.testing.assert_close(lg, plain, atol=0, rtol=0)
            with CountOps() as counter:
                g = torch.autograd.grad((lg.float() ** 2).mean(), list(leaves.values()))
            grads[policy] = dict(zip(leaves, g))
            ops[policy] = counter.n
        for policy in ("full", "dots"):
            for p, g in grads[policy].items():
                assert torch.equal(g, grads["none"][p]), (impl, policy, p)
        # "full" re-runs every GEMM of the layers, "dots" none of them;
        # both re-run the attention's batched products
        assert ops["dots"]["mm"] == ops["none"]["mm"] < ops["full"]["mm"]
        assert ops["dots"]["bmm"] == ops["full"]["bmm"] > ops["none"]["bmm"]

        jdots = dataclasses.replace(jcfg, remat_policy="dots")
        want = jax.grad(lambda p: (jm.padded_forward_logits(
            p, jdots, jnp.asarray(ids), 0, lora_scale=LORA.scale, remat=True)
            .astype(jnp.float32) ** 2).mean())(jparams)
        want = flatten(jax.tree.map(np.asarray, want))
        got = flatten(params_to_numpy(unflatten(grads["dots"])))
        assert got.keys() == want.keys()
        for p, g in got.items():
            np.testing.assert_allclose(g, want[p], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{impl} {'/'.join(p)}")
    with pytest.raises(ValueError, match="remat_policy"):
        tm.padded_forward_hidden(tparams, dataclasses.replace(mcfg, remat_policy="bogus"),
                                 torch.as_tensor(ids), 0, remat=True)

