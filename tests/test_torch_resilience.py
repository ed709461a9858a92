"""The port's resilience layer: the copied modules against the JAX
package's on the same seeded inputs (fault schedules and the spec parser's
errors, sentinel verdicts and journals, the watchdog's backoff draws, the
SIGTERM guard), the reward dispatch against JAX's `_dispatch_reward`, and
the trainer's wiring against itself on the CPU at a tiny size:

- a NaN update rolls back to the last checkpoint, quarantines its rollout
  and replays the clean run's rollout-aligned rows (REINFORCE, lr 0) — the
  default sentinel did nothing before the planes were ported;
- a run with the sentinel on is bit for bit a run with it off;
- a spent rollback budget and a trip with no checkpoint raise;
- the checkpoint's fault sites: a failed write and a failed read are
  retried, a torn latest checkpoint falls back to the one before;
- a reward that fails once is retried (`reward_retries`, on by default,
  was ignored before);
- SIGTERM commits an emergency checkpoint that resumes to the
  uninterrupted run's last row;
- the planes' journals in `trainer_state.json` survive a resume."""

import json
import os
import signal
import types

import numpy as np
import pytest
import torch

from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.resilience import faults as jfaults
from nanorlhf_tpu.resilience import preemption as jpreemption
from nanorlhf_tpu.resilience import sentinel as jsentinel
from nanorlhf_tpu.resilience import watchdog as jwatchdog
from nanorlhf_tpu.telemetry import LatencyHub as JaxLatencyHub
from nanorlhf_tpu.telemetry import LineageLedger as JaxLineageLedger
from nanorlhf_tpu.telemetry import SpanTracer as JaxSpanTracer
from nanorlhf_tpu.trainer.trainer import RLTrainer as JaxRLTrainer
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.entrypoints.reinforce import build_reinforce_config
from nanorlhf_tpu_torch.resilience import (
    InjectedFault,
    Preempted,
    SentinelBudgetExceeded,
    faults,
    preemption,
    sentinel,
    watchdog,
)
from nanorlhf_tpu_torch.telemetry import LatencyHub, LineageLedger, SpanTracer, read_ledger
from nanorlhf_tpu_torch.trainer import checkpoint as tckpt
from nanorlhf_tpu_torch.trainer.optim import flatten
from nanorlhf_tpu_torch.trainer.rollout import dispatch_reward

torch.set_num_threads(1)

# rollout-level rows: functions of the data batch, the generation stream
# and the policy only
STREAM_KEYS = ("eval_objective/scores_old", "objective/entropy_old",
               "objective/kl_rollout_old")
# rows that read a clock
CLOCK_KEYS = {"time", "t_mono", "sec_per_episode", "perf/mfu",
              "perf/tokens_per_sec_step", "perf/tokens_per_sec_update",
              "perf/tokens_per_sec_rollout", "time/rollout_s", "time/reward_s",
              "time/logprob_s", "time/update_s", "time/rollout_overlap_frac"}


# ---------------------------------------------------------------------------
# the copied modules against JAX's
# ---------------------------------------------------------------------------

def _fires(mod, spec, calls=24):
    inj = mod.FaultInjector.from_spec(spec)
    out = []
    for i in range(calls):
        for point in ("ckpt.save", "reward.exec", "update.step", "worker.slow",
                      "ckpt.corrupt"):
            try:
                out.append(inj.fire(point, worker=i % 3))
            except mod.InjectedFault as e:
                out.append(f"raise {e.point}: {e}")
    return out, inj.stats()


@pytest.mark.parametrize("spec", [
    "ckpt.save:at=3",
    "reward.exec:every=2,count=3 update.step:at=5,action=nan",
    "update.step:prob=0.3,seed=7,action=nan;ckpt.save:prob=0.5",
    "worker.slow:every=2,worker=1,delay=0.5",
    "ckpt.corrupt:at=1 ckpt.save:every=4,action=hang",
    "",
])
def test_fault_schedules_match_jax(spec, monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    assert _fires(faults, spec) == _fires(jfaults, spec)
    assert faults.INJECTION_POINTS == jfaults.INJECTION_POINTS


@pytest.mark.parametrize("bad", [
    "no.such.point:at=1", "ckpt.save:at=1,every=2", "ckpt.save:at=1,action=explode",
    "ckpt.save", "ckpt.save:at", "ckpt.save:bogus=1", "ckpt.save:prob=x",
    "ckpt.save:seed=1",
])
def test_parse_fault_spec_errors_match_jax(bad):
    with pytest.raises(ValueError) as mine:
        faults.parse_fault_spec(bad)
    with pytest.raises(ValueError) as ref:
        jfaults.parse_fault_spec(bad)
    assert str(mine.value) == str(ref.value)


def test_fault_spec_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "update.step:at=1,action=nan")
    assert faults.FaultInjector.from_spec(None).fire("update.step") == "nan"
    assert faults.FaultInjector.from_spec("").armed is False


def _sentinel_trace(mod, seed, cfg):
    rng = np.random.default_rng(seed)
    sen = mod.TrainingSentinel(mod.SentinelConfig(**cfg))
    out = []
    for step in range(1, 60):
        loss = float(rng.normal(1.0, 0.1))
        grad = float(abs(rng.normal(1.0, 0.2)))
        if step == 25:
            loss = float("nan")
        if step == 40:
            loss = 30.0
        if step == 45:
            grad = float("inf")
        verdict = sen.observe(loss, grad)
        out.append(verdict)
        if verdict is not None:
            try:
                sen.note_rollback(step, step - 1, verdict)
            except mod.SentinelBudgetExceeded as e:
                out.append(str(e))
    return out, sen.journal()


@pytest.mark.parametrize("cfg", [{}, {"rollback_budget": 1, "warmup_steps": 5},
                                 {"enabled": False}, {"spike_zscore": 2.0}])
def test_sentinel_verdicts_and_journals_match_jax(cfg):
    got, want = _sentinel_trace(sentinel, 0, cfg), _sentinel_trace(jsentinel, 0, cfg)
    assert got == want
    if cfg.get("enabled", True):
        assert "nonfinite" in got[0] and "spike" in got[0]
    sen = sentinel.TrainingSentinel()
    sen.restore(want[1])
    assert sen.journal() == want[1]
    sen.steps, sen.ewma = 0, 0.0
    sen.restore_accounting(want[1])
    assert sen.quarantined == set(want[1]["quarantined"]) and sen.steps == 0


@pytest.mark.parametrize("jitter,degrade", [(0.0, True), (0.1, True), (0.3, False)])
def test_watchdog_backoff_draws_match_jax(jitter, degrade):
    def drive(mod):
        wd = mod.ProducerWatchdog(mod.WatchdogConfig(
            restart_budget=3, backoff_base=0.5, backoff_max=4.0,
            backoff_jitter=jitter, degrade_to_sync=degrade), seed=(7 << 20) ^ 1234)
        out = []
        for i in range(9):
            out.append(wd.on_failure())
            if i == 4:
                wd.on_success()
        return out, wd.journal()

    assert drive(watchdog) == drive(jwatchdog)
    wd = watchdog.ProducerWatchdog()
    wd.restore({"restarts_total": 3, "degraded": True})
    assert wd.journal() == {"restarts_total": 3, "degraded": True}


def test_preemption_guard_flags_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    guard = preemption.PreemptionGuard()
    try:
        assert guard.installed and not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)   # only a flag while installed
        assert guard.triggered
        guard.clear()
        guard.trigger()
        assert guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    a, b = preemption.null_guard(), preemption.null_guard()
    a.trigger()
    assert a is not b and not b.triggered and not a.installed
    assert issubclass(preemption.Preempted, RuntimeError)
    assert [n for n in dir(preemption) if not n.startswith("_")] == \
        [n for n in dir(jpreemption) if not n.startswith("_")]


def _flaky(fail_times: int):
    calls = {"n": 0}

    def reward(texts, eos_token):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise OSError("grader host unreachable")
        return np.asarray([float(len(t) % 5) for t in texts], np.float32)

    return reward, calls


@pytest.mark.parametrize("fail_times,spec", [(0, "reward.exec:at=1"), (1, None),
                                             (2, None)])
def test_reward_dispatch_matches_jax(fail_times, spec, tmp_path):
    """C4: the port's reward dispatch retries as JAX's `_dispatch_reward`
    does — same scores, same attempt count, the same lineage `reward`
    event; past `reward_retries` the last failure raises in both."""
    texts = ["a b", "c d e", "f"]
    results = []
    for side, (inj, tracer, hub, ledger_cls) in {
        "port": (faults.FaultInjector.from_spec(spec), SpanTracer(enabled=True),
                 LatencyHub(), LineageLedger),
        "jax": (jfaults.FaultInjector.from_spec(spec), JaxSpanTracer(enabled=True),
                JaxLatencyHub(), JaxLineageLedger),
    }.items():
        ledger = ledger_cls(str(tmp_path / side))
        reward, calls = _flaky(fail_times)
        planes = types.SimpleNamespace(
            faults=inj, tracer=tracer, latency=hub, lineage=ledger,
            reward_func=reward, cfg=types.SimpleNamespace(reward_retries=1))
        try:
            if side == "port":
                scores = dispatch_reward(reward, texts, "<eos>", 1, planes,
                                         rollout_index=4, step=2)
            else:
                scores = JaxRLTrainer._dispatch_reward(planes, texts, "<eos>",
                                                       rollout_index=4, step=2)
            out = scores.tolist()
        except (OSError, InjectedFault, jfaults.InjectedFault) as e:
            out = type(e).__name__
        ledger.close()
        spans = [e["name"] for e in tracer.trace_events() if e["ph"] == "X"]
        events = [{k: v for k, v in e.items() if k not in ("time", "t_mono", "wall_s")}
                  for e in read_ledger(str(tmp_path / side))]
        results.append((out, calls["n"], spans, hub.count("latency/reward_s"), events))
    assert results[0] == results[1]
    if fail_times <= 1:
        assert results[0][0] == [3.0, 0.0, 1.0] and results[0][4][0]["attempt"] == 2
    else:
        assert results[0][0] == "OSError"


# ---------------------------------------------------------------------------
# the trainer against itself
# ---------------------------------------------------------------------------

def _cfg(tmp_path, build=build_config, **over):
    cfg = one_card_cut(build())
    cfg.sft_model_path = "tiny-demo"
    cfg.output_dir = str(tmp_path)
    cfg.train_dataset_name = "synthetic:512"
    cfg.response_length = 6
    cfg.per_device_train_batch_size = 2
    cfg.total_episodes = 32
    cfg.lora_r, cfg.lora_alpha = 4, 8
    cfg.learning_rate = 1e-2
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _varied_reward(texts, eos_token):
    return np.asarray([float(len(t) % 7) + 0.1 * t.count("1") for t in texts],
                      np.float32)


def _trainer(tmp_path, reward=_varied_reward, **over):
    tr = common.build_trainer(_cfg(tmp_path, **over), device="cpu")
    tr.reward_func = reward
    return tr


def _rows(out) -> list[dict]:
    return [r for r in (json.loads(line) for line in open(os.path.join(out, "metrics.jsonl")))
            if "episode" in r]


def test_nan_step_rollback_replays_the_clean_runs_rows(tmp_path):
    """C5: update 2 observes an injected NaN; the sentinel restores
    checkpoint 1, quarantines rollout 1 and replays. With lr 0 (REINFORCE:
    no selection draw) the replayed rows equal the clean run's rows for the
    same rollout indices."""
    kw = dict(build=build_reinforce_config, learning_rate=0.0, save_steps=1)
    clean = _trainer(tmp_path / "clean", **kw)
    clean.train()  # 4 updates of 8 prompts
    clean.close()
    faulted = _trainer(tmp_path / "faulted", fault_spec="update.step:at=2,action=nan", **kw)
    state = faulted.train()
    assert state["global_step"] == 4 and state["rollouts"] == 5
    assert faulted.sentinel.rollbacks == 1 and faulted.sentinel.quarantined == {1}
    faulted.close()
    a, b = _rows(tmp_path / "clean"), _rows(tmp_path / "faulted")
    assert len(a) == len(b) == 4
    # clean step k consumed rollout k−1; the faulted run's steps 2..4
    # consumed rollouts 2..4
    for key in STREAM_KEYS:
        np.testing.assert_allclose(a[0][key], b[0][key], rtol=1e-6, err_msg=key)
        for s in (2, 3):
            np.testing.assert_allclose(a[s][key], b[s - 1][key], rtol=1e-6,
                                       err_msg=f"replayed {key} @ step {s}")
    assert b[-1]["resilience/rollbacks"] == 1.0
    events = [json.loads(line) for line in open(tmp_path / "faulted" / "metrics.jsonl")]
    assert [e["resilience/rollback_to_step"] for e in events if "episode" not in e] == [1.0]
    # the journal rode into the checkpoint: a fresh trainer resumes it
    res = _trainer(tmp_path / "faulted", **kw)
    res.resume_from_checkpoint()
    assert res.sentinel.rollbacks == 1 and res.sentinel.quarantined == {1}
    res.close()


def test_sentinel_on_is_bit_for_bit_sentinel_off(tmp_path):
    out = {}
    for on in (True, False):
        tr = _trainer(tmp_path / str(on), sentinel=on, save_steps=0)
        tr.train(num_updates=2)
        out[on] = ({p: t.detach().clone() for p, t in flatten(tr.trainable).items()},
                   _rows(tmp_path / str(on)))
        tr.close()
    for p, t in out[True][0].items():
        assert torch.equal(t, out[False][0][p]), p
    for r_on, r_off in zip(out[True][1], out[False][1]):
        for k in set(r_on) - CLOCK_KEYS:
            assert r_on[k] == r_off[k] or (r_on[k] != r_on[k] and r_off[k] != r_off[k]), k


@pytest.mark.parametrize("case", ["budget", "no_checkpoint"])
def test_rollback_budget_and_missing_checkpoint_raise(case, tmp_path):
    if case == "budget":
        tr = _trainer(tmp_path, save_steps=1, rollback_budget=0,
                      fault_spec="update.step:at=2,action=nan")
        with pytest.raises(SentinelBudgetExceeded):
            tr.train()
    else:
        tr = _trainer(tmp_path, save_steps=0, telemetry=True,
                      fault_spec="update.step:at=1,action=nan")
        with pytest.raises(RuntimeError, match="no committed checkpoint"):
            tr.train()
        # the flight recorder was dumped before the raise
        bb = json.load(open(tmp_path / "blackbox_1.json"))
        assert bb["reason"] == "sentinel_trip" and bb["extra"]["rollback_to_step"] is None
    tr.close()


@pytest.mark.parametrize("site", ["ckpt.save", "ckpt.restore", "ckpt.corrupt",
                                  "ckpt.save:every=1,count=3"])
def test_checkpoint_fault_sites(site, tmp_path):
    spec = site if ":" in site else f"{site}:at=1"
    tr = _trainer(tmp_path, save_steps=1, fault_spec=spec, ckpt_retry_backoff=0.0,
                  telemetry=True)
    if site == "ckpt.save:every=1,count=3":
        # every attempt of the first write fails (io_retries 2): the write
        # never commits, and train()'s final flush raises it
        with pytest.raises(InjectedFault, match="ckpt.save"):
            tr.train(num_updates=1)
        assert tr.ckpt.latest_step() is None
        tr.close()
        return
    tr.train(num_updates=2)
    if site == "ckpt.save":
        assert tr.ckpt.retry_count == 1 and tr.ckpt.latest_step() == 2
        assert _rows(tmp_path)[-1]["resilience/ckpt_retries"] == 1.0
    else:
        step = tr.restore_checkpoint()
        if site == "ckpt.restore":
            assert step == 2 and tr.ckpt.retry_count == 1
        else:   # the latest reads back torn: the one before loads
            assert step == 1 and tr.ckpt.fallback_count == 1
            assert tr.ckpt.latest_step() == 1
    tr.close()
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"ckpt.save", "ckpt.write"} <= names


def test_reward_failing_once_is_retried_by_the_trainer(tmp_path):
    """C4: a reward callable that raises once, then scores: the default
    `reward_retries=1` retries it and the update trains."""
    reward, calls = _flaky(1)
    tr = _trainer(tmp_path, reward=reward, save_steps=0)
    assert tr.cfg.reward_retries == 1
    state = tr.train(num_updates=1)
    assert state["global_step"] == 1 and calls["n"] == 2
    tr.close()
    tr = _trainer(tmp_path / "off", reward=_flaky(1)[0], save_steps=0, reward_retries=0)
    with pytest.raises(OSError):
        tr.train(num_updates=1)
    tr.close()


def test_sigterm_commits_an_emergency_checkpoint_that_resumes(tmp_path):
    """SIGTERM during update 2's reward: `Preempted` at the update's end
    with checkpoint 2 committed (periodic saves off); resuming from it
    gives the uninterrupted run's last row."""
    full = _trainer(tmp_path / "full", save_steps=0)
    full.train(num_updates=3)
    full.close()

    calls = {"n": 0}

    def sigterm_reward(texts, eos_token):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return _varied_reward(texts, eos_token)

    half = _trainer(tmp_path / "half", reward=sigterm_reward, save_steps=0,
                    telemetry=True)
    assert half._preemption.installed
    with pytest.raises(Preempted, match="emergency checkpoint"):
        half.train(num_updates=3)
    assert half.ckpt.latest_step() == 2
    half.close()
    assert json.load(open(tmp_path / "half" / "blackbox_2.json"))["reason"] == "preemption"
    assert os.path.isfile(tmp_path / "half" / "trace.json")

    res = _trainer(tmp_path / "half", save_steps=0)
    res.resume_from_checkpoint()
    assert res.state["global_step"] == 2
    res.train(num_updates=1)
    res.close()
    a, b = _rows(tmp_path / "full"), _rows(tmp_path / "half")
    assert len(a) == len(b) == 3
    for key in STREAM_KEYS + ("loss/policy_avg_new", "policy/grad_norm_new"):
        np.testing.assert_allclose(a[-1][key], b[-1][key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)


def test_journals_survive_a_resume(tmp_path):
    tr = _trainer(tmp_path, save_steps=1, lineage=True,
                  fault_spec="update.step:at=2,action=nan")
    tr.train(num_updates=2)
    journal = json.load(open(tmp_path / "checkpoint-2" / "trainer_state.json"))
    assert set(journal) >= {"resilience", "health", "lineage", "latency"}
    assert journal["resilience"]["sentinel"]["quarantined"] == [1]
    counts = {k: tr.latency.count(k) for k in tr.latency.names()}
    tr.close()
    res = _trainer(tmp_path, save_steps=1, lineage=True)
    res.resume_from_checkpoint()
    assert res.sentinel.journal()["quarantined"] == [1]
    assert res.sentinel.journal() == journal["resilience"]["sentinel"]
    assert res.health.journal()["rows"] == journal["health"]["rows"] == 2
    assert res.lineage.journal() == journal["lineage"]
    assert {k: res.latency.count(k) for k in res.latency.names()} == counts
    assert counts["latency/reward_s"] == 2 and counts["latency/phase_update_s"] == 2
    res.close()


def test_checkpoint_manager_takes_faults_and_a_tracer(tmp_path):
    """The manager alone: a torn read with no intact checkpoint left raises
    the injected fault; its spans sit on the "ckpt" track."""
    tracer = SpanTracer(enabled=True)
    mgr = tckpt.CheckpointManager(str(tmp_path), tracer=tracer,
                                  faults=faults.FaultInjector.from_spec("ckpt.corrupt:every=1"))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(InjectedFault, match="no intact checkpoint"):
        mgr.restore(1)
    mgr.close()
    spans = [(e["name"], e["tid"]) for e in tracer.trace_events() if e["ph"] == "X"]
    assert [n for n, _ in spans] == ["ckpt.save", "ckpt.write"]
    assert len({tid for _, tid in spans}) == 1
