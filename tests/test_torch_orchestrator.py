"""The port's async rollout orchestrator (`nanorlhf_tpu_torch/orchestrator/`)
against the JAX package's (`tests/test_orchestrator.py`'s counterparts):

- JAX's own unit tests of the bounded-staleness queue, the producer
  thread and the overlap meter, run against the port's copies
  (`_torch_counterparts.run_jax_test` swaps the JAX test module's imports
  for the port's classes);
- the trainer on the CPU at a tiny size: an orchestrated run at staleness 0
  gives the synchronous trainer's token streams and metric rows bit for
  bit, for every dense algorithm; with the policy frozen (lr 0) a
  staleness-1 truncated-IS run equals the on-policy run; checkpoint →
  resume reproduces the streams and carries the orchestrator's counters;
  a producer killed by `rollout.produce` is restarted by the watchdog;
  JAX's ValueErrors on the orchestrator's knobs, with its messages;
- the snapshot contract (trainable leaves cloned, frozen leaves aliased,
  no published tensor aliasing a live trainable leaf), and the threading
  repairs the producer threads need: per-thread launch recording, the
  collector paused across concurrent captures, captures in CUDA's
  "thread_local" mode, `sync_device` waiting on the current stream only.
"""

import gc
import json
import os
import threading

import numpy as np
import pytest
import torch

from _torch_counterparts import run_jax_test
from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu_torch import _build
from nanorlhf_tpu_torch.core.lora import trainable_mask
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.entrypoints.grpo import build_config, one_card_cut
from nanorlhf_tpu_torch.orchestrator import OverlapMeter, note_ready_async
from nanorlhf_tpu_torch.sampler import graph as tg
from nanorlhf_tpu_torch.sampler import sampler as ts
from nanorlhf_tpu_torch.trainer import trainer as ttrainer
from nanorlhf_tpu_torch.trainer.optim import flatten
from test_trainer_smoke import make_trainer

torch.set_num_threads(1)

# rows that read a clock or the pipeline's own counters
CLOCK = {"time", "t_mono", "sec_per_episode", "perf/mfu", "perf/tokens_per_sec_step",
         "perf/tokens_per_sec_update", "perf/tokens_per_sec_rollout", "time/rollout_s",
         "time/reward_s", "time/logprob_s", "time/update_s", "time/publish_s",
         "time/rollout_overlap_frac", "perf/recompile_seconds"}


# ---------------------------------------------------------------------------
# shared trainer helpers (the fleet, swap and rollout_ahead tests use them)
# ---------------------------------------------------------------------------

def cfg_for(tmp_path, build=build_config, **over):
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


def varied_reward(texts, eos):
    return np.asarray([len(t) % 5 / 5.0 for t in texts], np.float32)


def metric_rows(out) -> list[dict]:
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [r for r in (json.loads(line) for line in fh) if "episode" in r]


def run_trainer(tmp_path, monkeypatch, updates=3, build=build_config, trainer=None,
                reward=varied_reward, **over):
    """Train `updates` updates on the CPU; returns (the responses of every
    scored rollout by index, the metric rows, the trainer — closed)."""
    seen = {}
    real = ttrainer.score_rollout

    def spy(payload, *a, rollout_index=None, **kw):
        seen[rollout_index] = payload["responses"].copy()
        return real(payload, *a, rollout_index=rollout_index, **kw)

    monkeypatch.setattr(ttrainer, "score_rollout", spy)
    tr = trainer or common.build_trainer(cfg_for(tmp_path, build, **over), device="cpu")
    tr.reward_func = reward
    try:
        tr.train(num_updates=updates)
    finally:
        tr.close()
        monkeypatch.setattr(ttrainer, "score_rollout", real)
    return seen, metric_rows(tr.cfg.output_dir), tr


def assert_same_run(a, b, keys=None):
    """Equal token streams by rollout index and equal metric rows (bit for
    bit, clock rows and the pipeline's own rows aside)."""
    (sa, ra), (sb, rb) = a, b
    assert sorted(sa) == sorted(sb)
    for i in sa:
        np.testing.assert_array_equal(sa[i], sb[i])
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        for k in keys or x:
            if k in CLOCK or k.startswith(("orchestrator/", "fleet/", "telemetry/",
                                           "latency/", "health/", "resilience/")):
                continue
            assert x[k] == y[k], k


# ---------------------------------------------------------------------------
# JAX's unit tests on the port's copies
# ---------------------------------------------------------------------------

JAX_UNITS = ["test_staleness_bound_enforced_slow_consumer",
             "test_drop_policy_counts_drops_and_keeps_bound",
             "test_producer_error_surfaces_in_get",
             "test_queue_journal_and_restore_counters",
             "test_overlap_meter_interval_math",
             "test_overlap_meter_compaction_preserves_fraction"]


@pytest.mark.parametrize("name", JAX_UNITS)
def test_jax_units_hold_on_the_port(name, monkeypatch, tmp_path):
    swapped = run_jax_test(monkeypatch, "test_orchestrator", name,
                           {"tmp_path": tmp_path, "monkeypatch": monkeypatch})
    assert {"BoundedStalenessQueue", "OverlapMeter", "RolloutOrchestrator"} <= set(swapped)


def test_copies_are_the_ports():
    import test_orchestrator as jt
    from nanorlhf_tpu_torch.orchestrator import sample_queue, weight_store

    assert sample_queue.__name__.startswith("nanorlhf_tpu_torch")
    assert weight_store.VersionedWeightStore is not jt.BoundedStalenessQueue
    assert OverlapMeter.__module__ == "nanorlhf_tpu_torch.telemetry.overlap"


def test_note_ready_async_records_the_window():
    """On host data (and the CPU) the waiter notes [t0, ready] at once."""
    meter = OverlapMeter()
    note_ready_async(meter, {"x": torch.zeros(3)}, 1.0)
    for t in threading.enumerate():
        if t.name == "rollout-ready-watch":
            t.join(timeout=5)
    meter.note_busy(1.0, 1e12)
    assert meter.overlap_fraction() > 0.99


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_staleness0_matches_synchronous_trainer(tmp_path, monkeypatch):
    """Staleness 0: the producer generates rollout k from version k, the
    weights the synchronous trainer samples rollout k from, with the same
    index-keyed stream: the token streams and the rows are bit for bit."""
    sync = run_trainer(tmp_path / "sync", monkeypatch)
    orch = run_trainer(tmp_path / "orch", monkeypatch, rollout_orchestrator=True,
                       max_staleness=0)
    assert_same_run(sync[:2], orch[:2])
    rows = orch[1]
    assert [r["orchestrator/staleness"] for r in rows] == [0.0, 0.0, 0.0]
    assert rows[-1]["orchestrator/staleness_hist_0"] == 3.0
    assert orch[2].state["rollouts"] == 3


@pytest.mark.parametrize("algo", ["grpo", "rloo", "reinforce", "remax", "raft"])
def test_orchestrated_all_dense_algos_one_update(algo, tmp_path, monkeypatch):
    from nanorlhf_tpu_torch.entrypoints import raft, reinforce, remax, rloo

    build = {"grpo": build_config, "rloo": rloo.build_rloo_config,
             "reinforce": reinforce.build_reinforce_config,
             "remax": remax.build_remax_config, "raft": raft.build_raft_config}[algo]
    sync = run_trainer(tmp_path / "sync", monkeypatch, updates=2, build=build)
    orch = run_trainer(tmp_path / "orch", monkeypatch, updates=2, build=build,
                       rollout_orchestrator=True, max_staleness=0)
    assert_same_run(sync[:2], orch[:2])


def test_truncated_is_staleness1_matches_onpolicy_when_policy_frozen(tmp_path,
                                                                    monkeypatch):
    """lr 0: every version is the same policy, so a staleness-1 run with
    captured behavior logprobs samples the on-policy streams; its IS
    weights are the captured-vs-scored ratio (1 within the decode path's
    rounding) and none truncates."""
    sync = run_trainer(tmp_path / "sync", monkeypatch, learning_rate=0.0)
    stale = run_trainer(tmp_path / "stale", monkeypatch, learning_rate=0.0,
                        rollout_orchestrator=True, max_staleness=1,
                        sampler_logprob_capture=True, offpolicy_correction="truncated_is")
    for i in sync[0]:
        np.testing.assert_array_equal(sync[0][i], stale[0][i])
    for a, b in zip(sync[1], stale[1]):
        assert abs(b["offpolicy/is_weight_mean_new"] - 1.0) < 1e-4
        assert b["offpolicy/is_trunc_frac_new"] == 0.0
        np.testing.assert_allclose(b["loss/policy_avg_new"], a["loss/policy_avg_new"],
                                   rtol=0, atol=1e-5)
        assert a["eval_objective/scores_old"] == b["eval_objective/scores_old"]
    assert max(r["orchestrator/staleness"] for r in stale[1]) == 1.0


def test_checkpoint_resume_identical_token_streams(tmp_path, monkeypatch):
    """Two updates, a checkpoint, a fresh trainer resumed from it: the third
    rollout's tokens and rows equal the uninterrupted run's."""
    kw = dict(rollout_orchestrator=True, max_staleness=0, save_steps=1)
    full = run_trainer(tmp_path / "full", monkeypatch, **kw)
    run_trainer(tmp_path / "cut", monkeypatch, updates=2, **kw)
    tr = common.build_trainer(cfg_for(tmp_path / "cut", **kw), device="cpu")
    tr.resume_from_checkpoint()
    assert tr.state["global_step"] == 2 and tr.state["rollouts"] == 2
    resumed = run_trainer(tmp_path / "cut", monkeypatch, updates=1, trainer=tr)
    np.testing.assert_array_equal(resumed[0][2], full[0][2])
    assert_same_run(({2: full[0][2]}, full[1][2:]), (resumed[0], resumed[1][2:]))


def test_resume_restores_orchestrator_counters(tmp_path, monkeypatch):
    kw = dict(rollout_orchestrator=True, max_staleness=0, save_steps=1)
    run_trainer(tmp_path, monkeypatch, updates=2, **kw)
    state = json.load(open(tmp_path / "checkpoint-2" / "trainer_state.json"))
    assert state["orchestrator"]["staleness_counts"] == {"0": 2}
    tr = common.build_trainer(cfg_for(tmp_path, **kw), device="cpu")
    tr.resume_from_checkpoint()
    _, rows, _ = run_trainer(tmp_path, monkeypatch, updates=1, trainer=tr)
    assert rows[-1]["orchestrator/staleness_hist_0"] == 3.0


def test_producer_crash_is_restarted_by_the_watchdog(tmp_path, monkeypatch):
    """`rollout.produce` kills the producer at its 2nd dispatch: the watchdog
    restarts it from the consumed cursor and the streams are the
    synchronous run's."""
    sync = run_trainer(tmp_path / "sync", monkeypatch)
    crash = run_trainer(tmp_path / "crash", monkeypatch, rollout_orchestrator=True,
                        max_staleness=0, fault_spec="rollout.produce:at=2",
                        producer_backoff_base=0.01)
    assert_same_run(sync[:2], crash[:2])
    assert crash[1][-1]["resilience/producer_restarts"] == 1.0
    assert crash[1][-1]["resilience/degraded_mode"] == 0.0
    assert crash[2].watchdog.restarts_total == 1


def test_orchestrator_rejected_with_rollout_ahead(tmp_path):
    """JAX's ValueErrors on the orchestrator's knobs, with its messages."""
    for knobs in (dict(rollout_ahead=True), dict(max_staleness=-1),
                  dict(staleness_policy="lifo")):
        with pytest.raises(ValueError) as jerr:
            make_trainer(JaxAlgoName.GRPO, tmp_path / "jax",
                         rollout_orchestrator=True, **knobs)
        with pytest.raises(ValueError) as perr:
            common.build_trainer(cfg_for(tmp_path / "port", rollout_orchestrator=True,
                                         **knobs), device="cpu")
        assert str(perr.value) == str(jerr.value)


def test_overlap_frac_orchestrator_beats_synchronous(tmp_path, monkeypatch):
    """The synchronous loop's generation never overlaps its own update
    (overlap 0 exactly); the orchestrator's producer generates while the
    consumer grades and trains (a reward that takes 50 ms a call)."""
    import time

    def slow(texts, eos):
        time.sleep(0.05)
        return varied_reward(texts, eos)

    _, sync_rows, _ = run_trainer(tmp_path / "sync", monkeypatch, reward=slow)
    _, orch_rows, tr = run_trainer(tmp_path / "orch", monkeypatch, reward=slow,
                                   rollout_orchestrator=True, max_staleness=1)
    assert sync_rows[-1]["time/rollout_overlap_frac"] == 0.0
    assert orch_rows[-1]["time/rollout_overlap_frac"] > 0.0
    assert tr.rollout_overlap_frac() == pytest.approx(
        orch_rows[-1]["time/rollout_overlap_frac"], abs=0.5)


def test_policy_snapshot_clones_trainable_and_aliases_frozen(tmp_path, monkeypatch):
    """No published tensor aliases a live trainable leaf (the optimizer
    steps those in place); frozen leaves are the live tensors; an update
    after the publish leaves the snapshot as it was."""
    tr = common.build_trainer(cfg_for(tmp_path), device="cpu")
    tr.reward_func = varied_reward
    snap = tr._policy_snapshot()
    mask = flatten(trainable_mask(tr.params, tr.lora_cfg))
    live, pub = flatten(tr.params), flatten(dict(snap))
    assert snap.ready is None       # the CPU: nothing to wait on
    assert any(mask.values()) and not all(mask.values())
    before = {p: t.clone() for p, t in pub.items() if mask[p]}
    for p, t in pub.items():
        if mask[p]:
            assert t.untyped_storage().data_ptr() != live[p].untyped_storage().data_ptr()
            assert torch.equal(t, live[p]) and not t.requires_grad
        else:
            assert t is live[p]
    run_trainer(tmp_path, monkeypatch, updates=1, trainer=tr)
    assert any(not torch.equal(before[p], live[p]) for p in before)
    assert all(torch.equal(before[p], pub[p]) for p in before)


# ---------------------------------------------------------------------------
# threads, graphs and streams
# ---------------------------------------------------------------------------

def test_launch_recording_is_per_thread(monkeypatch):
    """A capture on a producer thread records that thread's launches only:
    the trainer thread's launch meanwhile is counted, not swallowed."""
    monkeypatch.setattr(_build.Kernel, "function",
                        lambda self, symbol, argtypes: (lambda *a: 0))
    _build.reset_launch_counts()
    k = _build.KERNELS["flash_fwd"]
    inside, release = threading.Event(), threading.Event()
    recs = []

    def capture():
        with _build.recording_launches() as rec:
            k.launch("x", [])
            inside.set()
            release.wait(5)
        recs.append(dict(rec))

    th = threading.Thread(target=capture)
    th.start()
    assert inside.wait(5)
    k.launch("x", [])                 # the trainer's launch, mid-capture
    assert not _build._stack()      # this thread records nothing
    release.set()
    th.join(5)
    assert recs == [{"flash_fwd": 1}] and k.launches == 1
    _build.reset_launch_counts()


class _GatedGraph:
    """A stand-in capture that holds until the test lets it end."""

    def __init__(self, entered, leave, log):
        self.entered, self.leave, self.log = entered, leave, log

    def capture(self, fn):
        fn()
        self.entered.set()
        assert self.leave.wait(5)
        self.log.append(gc.isenabled())

    def replay(self):
        pass


def test_concurrent_captures_keep_the_collector_paused():
    """Two threads capture at once: the first to end must not re-enable the
    collector while the second still captures (one shared count); the last
    to end restores it."""
    assert gc.isenabled()
    log = []
    gates = [(threading.Event(), threading.Event()) for _ in range(2)]
    loops = [tg.ChunkedLoop(lambda: None, sync_every=1, device="cpu", use_graph=True,
                            graph_factory=lambda g=g: _GatedGraph(*g, log))
             for g in gates]
    for loop in loops:
        loop.run_chunk()              # the eager warm-up chunk
    threads = [threading.Thread(target=loop.run_chunk) for loop in loops]
    threads[0].start()
    assert gates[0][0].wait(5)
    threads[1].start()
    assert gates[1][0].wait(5)
    gates[0][1].set()                 # the first capture ends ...
    threads[0].join(5)
    assert not gc.isenabled()         # ... the second still captures
    gates[1][1].set()
    threads[1].join(5)
    assert log == [False, False] and gc.isenabled()


def test_capture_begins_in_thread_local_mode(monkeypatch):
    """`CudaGraphChunk.capture` opens the capture in "thread_local" mode: in
    "global" mode every other thread's allocation would fail while a
    producer captures."""
    calls = []

    class FakeGraph:
        def capture_begin(self, **kw):
            calls.append(("begin", kw))

        def capture_end(self):
            calls.append(("end", {}))

    class FakeStream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: __import__("contextlib").nullcontext())
    chunk = tg.CudaGraphChunk("cpu")
    chunk.capture(lambda: calls.append(("body", {})))
    assert calls == [("begin", {"capture_error_mode": "thread_local"}), ("body", {}),
                     ("end", {})]


def test_sync_device_waits_on_the_current_stream_only(monkeypatch):
    waited = []

    class FakeStream:
        def synchronize(self):
            waited.append("stream")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: FakeStream())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waited.append("device"))
    ts.sync_device(torch.device("cuda"))
    ts.sync_device(torch.device("cpu"))
    assert waited == ["stream"]
