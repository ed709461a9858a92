"""The port's elastic rollout fleet (`nanorlhf_tpu_torch/orchestrator/fleet.py`)
and autoscaler (`loadgen/autoscaler.py`) against the JAX package's
(`tests/test_fleet.py`'s counterparts):

- JAX's coordinator and satellite unit tests (leases in index order under
  the staleness gate, a crashed worker's lease reassigned with the same
  batches, quarantine with jittered backoff, straggler and hang revocation,
  fleet exhaustion, elastic membership, the journal, the backoff draws,
  `wait_for_version`, the multi-producer overlap meter) run against the
  port's copies, over both transports;
- the trainer on the CPU: at staleness 0 the fleet — with a worker
  crashed mid-lease and its lease reassigned, over the in-process and the
  loopback-RPC transport — gives the synchronous trainer's streams bit for
  bit; losing every worker rides the watchdog into the synchronous
  degraded mode; checkpoint → resume and a SIGTERM'd run's emergency
  checkpoint reproduce the streams; a worker joins between train() calls;
- the autoscaler (a copy) decides as JAX's on the same SLO sequence and
  actuates the port's fleet: scale up on a sustained breach, drain-remove
  back to the floor on a sustained recovery.
"""

import os
import signal

import numpy as np
import pytest
import torch

from _torch_counterparts import run_jax_test
from _torch_parity import closes_trainers  # noqa: F401 (autouse)
from nanorlhf_tpu.loadgen import autoscaler as jautoscaler
from nanorlhf_tpu.trainer import AlgoName as JaxAlgoName
from nanorlhf_tpu_torch.entrypoints import common
from nanorlhf_tpu_torch.loadgen import autoscaler as tautoscaler
from nanorlhf_tpu_torch.orchestrator import FleetConfig, FleetOrchestrator
from nanorlhf_tpu_torch.resilience import Preempted
from test_torch_orchestrator import assert_same_run, cfg_for, run_trainer, varied_reward
from test_trainer_smoke import make_trainer

torch.set_num_threads(1)

FLEET = dict(rollout_orchestrator=True, rollout_workers=2, max_staleness=0)

JAX_UNITS = [
    ("test_backoff_jitter_bounds_and_determinism", {}),
    ("test_wait_for_version_blocks_until_publish", {}),
    ("test_overlap_meter_multiproducer_compaction_exact", {}),
    ("test_fleet_grants_in_order_and_respects_staleness_gate", {"transport": "inprocess"}),
    ("test_fleet_grants_in_order_and_respects_staleness_gate", {"transport": "rpc"}),
    ("test_worker_crash_reassigns_lease_with_same_batches", {"transport": "inprocess"}),
    ("test_worker_crash_reassigns_lease_with_same_batches", {"transport": "rpc"}),
    ("test_consecutive_failures_quarantine_with_backoff", {}),
    ("test_straggler_lease_expires_and_is_speculatively_redispatched", {}),
    ("test_hang_mid_lease_revoked_by_deadline", {}),
    ("test_all_workers_lost_raises_fleet_exhausted", {}),
    ("test_elastic_join_and_leave", {}),
    ("test_coordinator_journal_and_restore_counters", {}),
]


@pytest.mark.parametrize("name,params", JAX_UNITS,
                         ids=[f"{n}[{p.get('transport', '')}]" for n, p in JAX_UNITS])
def test_jax_units_hold_on_the_port(name, params, monkeypatch, tmp_path):
    swapped = run_jax_test(monkeypatch, "test_fleet", name,
                           {"tmp_path": tmp_path, "monkeypatch": monkeypatch}, **params)
    assert {"FleetCoordinator", "FleetOrchestrator", "VersionedWeightStore",
            "FaultInjector", "backoff_delay"} <= set(swapped)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    """One synchronous 3-update run: the bit-parity reference."""
    mp = pytest.MonkeyPatch()
    try:
        return run_trainer(tmp_path_factory.mktemp("serial"), mp)[:2]
    finally:
        mp.undo()


@pytest.mark.parametrize("transport", ["inprocess", "rpc"])
def test_worker_crash_mid_lease_bit_identical_stream(transport, serial, tmp_path,
                                                     monkeypatch):
    """Worker 0 crashes on its first lease: the lease is reassigned with the
    same cached batch and the same index-keyed stream, so the tokens and
    the rows equal the synchronous trainer's — over the RPC transport too,
    where leases, completions and weights cross the wire codec."""
    seen, rows, tr = run_trainer(tmp_path, monkeypatch, rollout_transport=transport,
                                 fault_spec="worker.crash:at=1,worker=0", **FLEET)
    assert_same_run(serial, (seen, rows))
    last = rows[-1]
    assert last["fleet/reassigned_leases"] >= 1.0
    assert last["fleet/worker_losses"] == 1.0 and last["fleet/workers"] == 1.0
    assert last["resilience/degraded_mode"] == 0.0
    if transport == "rpc":
        assert last["fleet/rpc_bytes_tx"] > 0.0


def test_fleet_staleness0_no_fault_matches_synchronous(serial, tmp_path, monkeypatch):
    assert_same_run(serial, run_trainer(tmp_path, monkeypatch, **FLEET)[:2])


def test_all_workers_lost_degrades_to_sync(serial, tmp_path, monkeypatch):
    """Every worker dies on every dispatch: the watchdog restarts the fleet
    once, exhausts its budget, and the run completes on synchronous
    rollouts with the synchronous streams (no deadlock), saying so in its
    rows."""
    seen, rows, tr = run_trainer(
        tmp_path, monkeypatch, rollout_orchestrator=True, rollout_workers=2,
        max_staleness=1, producer_restart_budget=1, producer_backoff_base=0.01,
        producer_backoff_max=0.05, fault_spec="worker.crash:every=1")
    assert tr.state["global_step"] == 3
    assert tr.watchdog.degraded and tr.watchdog.restarts_total == 1
    assert rows[-1]["resilience/degraded_mode"] == 1.0
    assert_same_run(serial, (seen, rows))


def test_fleet_checkpoint_resume_identical_streams(serial, tmp_path, monkeypatch):
    kw = dict(save_steps=1, **FLEET)
    run_trainer(tmp_path, monkeypatch, updates=2, **kw)
    journal = common.build_trainer(cfg_for(tmp_path, **kw), device="cpu")
    state = journal.ckpt.load_trainer_state(2)
    journal.close()
    granted = state["orchestrator"]["fleet"]["counters"]["leases_granted"]
    assert granted >= 2
    tr = common.build_trainer(cfg_for(tmp_path, **kw), device="cpu")
    tr.resume_from_checkpoint()
    seen, rows, tr = run_trainer(tmp_path, monkeypatch, updates=1, trainer=tr)
    np.testing.assert_array_equal(seen[2], serial[0][2])
    assert_same_run(({2: serial[0][2]}, serial[1][2:]), (seen, rows[2:]))
    assert rows[-1]["fleet/leases_granted"] > granted


def test_fleet_sigterm_emergency_checkpoint_resumes(serial, tmp_path, monkeypatch):
    calls = {"n": 0}

    def sigterm_reward(texts, eos):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return varied_reward(texts, eos)

    half = common.build_trainer(cfg_for(tmp_path, save_steps=0, **FLEET), device="cpu")
    if not half._preemption.installed:
        half.close()
        pytest.skip("the SIGTERM handler needs the main thread")
    half.reward_func = sigterm_reward
    with pytest.raises(Preempted, match="emergency checkpoint"):
        half.train(num_updates=3)
    assert half.ckpt.latest_step() == 2
    assert "fleet" in half.ckpt.load_trainer_state(2)["orchestrator"]
    half.close()
    res = common.build_trainer(cfg_for(tmp_path, save_steps=0, **FLEET), device="cpu")
    res.resume_from_checkpoint()
    seen, rows, _ = run_trainer(tmp_path, monkeypatch, updates=1, trainer=res)
    assert_same_run(({2: serial[0][2]}, serial[1][2:]), (seen, rows[2:]))


def test_fleet_worker_joins_mid_run(tmp_path, monkeypatch):
    tr = common.build_trainer(cfg_for(tmp_path, rollout_orchestrator=True,
                                      rollout_workers=2, max_staleness=1), device="cpu")
    tr.reward_func = varied_reward
    tr.train(num_updates=1)
    tr._orchestrator.add_worker()
    _, rows, _ = run_trainer(tmp_path, monkeypatch, updates=2, trainer=tr)
    assert rows[-1]["fleet/worker_joins"] == 3.0 and rows[-1]["fleet/workers"] == 3.0


def test_fleet_requires_orchestrator(tmp_path):
    with pytest.raises(ValueError) as jerr:
        make_trainer(JaxAlgoName.GRPO, tmp_path / "jax", rollout_workers=2)
    with pytest.raises(ValueError) as perr:
        common.build_trainer(cfg_for(tmp_path / "port", rollout_workers=2), device="cpu")
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the autoscaler over the port's fleet
# ---------------------------------------------------------------------------

LEVELS = ["ok", "crit", "crit", "crit", "ok", "ok", "ok", "ok", "ok", "ok", "warn", "ok"]


def _scaler(mod, fleet_ops, levels, clock):
    it = iter(levels)
    return mod.Autoscaler(
        add_worker=fleet_ops[0], remove_worker=fleet_ops[1], worker_ids=fleet_ops[2],
        slo_level=lambda: next(it), clock=lambda: clock[0],
        config=mod.AutoscalerConfig(min_workers=1, max_workers=2, breach_evals=2,
                                    recovery_evals=3, cooldown_s=1.0))


def test_autoscaler_scales_the_port_fleet_as_jax_decides(tmp_path):
    """The copy's decisions equal JAX's tick for tick on one SLO sequence
    (a fake fleet for JAX's), and actuate the port's fleet: up to 2 workers
    on a sustained breach, drain-removed back to 1 on a sustained
    recovery, no lease stranded."""
    def dispatch(index, queries, tree, worker_id):
        return {"index": index}

    batches = iter(range(10_000))
    orch = FleetOrchestrator(dispatch_fn=dispatch, batch_fn=lambda: next(batches),
                             initial_params={}, n_workers=1, max_staleness=2,
                             fleet=FleetConfig(poll_interval=0.02))
    ids = [0]
    fake = (lambda: ids.append(max(ids) + 1) or ids[-1],
            lambda wid: ids.remove(wid), lambda: list(ids))
    real = (orch.add_worker,
            lambda wid: orch.remove_worker(wid, drain=True, drain_timeout_s=10.0),
            orch.coordinator.live_worker_ids)
    clock = [0.0]
    port = _scaler(tautoscaler, real, LEVELS, clock)
    ref = _scaler(jautoscaler, fake, LEVELS, clock)
    got, want, sizes = [], [], []
    try:
        for _ in LEVELS:
            clock[0] += 2.0
            got.append(port.evaluate())
            want.append(ref.evaluate())
            sizes.append(len(orch.coordinator.live_worker_ids()))
        assert got == want and "scale_up" in got and "scale_down" in got
        assert max(sizes) == 2 and sizes[-1] == 1
        assert port.metrics() == ref.metrics()
        assert orch.coordinator.counters["reassigned_leases"] == 0
    finally:
        orch.close()
