"""Chaos soak runner — the port of `nanorlhf_tpu/chaos/runner.py`.

Drives one end-to-end run — loadgen → the port's `ServingEngine` — under
a composed fault schedule, journaling the chaos provenance into the run's
lineage ledger as it goes (`chaos_run` header, one `fault` event per
fire, one `chaos_audit` verdict per invariant), then audits the finished
run's global invariants from the ledger plus end-of-run component
snapshots.

Verdicts are journaled AFTER component teardown (worker-leak evidence
only exists post-close), by reopening the ledger — the ledger resumes by
appending to its newest rotation file, so the audit tail lands in the
same replayable stream `tools/inspect_run.py --chaos` reads.

`soak_trainer` runs a GRPO trainer with the rollout fleet (two workers
under the orchestrator, `nanorlhf_tpu/chaos/runner.py:259-260`), which the
port does not have yet (ROADMAP A12): it raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from nanorlhf_tpu_torch.chaos.auditors import run_audits
from nanorlhf_tpu_torch.chaos.composer import ChaosPlan, compose
from nanorlhf_tpu_torch.chaos.shrink import repro_command

# thread-name prefixes this project owns — the worker-leak auditor only
# flags names matching these, so unrelated test-runner threads never
# produce false leaks
_THREAD_PREFIXES = (
    "fleet-", "rollout-", "serving-", "loadgen-", "status-exporter",
)


@dataclasses.dataclass
class SoakReport:
    """One soak's outcome: the plan that ran, every auditor verdict,
    and the injector's per-site fire counts."""

    plan: ChaosPlan
    audits: list
    fault_stats: dict
    summary: dict

    @property
    def ok(self) -> bool:
        return all(a.ok for a in self.audits)

    @property
    def failed(self) -> list:
        return [a for a in self.audits if not a.ok]

    def fired_sites(self) -> set:
        return {p for p, s in self.fault_stats.items()
                if s.get("fires", 0) > 0}

    def repro(self, run_dir: str | None = None) -> str:
        return repro_command(self.plan.clauses, path=self.plan.path,
                             seed=self.plan.seed, run_dir=run_dir)


def _thread_names() -> set:
    return {t.name for t in threading.enumerate() if t.is_alive()}


def _leaked_threads(before: set) -> list:
    """Project-owned thread names alive now that were not alive before
    the soak. Teardown joins are synchronous, so no grace loop."""
    return sorted(n for n in _thread_names() - before
                  if n.startswith(_THREAD_PREFIXES))


def _fault_hook(ledger, t0: float):
    """on_fire observer: journal every fire as an index-less `fault`
    event with its offset from soak start (perf_counter — durations
    never come from the wall clock)."""

    def on_fire(point, worker, action):
        ledger.fault(point=point, worker=worker, action=action,
                     t_offset=round(time.perf_counter() - t0, 6))

    return on_fire


def _journal_audits(run_dir: str, plan: ChaosPlan, audits) -> None:
    """Append the verdicts to the run's ledger post-teardown (reopening
    resumes the newest rotation file — no clobber)."""
    from nanorlhf_tpu_torch.telemetry.lineage import LineageLedger

    ledger = LineageLedger(run_dir, enabled=True)
    for a in audits:
        ledger.chaos_audit(name=a.name, ok=a.ok, detail=a.detail or None,
                           checked=a.checked, spec_digest=plan.digest)
    ledger.close()


def soak_serving(run_dir: str, plan: ChaosPlan = None, *, seed: int = 0,
                 n_sites: int = 3, n_requests: int = 24,
                 time_scale: float = 0.02, device="cuda",
                 model=None) -> SoakReport:
    """Serving-path soak: an open-loop workload through an in-process
    `ServingEngine` on `device` (the card unless the caller asks for the
    CPU) with gw.disconnect armed on the client side (the driver IS the
    client for the in-process target). Quiescence plus teardown, then the
    auditor sweep over ledger + snapshots. The engine's and the traffic's
    sizes are JAX's (2 rows, pages of 4, 12-token prompts, 8 new tokens;
    `n_requests` at 40 requests/s); `model` is a `(config, params)` pair
    on `device`, by default JAX's tiny f32 model (vocab 128, seed 7).
    `run_dir` must hold no lineage ledger yet: the audits read every event
    in it, and a ledger resumes by appending (FileExistsError)."""
    import glob
    import os

    import torch

    from nanorlhf_tpu_torch.core.config import ModelConfig
    from nanorlhf_tpu_torch.core.model import init_params
    from nanorlhf_tpu_torch.loadgen.driver import TrafficDriver
    from nanorlhf_tpu_torch.loadgen.workload import WorkloadSpec
    from nanorlhf_tpu_torch.resilience.faults import FaultInjector
    from nanorlhf_tpu_torch.serving.engine import ServingEngine
    from nanorlhf_tpu_torch.telemetry.hist import LatencyHub
    from nanorlhf_tpu_torch.telemetry.lineage import LineageLedger, read_ledger

    if glob.glob(os.path.join(run_dir, "lineage", "ledger_*.jsonl")):
        raise FileExistsError(
            f"{run_dir} already holds a lineage ledger: a soak audits every "
            "event in its run dir, so it needs a fresh one")
    if plan is None:
        plan = compose(seed, "serving", n_sites=n_sites)
    if model is None:
        config = ModelConfig.qwen2_tiny(vocab_size=128)
        model = (config, init_params(config, 7, torch.float32, device))
    config, params = model
    os.makedirs(run_dir, exist_ok=True)
    before = _thread_names()
    t0 = time.perf_counter()

    ledger = LineageLedger(run_dir, enabled=True)
    ledger.chaos_run(seed=plan.seed, spec=plan.spec,
                     spec_digest=plan.digest, path=plan.path,
                     key_path=plan.key_path)
    injector = FaultInjector.from_spec(plan.spec or None)
    injector.on_fire = _fault_hook(ledger, t0)

    hub = LatencyHub(enabled=True)
    engine = ServingEngine(params, config, eos_token_id=3, pad_token_id=0,
                           page_size=4, prompt_len=12, max_new_tokens=8,
                           rows=2, latency=hub, seed=plan.seed, device=device)
    driver = TrafficDriver(engine=engine, latency=hub, lineage=ledger,
                           faults=injector, time_scale=time_scale)
    spec = WorkloadSpec(seed=plan.seed, n_requests=n_requests,
                        rate_rps=40.0, prompt_len_max=12, token_hi=120,
                        max_tokens_max=8)
    try:
        run_summary = driver.run(spec)
    finally:
        engine.close()
        ledger.close()

    snap = engine.snapshot()
    counters = snap["counters"]
    metrics = engine.metrics()
    ctx = {
        "engine": snap,
        "radix": snap["prefix_cache"],
        "loadgen": driver.metrics(),
        "live_table_rows": [
            r for r in range(engine.rows)
            if any(int(p) < engine.num_pages
                   for p in engine.session.table_np[r])
        ],
        "leaked_threads": _leaked_threads(before),
        "leaked_procs": 0,
        "honesty": [
            # internal degradation counters must reach the exported
            # metric surface — a silent cancel is a dishonest recovery
            ("serving_cancelled", counters.get("cancelled", 0),
             metrics.get("serving/cancelled", 0)),
            ("disconnect_shed", snap["shed_reasons"].get("disconnect", 0),
             metrics.get('serving/shed_total{reason="disconnect"}', 0)),
            # every injector fire must have a journaled fault event
            ("faults_journaled",
             sum(s.get("fires", 0) for s in injector.stats().values()),
             sum(1 for e in read_ledger(run_dir)
                 if e.get("type") == "fault")),
        ],
    }
    events = list(read_ledger(run_dir))
    audits = run_audits(events, ctx)
    _journal_audits(run_dir, plan, audits)
    return SoakReport(plan=plan, audits=audits,
                      fault_stats=injector.stats(),
                      summary={"offered": run_summary.offered,
                               "completed": run_summary.completed,
                               "errors": run_summary.errors,
                               "shed": run_summary.shed})


def soak_trainer(run_dir: str, plan: ChaosPlan = None, *, seed: int = 0,
                 n_sites: int = 3, total_episodes: int = 48) -> SoakReport:
    """Trainer-path soak (JAX: a tiny GRPO run with the rollout fleet — two
    workers under the orchestrator, strict staleness — under the composed
    schedule). The port has no orchestrator or fleet yet: raises."""
    raise NotImplementedError(
        "chaos soak_trainer runs the GRPO trainer with the rollout fleet "
        "(rollout_orchestrator=True, rollout_workers=2), which is not ported "
        "to nanorlhf_tpu_torch yet (ROADMAP A12); soak_serving is")


SOAKS = {"trainer": soak_trainer, "serving": soak_serving}
