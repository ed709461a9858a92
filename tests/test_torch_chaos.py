"""The port's chaos soak harness (`nanorlhf_tpu_torch/chaos`) against the
JAX package's (`nanorlhf_tpu/chaos`): each test of `tests/test_chaos.py`
that has a port counterpart, and the copies held against their originals —
the composer's plans (the pinned seed-3 plans, and every (seed, path) of a
sweep, equal to JAX's), `shrink` (the same probes and the same result), the
auditors (the same verdicts on the same events and snapshots). The serving
soak runs the port's `ServingEngine` on the CPU here (the card in
`chip_smoke.py` phase 16); the trainer soak needs the rollout fleet, which
is not ported, and raises."""

import json
import subprocess
import sys
import time

import pytest

from nanorlhf_tpu.chaos import auditors as jax_auditors
from nanorlhf_tpu.chaos import compose as jax_compose
from nanorlhf_tpu.chaos import shrink as jax_shrink
from nanorlhf_tpu.chaos.composer import EXCLUDED as JAX_EXCLUDED
from nanorlhf_tpu.chaos.composer import _clause as jax_clause
from nanorlhf_tpu_torch.chaos import (
    INVARIANTS,
    SERVING_SITES,
    TRAINER_SITES,
    ChaosPlan,
    compose,
    repro_command,
    shrink,
    soak_serving,
    soak_trainer,
    uncovered_sites,
)
from nanorlhf_tpu_torch.chaos import auditors
from nanorlhf_tpu_torch.chaos.composer import EXCLUDED, _clause, fold_in
from nanorlhf_tpu_torch.resilience.faults import parse_fault_spec

# --------------------------------------------------------------------- #
# composer: determinism, registry completeness, clause templates
# --------------------------------------------------------------------- #


def test_fault_site_registry_fully_partitioned():
    """Every registered injection point is in a path pool or in EXCLUDED
    with a reason — the same partition as JAX's."""
    assert uncovered_sites() == set()
    pooled = set(TRAINER_SITES) | set(SERVING_SITES)
    assert pooled.isdisjoint(EXCLUDED)
    assert all(reason for reason in EXCLUDED.values())
    assert EXCLUDED == JAX_EXCLUDED


def test_compose_is_deterministic_and_valid():
    p1 = compose(3, "trainer")
    p2 = compose(3, "trainer")
    assert p1 == p2                       # value-typed replay contract
    assert p1.digest == p2.digest
    assert p1.digest != compose(4, "trainer").digest
    assert set(p1.sites) <= set(TRAINER_SITES)
    assert len(parse_fault_spec(p1.spec)) == len(p1.clauses) == 3


def test_seed3_plans_are_pinned():
    """The exact seed-3 schedules — JAX's pins, byte for byte."""
    srv = compose(3, "serving")
    assert srv.spec == ("gw.disconnect:every=2,count=2 "
                        "gw.disconnect:every=5,count=3 "
                        "gw.disconnect:every=4,count=2")
    assert srv.digest == "90648a33dc151c44"
    trn = compose(3, "trainer")
    assert trn.spec == ("worker.crash:at=1,worker=1 "
                        "worker.slow:every=4,delay=0.058,count=3 "
                        "ckpt.save:at=1")
    assert trn.digest == "d2ba59a8651f601f"


@pytest.mark.parametrize("path", ["serving", "trainer"])
def test_plans_equal_jax_over_a_seed_sweep(path):
    for seed in range(24):
        for n_sites in (1, 3, 5):
            got = compose(seed, path, n_sites=n_sites)
            want = jax_compose(seed, path, n_sites=n_sites)
            assert (got.spec, got.digest, got.key_path) == (want.spec, want.digest,
                                                            want.key_path)


def test_compose_serving_pool_wraps():
    plan = compose(3, "serving", n_sites=3)
    assert plan.sites == ("gw.disconnect",) * 3
    assert len(set(plan.clauses)) == 3    # per-slot keys diverge


def test_compose_rejects_bad_args():
    with pytest.raises(ValueError, match="path"):
        compose(0, "nosuch")
    with pytest.raises(ValueError, match="n_sites"):
        compose(0, "serving", n_sites=0)


def test_crash_clause_never_masks_surviving_sites():
    assert _clause("worker.crash", fold_in(0, 0), 2) == "worker.crash:at=1,worker=1"
    slow = _clause("worker.slow", fold_in(0, 1), 2)
    assert "worker=" not in slow
    assert _clause("worker.fetch_weights", fold_in(0, 2), 2).endswith(",worker=0")
    for i, site in enumerate(TRAINER_SITES + SERVING_SITES):
        assert _clause(site, fold_in(5, i), 2) == jax_clause(site, fold_in(5, i), 2)


# --------------------------------------------------------------------- #
# ddmin shrinker (pure, no soak)
# --------------------------------------------------------------------- #


def _same_as_jax(clauses, failing, **kw):
    """The port's shrink, its probe sequence and result held equal to
    JAX's on the same predicate."""
    probes, jprobes = [], []
    got = shrink(clauses, lambda s: probes.append(list(s)) or failing(s), **kw)
    want = jax_shrink(clauses, lambda s: jprobes.append(list(s)) or failing(s), **kw)
    assert (got, probes) == (want, jprobes)
    return got


def test_shrink_finds_1_minimal_pair():
    def failing(subset):
        return {"a", "c"} <= set(subset)

    minimal = _same_as_jax(["a", "b", "c", "d"], failing)
    assert set(minimal) == {"a", "c"}
    assert len(minimal) == 2
    assert not failing(["a"]) and not failing(["c"])


def test_shrink_single_culprit_and_order_preserved():
    assert _same_as_jax(["w", "x", "y", "z"], lambda s: "y" in s) == ["y"]
    assert _same_as_jax(["a", "b", "c"], lambda s: {"a", "c"} <= set(s)) == ["a", "c"]


def test_shrink_rejects_passing_input():
    with pytest.raises(ValueError, match="False on the full clause"):
        shrink(["a", "b"], lambda s: False)


def test_shrink_budget_returns_best_so_far_failing():
    tests = [0]

    def failing(subset):
        tests[0] += 1
        return {"a", "e"} <= set(subset)

    minimal = shrink(list("abcdef"), failing, max_tests=3)
    assert {"a", "e"} <= set(minimal)     # still reproduces
    assert tests[0] <= 4                  # entry check + probe budget
    assert _same_as_jax(list("abcdef"), lambda s: {"a", "e"} <= set(s),
                        max_tests=3) == minimal


def test_repro_command_is_the_cli_one_liner():
    cmd = repro_command(["gw.disconnect:every=2,count=2"], path="serving",
                        seed=7, run_dir="/tmp/r")
    assert cmd == ('python -m nanorlhf_tpu_torch.chaos --path serving --seed 7 '
                   '--spec "gw.disconnect:every=2,count=2" --run-dir /tmp/r')
    # by default the command names no run dir: the CLI then soaks in a
    # fresh one, and a replay never audits an earlier run's events
    assert repro_command(["gw.disconnect:every=2,count=2"], path="serving",
                         seed=7) == cmd.rsplit(" --run-dir", 1)[0]


# --------------------------------------------------------------------- #
# the auditors: the copy's verdicts equal the original's
# --------------------------------------------------------------------- #


def test_auditors_match_jax_on_the_same_run(tmp_path):
    """A soak's events and snapshots, audited by both packages' auditors,
    and a doctored snapshot (a stranded page, a leaked thread, a dishonest
    counter) that both must fail the same way."""
    from nanorlhf_tpu_torch.telemetry.lineage import read_ledger

    rep = soak_serving(str(tmp_path / "run"), compose(3, "serving"), device="cpu",
                       n_requests=8)
    events = list(read_ledger(str(tmp_path / "run")))
    ctx = {"live_table_rows": [], "leaked_threads": [], "leaked_procs": 0,
           "honesty": [("serving_cancelled", 1, 1)],
           "radix": {"num_pages": 8, "free_pages": 6, "cached_pages": 2,
                     "shared_pages": 0}}
    bad = dict(ctx, live_table_rows=[0], leaked_threads=["serving-engine"],
               honesty=[("serving_cancelled", 2, 1)],
               radix={"num_pages": 8, "free_pages": 5, "cached_pages": 2,
                      "shared_pages": 1})
    for c in (ctx, bad):
        got = [(a.name, a.ok, a.checked, a.detail) for a in auditors.run_audits(events, c)]
        want = [(a.name, a.ok, a.checked, a.detail)
                for a in jax_auditors.run_audits(events, c)]
        assert got == want
    assert rep.ok and auditors.INVARIANTS == jax_auditors.INVARIANTS
    assert not all(ok for _, ok, _, _ in got)


# --------------------------------------------------------------------- #
# the soaks
# --------------------------------------------------------------------- #


def test_serving_soak_green_and_inspectable(tmp_path):
    """Seed-3 three-clause serving soak on the port's engine: faults fire,
    every auditor passes, the ledger carries the full chaos provenance, and
    the offline inspector rebuilds timeline + verdicts from it."""
    from nanorlhf_tpu_torch.telemetry.lineage import read_ledger

    run_dir = str(tmp_path / "run")
    plan = compose(3, "serving")
    rep = soak_serving(run_dir, plan, device="cpu")
    assert rep.ok, rep.failed
    assert {a.name for a in rep.audits} == set(INVARIANTS)
    assert rep.fired_sites() == {"gw.disconnect"}
    assert rep.fault_stats["gw.disconnect"]["fires"] >= 1
    assert rep.summary["offered"] == 24
    assert rep.summary["errors"] >= 1
    assert (rep.summary["completed"] + rep.summary["errors"]
            + rep.summary["shed"] == rep.summary["offered"])

    events = list(read_ledger(run_dir))
    kinds = {e.get("type") for e in events}
    assert {"chaos_run", "fault", "chaos_audit"} <= kinds
    fires = sum(s["fires"] for s in rep.fault_stats.values())
    assert sum(1 for e in events if e.get("type") == "fault") == fires

    out = subprocess.run(
        [sys.executable, "tools/inspect_run.py", run_dir, "--chaos", "--json"],
        capture_output=True, text=True, check=True)
    rebuilt = json.loads(out.stdout)
    assert rebuilt["ok"] is True
    assert rebuilt["runs"][0]["spec"] == plan.spec
    assert rebuilt["runs"][0]["spec_digest"] == plan.digest
    assert len(rebuilt["fires"]) == fires
    assert {a["name"] for a in rebuilt["audits"]} == set(INVARIANTS)
    assert all(a["ok"] for a in rebuilt["audits"])


def test_trainer_soak_green(tmp_path):
    """The trainer soak drives the rollout fleet (two workers under the
    orchestrator), which the port has not got: it refuses, naming A12,
    instead of passing vacuously."""
    with pytest.raises(NotImplementedError, match="A12"):
        soak_trainer(str(tmp_path / "run"), compose(3, "trainer"))


def test_injected_violation_caught_and_shrunk(tmp_path, monkeypatch):
    """Sabotage the engine's cancel-reap path so abandoned KV pages are
    never released: the kv_page_leak auditor must catch it, ddmin must
    shrink the 3-clause schedule to a ≤2-clause minimal repro, and the
    printed one-liner must replay that minimal spec."""
    from nanorlhf_tpu_torch.sampler.paged.session import DecodeSession
    from nanorlhf_tpu_torch.serving.engine import ServingEngine

    orig_reap = ServingEngine._reap_cancelled
    orig_step = DecodeSession.step

    def slow_step(self):
        # a beat long enough that a vanished client's cancel lands while
        # its row still decodes, however loaded the host: the leak (and so
        # every replay of the minimal spec) does not hang on thread timing
        time.sleep(0.02)
        return orig_step(self)

    def leaky_reap(self, *a, **kw):
        saved = self._radix.release
        self._radix.release = lambda pages: 0      # strand the pages
        try:
            return orig_reap(self, *a, **kw)
        finally:
            self._radix.release = saved

    monkeypatch.setattr(ServingEngine, "_reap_cancelled", leaky_reap)
    monkeypatch.setattr(DecodeSession, "step", slow_step)

    plan = compose(3, "serving")
    rep = soak_serving(str(tmp_path / "full"), plan, device="cpu")
    assert not rep.ok
    assert [a.name for a in rep.failed] == ["chaos.kv_page_leak"]
    assert "stranded" in rep.failed[0].detail

    probe = [0]

    def failing(clauses):
        probe[0] += 1
        sub = ChaosPlan(seed=plan.seed, path=plan.path, clauses=tuple(clauses))
        r = soak_serving(str(tmp_path / f"shrink_{probe[0]:02d}"), sub,
                         n_requests=12, device="cpu")
        return any(a.name == "chaos.kv_page_leak" for a in r.failed)

    minimal = shrink(plan.clauses, failing, max_tests=8)
    assert 1 <= len(minimal) <= 2
    assert set(minimal) <= set(plan.clauses)
    assert failing(minimal)
    cmd = repro_command(minimal, path=plan.path, seed=plan.seed)
    assert f'--spec "{" ".join(minimal)}"' in cmd
    assert "--path serving" in cmd


def test_chaos_cli_repro_replay(tmp_path):
    """The printed repro one-liner runs: an explicit --spec replay through
    `python -m nanorlhf_tpu_torch.chaos` exits 0 on PASS and prints every
    verdict (`--device cpu` here)."""
    out = subprocess.run(
        [sys.executable, "-m", "nanorlhf_tpu_torch.chaos", "--path", "serving",
         "--seed", "3", "--spec", "gw.disconnect:every=3,count=2",
         "--run-dir", str(tmp_path / "replay"), "--device", "cpu"],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "chaos: PASS" in out.stdout
    for name in INVARIANTS:
        assert name in out.stdout


def test_soak_refuses_a_run_dir_that_holds_a_ledger(tmp_path):
    """A second soak into one run dir would append to the first's ledger
    and audit both runs' events (the fault-journal honesty audit then
    compares this run's fires with both runs' fault events): it raises
    before anything runs."""
    (tmp_path / "lineage").mkdir()
    (tmp_path / "lineage" / "ledger_00000.jsonl").write_text("")
    with pytest.raises(FileExistsError, match="fresh"):
        soak_serving(str(tmp_path), compose(3, "serving"), device="cpu")


def test_chaos_cli_soaks_in_a_fresh_dir_under_tmpdir(tmp_path, monkeypatch, capsys):
    """Without --run-dir the CLI soaks in a directory of its own under the
    temporary directory (TMPDIR), a new one each run: two replays of one
    spec both pass, each auditing only its own events."""
    import tempfile

    from nanorlhf_tpu_torch.chaos.__main__ import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--path", "serving", "--seed", "3", "--spec", "gw.disconnect:every=3,count=2",
            "--device", "cpu"]
    dirs = []
    for _ in range(2):
        assert main(argv) == 0
        out = capsys.readouterr().out
        assert "chaos: PASS" in out
        dirs.append(out.split("chaos: run dir ", 1)[1].split("\n", 1)[0])
    assert dirs[0] != dirs[1]
    assert all(d.startswith(str(tmp_path)) for d in dirs)
