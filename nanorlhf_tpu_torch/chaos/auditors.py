"""Run-invariant auditors (docs/RESILIENCE.md §chaos).

(the port's copy of `nanorlhf_tpu/chaos/auditors.py`.)

Each auditor checks one GLOBAL invariant of a finished run — properties
that must hold no matter which faults fired or how recovery interleaved
— from the lineage ledger plus end-of-run component snapshots the soak
runner collects into `ctx`. Auditors are tolerant by construction: an
invariant whose evidence is absent from this run (no fleet, no serving
engine, lineage disabled) passes with a "not exercised" detail rather
than failing on missing data, so one auditor set serves both paths.

Invariant names are the `chaos.*` strings in INVARIANTS; nanolint
cross-checks them against the docs/RESILIENCE.md invariant table in
both directions (analysis/registry.py), like the metric and fault-site
registries.

Jax-free — audits replay offline from a ledger directory alone
(`tools/inspect_run.py --chaos` re-prints journaled verdicts).
"""

from __future__ import annotations

import dataclasses

INVARIANTS = (
    "chaos.sample_conservation",
    "chaos.lease_epoch_monotonic",
    "chaos.counter_conservation",
    "chaos.kv_page_leak",
    "chaos.worker_leak",
    "chaos.degraded_honestly",
)


@dataclasses.dataclass
class AuditResult:
    """One auditor's verdict. `checked` counts the pieces of evidence
    examined — a pass with checked=0 means "not exercised", which the
    smoke test treats differently from a real pass."""

    name: str
    ok: bool
    detail: str = ""
    checked: int = 0


def _by_type(events, etype: str) -> list:
    return [e for e in events if e.get("type") == etype]


def audit_sample_conservation(events, ctx) -> AuditResult:
    """No consumed rollout index is lost or duplicated: every leased
    index reaches a generation or an attributed drop, consumed indices
    are duplicate-free (unless a sentinel rollback legitimately replays
    them), and the consumed range has no unattributed gaps."""
    name = "chaos.sample_conservation"
    outcomes = _by_type(events, "outcome")
    drops = _by_type(events, "drop")
    leases = _by_type(events, "lease")
    gens = _by_type(events, "generation")
    if not outcomes and not leases:
        return AuditResult(name, True, "no outcome/lease events", 0)
    consumed = [e["rollout_index"] for e in outcomes
                if e.get("rollout_index") is not None]
    dropped = {e["rollout_index"] for e in drops
               if e.get("rollout_index") is not None}
    problems = []
    rollbacks = int(ctx.get("rollbacks", 0) or 0)
    dup = sorted({i for i in consumed if consumed.count(i) > 1})
    if dup and not rollbacks:
        problems.append(f"duplicated consumed indices {dup[:8]}")
    leased = {e["rollout_index"] for e in leases
              if e.get("rollout_index") is not None}
    generated = {e["rollout_index"] for e in gens
                 if e.get("rollout_index") is not None}
    lost = sorted(leased - generated - dropped - set(consumed))
    if lost:
        problems.append(f"leased but never generated/dropped {lost[:8]}")
    if consumed:
        lo, hi = min(consumed), max(consumed)
        gaps = sorted(set(range(lo, hi + 1)) - set(consumed) - dropped)
        if gaps:
            problems.append(f"unattributed gaps {gaps[:8]}")
    checked = len(outcomes) + len(leases)
    return AuditResult(name, not problems, "; ".join(problems), checked)


def audit_lease_epoch_monotonic(events, ctx) -> AuditResult:
    """Lease epochs never move backward in ledger order (grants are
    serialized under the fleet lock), equal epochs belong to one lease,
    and every fenced late-duplicate drop carries an epoch BELOW some
    later grant — the fencing story the ledger tells must be coherent."""
    name = "chaos.lease_epoch_monotonic"
    leases = [e for e in _by_type(events, "lease")
              if e.get("epoch") is not None]
    if not leases:
        return AuditResult(name, True, "no lease events", 0)
    problems = []
    prev_epoch, prev_lease = None, None
    max_epoch = 0
    for e in leases:
        epoch, lease_id = int(e["epoch"]), e.get("lease_id")
        if prev_epoch is not None:
            if epoch < prev_epoch:
                problems.append(
                    f"epoch regressed {prev_epoch}->{epoch} "
                    f"(lease {lease_id})")
            elif epoch == prev_epoch and lease_id != prev_lease:
                problems.append(
                    f"epoch {epoch} reused across leases "
                    f"{prev_lease}/{lease_id}")
        prev_epoch, prev_lease = epoch, lease_id
        max_epoch = max(max_epoch, epoch)
    for e in _by_type(events, "drop"):
        if e.get("reason") != "fleet_late_duplicate":
            continue
        if not e.get("fenced"):
            problems.append(
                f"late-duplicate drop without fencing evidence "
                f"(index {e.get('rollout_index')})")
        elif e.get("epoch") is not None and int(e["epoch"]) >= max_epoch:
            problems.append(
                f"fenced drop epoch {e['epoch']} not below any later "
                f"grant (max {max_epoch})")
    return AuditResult(name, not problems, "; ".join(problems[:6]),
                       len(leases))


def audit_counter_conservation(events, ctx) -> AuditResult:
    """Every request/sample is accounted exactly once at quiescence:
    serving requests == admitted + shed with admitted == completed +
    cancelled (and nothing pending/active), loadgen offered ==
    completed + shed + errors, and the client/server tallies of the
    same run agree."""
    name = "chaos.counter_conservation"
    problems = []
    checked = 0
    eng = ctx.get("engine")
    if eng:
        checked += 1
        c = eng.get("counters", {})
        if c.get("requests", 0) != c.get("admitted", 0) + c.get("shed", 0):
            problems.append(
                f"requests {c.get('requests')} != admitted "
                f"{c.get('admitted')} + shed {c.get('shed')}")
        if c.get("admitted", 0) != (c.get("completed", 0)
                                    + c.get("cancelled", 0)):
            problems.append(
                f"admitted {c.get('admitted')} != completed "
                f"{c.get('completed')} + cancelled {c.get('cancelled')}")
        if eng.get("pending", 0) or eng.get("active", 0):
            problems.append(
                f"not quiescent: pending={eng.get('pending')} "
                f"active={eng.get('active')}")
    gen = ctx.get("loadgen")
    if gen:
        checked += 1
        offered = gen.get("loadgen/offered", 0)
        parts = (gen.get("loadgen/completed", 0) + gen.get("loadgen/shed", 0)
                 + gen.get("loadgen/errors", 0))
        if offered != parts:
            problems.append(f"offered {offered} != completed+shed+errors "
                            f"{parts}")
        if eng:
            c = eng.get("counters", {})
            if offered != c.get("requests", 0):
                problems.append(
                    f"client offered {offered} != server requests "
                    f"{c.get('requests')}")
    traffic = _by_type(events, "traffic")
    if traffic and gen:
        checked += 1
        if len(traffic) != gen.get("loadgen/offered", 0):
            problems.append(
                f"{len(traffic)} traffic events != offered "
                f"{gen.get('loadgen/offered')}")
    if not checked:
        return AuditResult(name, True, "no counter surfaces in ctx", 0)
    return AuditResult(name, not problems, "; ".join(problems), checked)


def audit_kv_page_leak(events, ctx) -> AuditResult:
    """At quiescence every KV page is either free or owned by the radix
    tree alone: free + cached == num_pages, no page multi-referenced,
    and no row's block table still holds page ids — a vanished client
    or crashed worker must not strand a page."""
    name = "chaos.kv_page_leak"
    snap = ctx.get("radix")
    if not snap:
        return AuditResult(name, True, "no radix snapshot", 0)
    problems = []
    total = snap.get("num_pages", 0)
    free, cached = snap.get("free_pages", 0), snap.get("cached_pages", 0)
    if free + cached != total:
        problems.append(
            f"{total - free - cached} pages stranded "
            f"(free {free} + cached {cached} != {total})")
    if snap.get("shared_pages", 0):
        problems.append(f"{snap['shared_pages']} pages still shared")
    live_rows = ctx.get("live_table_rows")
    if live_rows:
        problems.append(f"rows still holding pages: {live_rows}")
    return AuditResult(name, not problems, "; ".join(problems), 1)


def audit_worker_leak(events, ctx) -> AuditResult:
    """Component teardown leaves no threads or child processes behind:
    the runner diffs thread names / child-process counts across the run
    (after close), filtered to this project's thread-name prefixes."""
    name = "chaos.worker_leak"
    leaked = ctx.get("leaked_threads")
    procs = int(ctx.get("leaked_procs", 0) or 0)
    if leaked is None and not procs:
        return AuditResult(name, True, "no leak snapshot", 0)
    problems = []
    if leaked:
        problems.append(f"threads still alive: {sorted(leaked)[:8]}")
    if procs > 0:
        problems.append(f"{procs} child processes still alive")
    return AuditResult(name, not problems, "; ".join(problems), 1)


def audit_degraded_honestly(events, ctx) -> AuditResult:
    """Any non-bit-exact recovery must be journaled, never silent: for
    every (signal, journaled) pair the runner collects — watchdog
    degraded mode, checkpoint fallbacks, cancelled streams, sentinel
    rollbacks — a truthy signal requires truthy journal evidence (a
    metric row, counter, or ledger event recording the transition)."""
    name = "chaos.degraded_honestly"
    pairs = ctx.get("honesty") or []
    if not pairs:
        return AuditResult(name, True, "no degradation signals", 0)
    problems = []
    for label, signal, journaled in pairs:
        if signal and not journaled:
            problems.append(f"{label}: degraded ({signal!r}) but not "
                            f"journaled")
    return AuditResult(name, not problems, "; ".join(problems), len(pairs))


AUDITORS = {
    "chaos.sample_conservation": audit_sample_conservation,
    "chaos.lease_epoch_monotonic": audit_lease_epoch_monotonic,
    "chaos.counter_conservation": audit_counter_conservation,
    "chaos.kv_page_leak": audit_kv_page_leak,
    "chaos.worker_leak": audit_worker_leak,
    "chaos.degraded_honestly": audit_degraded_honestly,
}


def run_audits(events, ctx) -> list:
    """Run every auditor over one finished run; never raises — an
    auditor crash is itself a failed verdict (the harness must report,
    not mask)."""
    results = []
    for invariant in INVARIANTS:
        fn = AUDITORS[invariant]
        try:
            results.append(fn(events, ctx))
        except Exception as e:
            results.append(AuditResult(
                invariant, False, f"auditor crashed: "
                f"{type(e).__name__}: {e}", 0))
    return results
