"""Chaos soak CLI — the port of `nanorlhf_tpu/chaos/__main__.py`.

    python -m nanorlhf_tpu_torch.chaos --path serving --seed 3
    python -m nanorlhf_tpu_torch.chaos --path serving --seed 3 --shrink
    python -m nanorlhf_tpu_torch.chaos --path serving --seed 3 \\
        --spec "gw.disconnect:every=2,count=2" [--run-dir DIR] [--device cpu]

Composes a seeded schedule (or takes an explicit --spec, as printed by
a failed soak's repro line), drives the soak on the card (`--device cpu`
on the CPU), prints every auditor verdict, and exits nonzero when any
invariant fails. With --shrink a failing spec is ddmin-minimized first —
each probe re-runs the soak in its own subdirectory — and the minimal
repro command is printed last. The soak runs in `--run-dir`, which must
hold no ledger yet, or by default in a fresh directory under the
temporary directory (`TMPDIR`), printed first. `--path trainer` raises
NotImplementedError: its soak needs the rollout fleet (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import tempfile

from nanorlhf_tpu_torch.chaos.composer import PATHS, ChaosPlan, compose
from nanorlhf_tpu_torch.chaos.runner import SOAKS
from nanorlhf_tpu_torch.chaos.shrink import repro_command, shrink


def _print_report(report) -> None:
    print(f"chaos: path={report.plan.path} seed={report.plan.seed} "
          f"digest={report.plan.digest}")
    print(f"chaos: spec: {report.plan.spec or '(empty)'}")
    for point, s in sorted(report.fault_stats.items()):
        print(f"chaos: site {point}: {s['fires']}/{s['calls']} "
              f"fires/calls")
    for a in report.audits:
        mark = "ok " if a.ok else "FAIL"
        extra = f" — {a.detail}" if a.detail else ""
        print(f"chaos: [{mark}] {a.name} (checked={a.checked}){extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nanorlhf_tpu_torch.chaos",
        description="composed-fault soak + run-invariant audit")
    ap.add_argument("--path", choices=sorted(PATHS), required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sites", type=int, default=3,
                    help="clauses to compose (ignored with --spec)")
    ap.add_argument("--spec", default=None,
                    help="explicit NANORLHF_FAULT spec instead of "
                         "composing one (repro replay)")
    ap.add_argument("--run-dir", default=None,
                    help="where the soak writes its ledger (must hold none "
                         "yet); default: a fresh directory under TMPDIR")
    ap.add_argument("--shrink", action="store_true",
                    help="on audit failure, ddmin the spec to a minimal "
                         "failing clause set (re-runs the soak per probe)")
    ap.add_argument("--max-tests", type=int, default=16,
                    help="shrink probe budget")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.spec is not None:
        plan = ChaosPlan(seed=args.seed, path=args.path,
                         clauses=tuple(args.spec.split()))
    else:
        plan = compose(args.seed, args.path, n_sites=args.sites)
    if args.run_dir is None:
        args.run_dir = tempfile.mkdtemp(prefix="chaos_soak_")
    print(f"chaos: run dir {args.run_dir}")
    soak = SOAKS[args.path]
    if args.path == "serving":
        soak = functools.partial(soak, device=args.device)
    report = soak(args.run_dir, plan)
    _print_report(report)
    if report.ok:
        print("chaos: PASS")
        return 0

    print("chaos: FAIL — "
          + ", ".join(a.name for a in report.failed))
    if args.shrink and len(plan.clauses) > 1:
        probe = [0]

        def failing(clauses) -> bool:
            probe[0] += 1
            sub = dataclasses.replace(plan, clauses=tuple(clauses))
            rep = soak(f"{args.run_dir}/shrink_{probe[0]:02d}", sub)
            return not rep.ok

        minimal = shrink(plan.clauses, failing, max_tests=args.max_tests)
        print(f"chaos: minimal failing spec ({len(minimal)} of "
              f"{len(plan.clauses)} clauses): {' '.join(minimal)}")
        print("chaos: repro: "
              + repro_command(minimal, path=plan.path, seed=plan.seed))
    else:
        print("chaos: repro: "
              + repro_command(plan.clauses, path=plan.path,
                              seed=plan.seed))
    return 1


if __name__ == "__main__":
    sys.exit(main())
