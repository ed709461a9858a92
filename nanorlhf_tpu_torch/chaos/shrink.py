"""Delta-debugging shrinker (docs/RESILIENCE.md §chaos).

(the port's copy of `nanorlhf_tpu/chaos/shrink.py`; `repro_command`
names the port's CLI and, by default, no run dir.)

When a composed chaos spec breaks an auditor, most of its clauses are
usually bystanders. `shrink` runs classic ddmin (Zeller & Hildebrandt,
"Simplifying and Isolating Failure-Inducing Input") over the CLAUSE
list: partition the failing set into n chunks, try each chunk and each
complement, recurse on whichever still fails with finer granularity,
and stop at a 1-minimal set — removing any single remaining clause
makes the failure disappear. `repro_command` turns the survivor into
the one-liner a bug report needs.

The predicate re-runs the soak, so shrinking is expensive by nature;
`max_tests` bounds the spend and the best-so-far subset is returned
even when the budget runs out. Deterministic composition (composer.py)
is what makes the re-runs meaningful at all: the subset replays the
exact surviving schedules, not a fresh sampling.
"""

from __future__ import annotations

from typing import Callable, Sequence


def shrink(clauses: Sequence[str], failing: Callable[[list], bool],
           *, max_tests: int = 64) -> list:
    """Minimize `clauses` to a 1-minimal subset for which `failing`
    (clause list -> True when the failure REPRODUCES) still holds.
    `failing(list(clauses))` must be True on entry — shrinking a
    passing spec is a caller bug worth failing loudly on."""
    current = list(clauses)
    if not failing(current):
        raise ValueError("failing() is False on the full clause list — "
                         "nothing to shrink")
    tests = 1
    n = 2
    while len(current) >= 2 and tests < max_tests:
        chunk = max(1, -(-len(current) // n))  # ceil division
        subsets = [current[i:i + chunk]
                   for i in range(0, len(current), chunk)]
        reduced = False
        # a failing chunk becomes the new set at coarsest granularity;
        # a failing complement keeps granularity (one chunk proved
        # irrelevant) — the standard ddmin schedule
        for s in subsets:
            if len(s) == len(current):
                continue
            tests += 1
            if failing(list(s)):
                current, n, reduced = list(s), 2, True
                break
            if tests >= max_tests:
                return current
        if not reduced and len(subsets) > 1:
            for s in subsets:
                comp = [c for c in current if c not in s]
                if not comp or len(comp) == len(current):
                    continue
                tests += 1
                if failing(list(comp)):
                    current, n, reduced = comp, max(n - 1, 2), True
                    break
                if tests >= max_tests:
                    return current
        if not reduced:
            if n >= len(current):
                break  # 1-minimal: no chunk or complement still fails
            n = min(len(current), n * 2)
    return current


def repro_command(clauses: Sequence[str], *, path: str, seed: int,
                  run_dir: str | None = None) -> str:
    """The one-line repro a failed soak prints: re-runs the minimal
    clause set through the same soak path via the chaos CLI. Without
    `run_dir` the command names none, and the CLI soaks in a fresh
    directory of its own (a soak audits every event in its run dir)."""
    spec = " ".join(clauses)
    cmd = (f'python -m nanorlhf_tpu_torch.chaos --path {path} --seed {seed} '
           f'--spec "{spec}"')
    return cmd if run_dir is None else f"{cmd} --run-dir {run_dir}"
