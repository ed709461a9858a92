"""Seeded chaos schedule composer (docs/RESILIENCE.md §chaos).

(the port's copy of `nanorlhf_tpu/chaos/composer.py`.)

Samples multi-site, multi-clause `NANORLHF_FAULT` specs from the wired
fault-site registry (`resilience.faults.INJECTION_POINTS`) under the
same splitmix64 key-derivation discipline the loadgen workload sampler
uses: every clause and every field draw consumes its own `fold_in`-
derived key, so the same seed composes the same chaos byte-for-byte in
any process — the ledger's `chaos_run` header (seed + spec + KEY_PATH)
is a complete replay recipe.

Per-path site pools. A composed soak must PASS its auditors, so each
pool admits only bounded, recoverable perturbations on that path;
every other registered site is listed in EXCLUDED with the reason —
`uncovered_sites()` returns the registry diff and a test pins it empty,
so adding a fault site forces a composer decision.

Jax-free: the composer (like the auditors and shrinker) must run
anywhere the ledger can be read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from nanorlhf_tpu_torch.loadgen.workload import fold_in, randint, uniform
from nanorlhf_tpu_torch.resilience.faults import INJECTION_POINTS, parse_fault_spec

# root stream id: clause keys are fold_in(fold_in(seed, _ROOT), slot),
# field draws fold one more level (slot is the clause's position in the
# composed spec, not the site name — two clauses on one site diverge)
_ROOT = 0xC4A0

KEY_PATH = "fold_in(fold_in(seed, 0xC4A0), clause_slot)"

# field ids folded under a clause key — one per sampled parameter, so
# adding a parameter never shifts its siblings' draws
_F_SITE, _F_AT, _F_EVERY, _F_COUNT, _F_WORKER, _F_DELAY = range(6)

# trainer+fleet path: orchestrated run with rollout workers. Each entry
# is a bounded perturbation the resilience stack recovers from without
# exhausting a budget (crash→lease reassignment, slow→straggler
# redispatch, save/produce/reward→retry paths).
#
# ORDER MATTERS: site selection is a keyed shuffle over this tuple, so
# reordering or inserting entries reshuffles every composed plan. The
# current order keeps the pinned seed-3 plan (test_seed3_plans_are_
# pinned) drawing {worker.crash, worker.slow, ckpt.save} — the
# deterministic crash-recovery soak — while swap.stale stays reachable
# under other seeds. swap.stale only fires on a run with
# rollout_inflight_swaps enabled (a mid-rollout install stalls briefly,
# then installs anyway), so a soak that composes it without swaps
# enabled records zero fires for that clause.
TRAINER_SITES = (
    "ckpt.save",
    "rollout.produce",
    "reward.exec",
    "worker.slow",
    "swap.stale",
    "worker.fetch_weights",
    "worker.crash",
)

# loadgen→engine serving path: the only wired serving-side site today
# (clients vanishing mid-stream); multi-clause specs still compose —
# several disconnect waves with distinct phases/counts.
SERVING_SITES = ("gw.disconnect",)

# registry entries deliberately absent from both pools, with the reason
# — uncovered_sites() keeps this enumeration honest against the
# registry, so a new INJECTION_POINTS entry fails tests until it is
# pooled or excluded here
EXCLUDED = {
    "ckpt.restore": "restore-path only — a fresh soak never resumes",
    "ckpt.corrupt": "restore-path only — exercised by its own tier-1 test",
    "update.step": "nan rollback needs a committed checkpoint and replays "
                   "the step — doubles soak runtime; own tier-1 tests",
    "worker.hang": "stalls until the lease deadline — too slow for a "
                   "smoke soak",
    "net.drop": "rpc transport mode only",
    "net.delay": "rpc transport mode only",
    "net.partition": "rpc transport mode only",
    "net.duplicate": "rpc transport mode only",
    "net.tear": "rpc transport mode only",
    "env.hang": "multi-turn env episodes only",
    "env.crash": "multi-turn env episodes only",
}

PATHS = {"trainer": TRAINER_SITES, "serving": SERVING_SITES}


def uncovered_sites() -> set:
    """Registry entries neither pooled nor excluded (should be empty)."""
    covered = set(TRAINER_SITES) | set(SERVING_SITES) | set(EXCLUDED)
    return set(INJECTION_POINTS) - covered


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """One composed chaos schedule — value-typed so two compositions of
    the same (seed, path) compare == field for field (replay contract,
    like loadgen's GenRequest)."""

    seed: int
    path: str                 # "trainer" | "serving"
    clauses: tuple            # NANORLHF_FAULT entries, one per slot
    key_path: str = KEY_PATH

    @property
    def spec(self) -> str:
        return " ".join(self.clauses)

    @property
    def sites(self) -> tuple:
        return tuple(c.partition(":")[0] for c in self.clauses)

    @property
    def digest(self) -> str:
        return plan_digest(self)


def plan_digest(plan: ChaosPlan) -> str:
    """sha256[:16] pin over the plan's replay-relevant fields."""
    blob = json.dumps([plan.seed, plan.path, list(plan.clauses)],
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _clause(site: str, key: int, n_workers: int) -> str:
    """Sample one spec entry for `site` from the clause key. Parameter
    ranges keep every fire bounded (small delays, capped counts) so a
    composed soak stays a smoke test, not a stress test.

    Worker targeting is partitioned, not sampled: worker.crash is FATAL
    to its thread (the fleet reassigns the lease, it never respawns the
    worker), so crash always takes the LAST worker while the surviving
    sites stay untargeted or pinned to worker 0 — composed clauses must
    not mask each other by all landing on the corpse."""
    if site == "ckpt.save":
        return f"ckpt.save:at={randint(fold_in(key, _F_AT), 1, 3)}"
    if site == "rollout.produce":
        return f"rollout.produce:at={randint(fold_in(key, _F_AT), 1, 4)}"
    if site == "reward.exec":
        return f"reward.exec:at={randint(fold_in(key, _F_AT), 1, 3)}"
    if site == "worker.slow":
        every = randint(fold_in(key, _F_EVERY), 2, 5)
        delay = round(0.02 + 0.06 * uniform(fold_in(key, _F_DELAY)), 3)
        count = randint(fold_in(key, _F_COUNT), 1, 4)
        return f"worker.slow:every={every},delay={delay},count={count}"
    if site == "worker.crash":
        return f"worker.crash:at=1,worker={max(0, n_workers - 1)}"
    if site == "worker.fetch_weights":
        return (f"worker.fetch_weights:at="
                f"{randint(fold_in(key, _F_AT), 1, 3)},worker=0")
    if site == "swap.stale":
        # small stall before a mid-rollout install (the default delay
        # action installs the tree anyway — recoverable by construction)
        every = randint(fold_in(key, _F_EVERY), 1, 4)
        delay = round(0.02 + 0.06 * uniform(fold_in(key, _F_DELAY)), 3)
        count = randint(fold_in(key, _F_COUNT), 1, 3)
        return f"swap.stale:every={every},delay={delay},count={count}"
    if site == "gw.disconnect":
        every = randint(fold_in(key, _F_EVERY), 2, 6)
        count = randint(fold_in(key, _F_COUNT), 1, 4)
        return f"gw.disconnect:every={every},count={count}"
    raise ValueError(f"no clause template for site {site!r}")


def compose(seed: int, path: str, *, n_sites: int = 3,
            n_workers: int = 2) -> ChaosPlan:
    """Compose an `n_sites`-clause schedule for `path` from `seed`.

    Site selection is a keyed Fisher-Yates over the path's pool (every
    site reachable, no duplicates until the pool is exhausted — pools
    smaller than n_sites wrap with fresh clause keys, so a 3-clause
    serving plan is three distinct disconnect waves). The result
    round-trips through `parse_fault_spec`, so it is a valid
    NANORLHF_FAULT value by construction."""
    if path not in PATHS:
        raise ValueError(f"path {path!r}: expected one of {sorted(PATHS)}")
    if n_sites < 1:
        raise ValueError(f"n_sites={n_sites} must be >= 1")
    pool = list(PATHS[path])
    root = fold_in(seed, _ROOT)
    # keyed shuffle: deterministic site order for this seed
    for i in range(len(pool) - 1, 0, -1):
        j = randint(fold_in(fold_in(root, _F_SITE), i), 0, i + 1)
        pool[i], pool[j] = pool[j], pool[i]
    clauses = []
    for slot in range(n_sites):
        site = pool[slot % len(pool)]
        clauses.append(_clause(site, fold_in(root, slot), n_workers))
    plan = ChaosPlan(seed=int(seed), path=path, clauses=tuple(clauses))
    parse_fault_spec(plan.spec)  # valid by construction — or fail loudly
    return plan
