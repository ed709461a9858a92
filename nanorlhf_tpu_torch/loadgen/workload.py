"""Deterministic open-loop workload specs (docs/TRAFFIC.md §1-2).

(the port's copy of `nanorlhf_tpu/loadgen/workload.py`;
`tests/test_torch_loadgen.py` holds its digests against the original.)

A `WorkloadSpec` + a seed IS the traffic: `sample_requests(spec)` expands
it into a fully materialized request sequence — arrival offsets, prompt
tokens, per-request sampling params, token budgets — with ZERO wall-clock
reads and zero global RNG state, so the same spec replays the bit-
identical sequence on any host (the acceptance pin in
tests/test_loadgen.py). This is what makes offered load a *spec property*
rather than a measurement: the driver (driver.py) fires the sequence
open-loop and never applies back-pressure, so saturation and shedding
become observable instead of being absorbed by a closing loop.

PRNG discipline mirrors the project's lineage convention
(docs/OBSERVABILITY.md §6): every request's entropy derives from
``fold_in(fold_in(seed, _ROOT), request_index)`` and per-field
sub-streams fold a named constant into the request key — no key is ever
consumed twice, and the derivation path is recorded (`KEY_PATH`) so a
ledger reader can re-derive any request from the seed alone. The
generator is jax-free on purpose (splitmix64, Vigna 2015): the traffic
harness must run in the same jax-less contexts as the telemetry readers
(tools/inspect_run.py, CPU CI collection), and a 64-bit mix gives the
replay guarantee without importing an accelerator runtime.

Arrival processes:

- ``"poisson"``: memoryless inter-arrivals at `rate_rps` — the classic
  open-system model (the serving-comparison framing of
  arxiv 2605.25645's offered-load sweeps).
- ``"bursty"``: a 2-state Markov-modulated Poisson process. The chain
  alternates calm/burst states with exponential holding times; the burst
  state multiplies the calm rate by `burst_factor`, and `burst_frac`
  fixes the stationary fraction of time spent bursting, so the MEAN rate
  stays exactly `rate_rps` — curves at the same offered load are
  comparable across arrival shapes. Sampling is exact (memorylessness
  lets an inter-arrival that crosses a state boundary restart at the
  boundary under the new rate, with a fresh sub-key per attempt).

Prefix overlap: `prefix_groups` tenants each own a fixed shared prefix
(`prefix_len` real tokens, derived from the seed); a request joins a
group with probability `prefix_frac` and prepends that group's prefix to
its unique suffix. This exercises the radix prefix cache
(serving/radix.py) the way multi-tenant traffic does — repeat admissions
within a group install refcount-shared pages instead of prefilling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

_MASK64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15  # splitmix64 weyl increment

# root stream id: request keys are fold_in(fold_in(seed, _ROOT), index)
_ROOT = 0x7F1C
# per-request sub-streams (folded into the request key)
_SUB_ARRIVAL, _SUB_LEN, _SUB_TOKENS, _SUB_PARAMS, _SUB_PREFIX = 1, 2, 3, 4, 5
# spec-level streams (folded into the root key)
_STREAM_STATE = 0x51A7E   # bursty-chain holding times
_STREAM_GROUPS = 0x6709   # shared-prefix token material

#: the documented derivation path for request `i`'s key — recorded in the
#: driver's `traffic_run` lineage event so a ledger reader can re-derive
#: the full sequence from the seed alone
KEY_PATH = "fold_in(fold_in(seed, 0x7F1C), request_index)"


def _mix(x: int) -> int:
    """splitmix64 finalizer: bijective 64-bit avalanche."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4B5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """Derive a child key — the jax.random.fold_in analogue of the
    lineage PRNG discipline, jax-free. Pure function of (key, data);
    +1 keeps fold_in(k, 0) distinct from k's own draw stream."""
    return _mix((key + _GAMMA * ((int(data) & _MASK64) + 1)) & _MASK64)


def uniform(key: int) -> float:
    """One double in [0, 1) with 53 random bits, from the key alone.
    Keys are never reused: derive a fresh sub-key per draw."""
    return (_mix(key ^ _GAMMA) >> 11) / float(1 << 53)


def randint(key: int, lo: int, hi: int) -> int:
    """One int in [lo, hi) from the key alone (hi exclusive, hi > lo)."""
    return lo + int(uniform(key) * (hi - lo))


def _exponential(key: int, rate: float) -> float:
    """One Exp(rate) draw; uniform() < 1 keeps log() finite."""
    return -math.log(1.0 - uniform(key)) / rate


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One materialized request of a workload. Immutable and fully
    value-typed (token tuple, plain floats) so two samplings of the same
    spec compare ==, field for field — the replay contract."""

    index: int
    t_offset: float               # arrival offset from run start, seconds
    tokens: tuple                 # prompt token ids (real, un-padded)
    temperature: float
    top_p: float
    greedy: bool
    max_tokens: int
    prefix_group: int             # shared-prefix tenant, -1 = cold prompt
    key: int                      # fold_in-derived request key (KEY_PATH)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Replayable traffic description — the grammar in docs/TRAFFIC.md.

    `rate_rps` is the MEAN offered rate for both arrival shapes; the
    sweep surface (report.py) varies only this field across a grid, so
    every other distribution is held fixed along a goodput curve."""

    seed: int = 0
    n_requests: int = 64
    rate_rps: float = 8.0
    arrival: str = "poisson"      # "poisson" | "bursty"
    burst_factor: float = 4.0     # bursty: burst rate = calm rate × this
    burst_frac: float = 0.25      # bursty: stationary fraction bursting
    mean_burst_s: float = 1.0     # bursty: mean burst holding time
    prompt_len_min: int = 4       # real prompt tokens, inclusive
    prompt_len_max: int = 12      # inclusive
    token_lo: int = 4             # prompt token id range [lo, hi)
    token_hi: int = 60
    prefix_groups: int = 4        # shared-prefix tenants (0 = all cold)
    prefix_frac: float = 0.5      # P(request joins a tenant)
    prefix_len: int = 4           # shared real tokens per tenant
    greedy_frac: float = 0.5      # P(greedy decode)
    temp_min: float = 0.7         # sampled requests: temperature range
    temp_max: float = 1.3
    top_p_min: float = 0.8
    top_p_max: float = 1.0
    max_tokens_min: int = 4       # per-request token budget, inclusive
    max_tokens_max: int = 16      # inclusive

    def validate(self) -> None:
        if self.n_requests < 1:
            raise ValueError(f"n_requests={self.n_requests} must be >= 1")
        if self.rate_rps <= 0.0:
            raise ValueError(f"rate_rps={self.rate_rps} must be > 0")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(
                f"arrival={self.arrival!r}: 'poisson' | 'bursty'")
        if not 0 < self.prompt_len_min <= self.prompt_len_max:
            raise ValueError(
                f"prompt length range [{self.prompt_len_min}, "
                f"{self.prompt_len_max}] invalid")
        if self.token_hi <= self.token_lo:
            raise ValueError("token_hi must exceed token_lo")
        if self.prefix_groups and not (
                0 < self.prefix_len <= self.prompt_len_max):
            raise ValueError(
                f"prefix_len={self.prefix_len} outside "
                f"(0, prompt_len_max={self.prompt_len_max}]")
        if not 0 < self.burst_frac < 1:
            raise ValueError(f"burst_frac={self.burst_frac} outside (0, 1)")
        if self.burst_factor <= 1.0:
            raise ValueError(
                f"burst_factor={self.burst_factor} must be > 1")
        if not 1 <= self.max_tokens_min <= self.max_tokens_max:
            raise ValueError("max_tokens range invalid")


def spec_digest(spec: WorkloadSpec) -> str:
    """Stable short digest of a spec (seed included) — stamped into the
    `traffic_run` lineage event so offline readers can tell two sweeps'
    ledgers apart and pin replay identity across hosts."""
    payload = repr(dataclasses.astuple(spec)).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def _arrival_offsets(spec: WorkloadSpec, root: int) -> list:
    """Cumulative arrival offsets for every request, exact under both
    arrival shapes. Bursty: state intervals are drawn lazily from their
    own stream; an inter-arrival crossing a boundary restarts AT the
    boundary under the new rate (exact by memorylessness), each attempt
    on a fresh sub-key."""
    if spec.arrival == "poisson":
        out, t = [], 0.0
        for i in range(spec.n_requests):
            akey = fold_in(fold_in(root, i), _SUB_ARRIVAL)
            t += _exponential(akey, spec.rate_rps)
            out.append(t)
        return out

    # bursty: calm rate chosen so the stationary mean is exactly rate_rps
    calm = spec.rate_rps / (
        (1.0 - spec.burst_frac) + spec.burst_frac * spec.burst_factor)
    burst = calm * spec.burst_factor
    mean_calm_s = spec.mean_burst_s * (1.0 - spec.burst_frac) / spec.burst_frac
    skey = fold_in(root, _STREAM_STATE)

    def holding(j: int) -> float:
        mean = spec.mean_burst_s if j % 2 else mean_calm_s  # even = calm
        return _exponential(fold_in(skey, j), 1.0 / mean)

    out, t = [], 0.0
    j = 0                       # state interval index (even = calm)
    end = holding(0)            # current interval's end time
    for i in range(spec.n_requests):
        attempt = 0
        while True:
            rate = burst if j % 2 else calm
            akey = fold_in(fold_in(root, i), _SUB_ARRIVAL)
            d = _exponential(fold_in(akey, attempt), rate)
            if t + d <= end or attempt >= 64:
                t += min(d, max(end - t, 0.0)) if attempt >= 64 else d
                break
            t = end
            j += 1
            end += holding(j)
            attempt += 1
        out.append(t)
        while t > end:          # skip intervals an arrival overshot
            j += 1
            end += holding(j)
    return out


def _group_prefixes(spec: WorkloadSpec, root: int) -> list:
    gkey = fold_in(root, _STREAM_GROUPS)
    return [
        tuple(
            randint(fold_in(fold_in(gkey, g), k),
                    spec.token_lo, spec.token_hi)
            for k in range(spec.prefix_len)
        )
        for g in range(spec.prefix_groups)
    ]


def sample_requests(spec: WorkloadSpec) -> tuple:
    """Expand a spec into its full request sequence — pure function of
    the spec (wall-clock-free), bit-identical across calls and hosts."""
    spec.validate()
    root = fold_in(spec.seed, _ROOT)
    offsets = _arrival_offsets(spec, root)
    prefixes = _group_prefixes(spec, root)

    reqs = []
    for i in range(spec.n_requests):
        rkey = fold_in(root, i)
        pkey = fold_in(rkey, _SUB_PREFIX)
        group = -1
        if prefixes and uniform(fold_in(pkey, 0)) < spec.prefix_frac:
            group = randint(fold_in(pkey, 1), 0, len(prefixes))

        lkey = fold_in(rkey, _SUB_LEN)
        n = randint(lkey, spec.prompt_len_min, spec.prompt_len_max + 1)
        prefix = prefixes[group] if group >= 0 else ()
        if group >= 0:
            # a tenant request always carries its full prefix plus at
            # least one unique token (a pure-prefix prompt would make
            # two requests literally identical, hiding COW splits)
            n = max(n, len(prefix) + 1)
            n = min(n, spec.prompt_len_max) if (
                spec.prompt_len_max > len(prefix)) else len(prefix) + 1
        tkey = fold_in(rkey, _SUB_TOKENS)
        suffix = tuple(
            randint(fold_in(tkey, k), spec.token_lo, spec.token_hi)
            for k in range(n - len(prefix))
        )

        skey = fold_in(rkey, _SUB_PARAMS)
        greedy = uniform(fold_in(skey, 0)) < spec.greedy_frac
        temp = (spec.temp_min
                + uniform(fold_in(skey, 1))
                * (spec.temp_max - spec.temp_min))
        top_p = (spec.top_p_min
                 + uniform(fold_in(skey, 2))
                 * (spec.top_p_max - spec.top_p_min))
        budget = randint(fold_in(skey, 3), spec.max_tokens_min,
                         spec.max_tokens_max + 1)

        reqs.append(GenRequest(
            index=i, t_offset=offsets[i], tokens=prefix + suffix,
            temperature=round(temp, 6), top_p=round(top_p, 6),
            greedy=greedy, max_tokens=budget, prefix_group=group,
            key=rkey,
        ))
    return tuple(reqs)


def requests_digest(reqs) -> str:
    """Stable digest over a materialized sequence — the replay-identity
    check two hosts (or two CI runs) compare."""
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr((r.index, round(r.t_offset, 12), r.tokens,
                       r.temperature, r.top_p, r.greedy, r.max_tokens,
                       r.prefix_group)).encode())
    return h.hexdigest()[:16]
