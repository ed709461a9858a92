"""Mergeable streaming latency histograms (docs/OBSERVABILITY.md §7).

The health plane's P² sketches (health.py) answer "what is the running
p95 of THIS scalar series" in O(1) memory, but they are approximate in a
way that cannot be combined: two workers' P² states have no exact merge,
and a sketch tracks exactly one quantile. The latency surface needs the
opposite trade: *fixed* log-spaced bucket boundaries (HDR-histogram
style) shared by every sketch in the fleet, so

- merge is exact bucket-wise addition (associative and commutative — a
  coordinator can fold worker sketches in any order and the result is
  bit-identical to recording every sample centrally);
- any quantile is answerable after the fact, with relative error bounded
  by one bucket's width (``BUCKETS_PER_DECADE = 32`` → bucket edges grow
  by 10^(1/32) ≈ 7.5%, so interpolated quantiles land within ~4% of the
  exact order statistic);
- memory stays O(occupied buckets) regardless of sample count: counts
  live in a sparse dict, and a latency series that spans 3 decades
  touches ≤ 96 buckets.

The scheme covers 100 ns .. 10 000 s (11 decades). Samples below the
floor land in a single underflow bucket, samples above the ceiling in an
overflow bucket; both participate in quantiles (clamped to the observed
min/max) so a pathological value cannot silently vanish.

`LatencyHub` is the process-wide recording surface: named histograms
behind one lock (``telemetry.hist`` in the declared LOCK_ORDER — ranked
above every lock held at a recording site: the sample queue's condition,
the RPC client lock, and the health monitor's lock, which reads quantiles
during SLO rule evaluation). Recording never calls out while holding the
hub lock. jax-free.

The port's copy of `nanorlhf_tpu/telemetry/hist.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import math
from typing import Optional

from nanorlhf_tpu_torch.analysis.lockorder import make_lock

# Fixed bucket scheme — every sketch in a fleet shares these constants,
# which is what makes merge exact. Changing them is a journal/wire format
# change: state() embeds the scheme and load()/merge() reject mismatches.
HIST_LO = 1e-7            # smallest bucketed value (100 ns)
HIST_DECADES = 11         # 1e-7 s .. 1e4 s
BUCKETS_PER_DECADE = 32   # edge growth 10^(1/32) ≈ 1.0746
HIST_BUCKETS = HIST_DECADES * BUCKETS_PER_DECADE

_LOG_LO = math.log10(HIST_LO)
_UNDER = -1               # value <= HIST_LO
_OVER = HIST_BUCKETS      # value >  10^(log10(lo) + decades)

# metric keys with this prefix are histogram families: the exporter
# renders them as Prometheus histogram exposition and nanolint's registry
# rule cross-checks their _bucket/_sum/_count suffixed forms (both
# directions) against the base METRICS.md row
HISTOGRAM_KEY_PREFIX = "latency/"


def bucket_index(value: float) -> int:
    """Bucket holding `value`; _UNDER/_OVER outside the covered range."""
    if value <= HIST_LO:
        return _UNDER
    i = int(math.floor((math.log10(value) - _LOG_LO) * BUCKETS_PER_DECADE))
    # log10 rounding can land an exact edge value one bucket high/low;
    # clamp — determinism within a process is what merge exactness needs
    if i >= HIST_BUCKETS:
        return _OVER
    return max(i, 0)


def bucket_lower(i: int) -> float:
    return 10.0 ** (_LOG_LO + i / BUCKETS_PER_DECADE)


def bucket_upper(i: int) -> float:
    return 10.0 ** (_LOG_LO + (i + 1) / BUCKETS_PER_DECADE)


# coarse cumulative-export edges for Prometheus `_bucket{le=...}` lines:
# every half decade from 10 µs to 1000 s. These align with internal
# bucket edges (multiples of BUCKETS_PER_DECADE/2), so the cumulative
# counts at each edge are exact, not resampled.
_EXPORT_STEP = BUCKETS_PER_DECADE // 2
EXPORT_EDGE_INDICES = tuple(
    range(2 * BUCKETS_PER_DECADE, HIST_BUCKETS - BUCKETS_PER_DECADE + 1,
          _EXPORT_STEP)
)


class SchemeMismatch(ValueError):
    """Two sketches with different bucket schemes cannot merge exactly."""


class StreamingHistogram:
    """One log-bucketed sketch: record / quantile / merge / state / load.

    NOT thread-safe on its own — `LatencyHub` provides the locking. Kept
    lock-free so tests and the offline inspector can use it directly.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return  # a NaN duration is a caller bug, not a latency sample
        if v < 0.0:
            v = 0.0  # monotonic-clock differences cannot be negative
        i = bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float:
        """Interpolated quantile in [0, 1]; NaN on an empty sketch."""
        if self.count == 0:
            return float("nan")
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        seen = 0
        for i in sorted(self.counts):
            c = self.counts[i]
            if seen + c >= target:
                if i == _UNDER:
                    val = HIST_LO
                elif i == _OVER:
                    val = self.max if self.max is not None else bucket_lower(_OVER)
                else:
                    lo, hi = bucket_lower(i), bucket_upper(i)
                    frac = (target - seen) / c if c else 0.0
                    val = lo + (hi - lo) * frac
                # the sketch knows the exact extremes: never report a
                # quantile outside the observed range
                if self.min is not None:
                    val = max(val, self.min)
                if self.max is not None:
                    val = min(val, self.max)
                return val
            seen += c
        return self.max if self.max is not None else float("nan")

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Exact bucket-wise merge; returns self for chaining."""
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max, other.max)
        return self

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """(upper_edge_seconds, cumulative_count) at the coarse export
        edges, exact by construction — the Prometheus `_bucket` series
        (the final +Inf bucket is `count` and rendered by the exporter)."""
        items = sorted(self.counts.items())
        out: list[tuple[float, int]] = []
        pos = 0
        cum = 0
        for edge_i in EXPORT_EDGE_INDICES:
            while pos < len(items) and items[pos][0] < edge_i:
                cum += items[pos][1]
                pos += 1
            out.append((bucket_lower(edge_i), cum))
        return out

    def summary(self) -> dict:
        """Flat JSON-able digest for /statusz and the run inspector."""
        return {
            "count": self.count,
            "mean_s": self.mean if self.count else None,
            "p50_s": self.quantile(0.50) if self.count else None,
            "p95_s": self.quantile(0.95) if self.count else None,
            "p99_s": self.quantile(0.99) if self.count else None,
            "min_s": self.min,
            "max_s": self.max,
        }

    # -- journal (trainer_state.json) ---------------------------------- #

    def state(self) -> dict:
        return {
            "scheme": [HIST_LO, HIST_DECADES, BUCKETS_PER_DECADE],
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "counts": {str(i): c for i, c in self.counts.items()},
        }

    @classmethod
    def load(cls, state: dict) -> "StreamingHistogram":
        scheme = list(state.get("scheme", []))
        if scheme != [HIST_LO, HIST_DECADES, BUCKETS_PER_DECADE]:
            raise SchemeMismatch(
                f"histogram scheme {scheme} != "
                f"{[HIST_LO, HIST_DECADES, BUCKETS_PER_DECADE]}; sketches "
                f"only merge/restore across identical bucket boundaries"
            )
        h = cls()
        h.count = int(state.get("count", 0))
        h.sum = float(state.get("sum", 0.0))
        h.min = state.get("min")
        h.max = state.get("max")
        h.counts = {int(i): int(c) for i, c in state.get("counts", {}).items()}
        return h


class LatencyHub:
    """Named streaming histograms behind one declared lock.

    The recording surface every latency-bearing path shares: the paged
    scheduler's TTFT/inter-token stamps, the sample queue's dequeue wait,
    the RPC client's per-op RTT, the reward-grader wall, and the
    trainer's phase splits. Disabled (`enabled=False`), `record` is a
    guarded no-op so the off path costs one attribute check.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = make_lock("telemetry.hist")
        self._hists: dict[str, StreamingHistogram] = {}

    def record(self, name: str, value_s: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = StreamingHistogram()
            h.record(value_s)

    # -- read side (exporter, SLO rules, tests) ------------------------ #

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._hists)

    def count(self, name: str) -> int:
        with self._lock:
            h = self._hists.get(name)
            return h.count if h is not None else 0

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
            return h.quantile(q) if h is not None else float("nan")

    def snapshot(self) -> dict:
        """{name: summary digest} — the /statusz `latency` section."""
        with self._lock:
            return {name: h.summary() for name, h in sorted(self._hists.items())}

    def states(self) -> dict:
        """{name: full sketch state} — exporter + journal input. The
        states are deep copies: safe to render outside the lock."""
        with self._lock:
            return {name: h.state() for name, h in self._hists.items()}

    def merge_states(self, states: dict) -> None:
        """Fold another hub's `states()` in — the fleet-merge seam: a
        coordinator collecting per-worker sketches adds them bucket-wise
        into its own, exactly."""
        if not self.enabled:
            return
        loaded = {name: StreamingHistogram.load(s) for name, s in states.items()}
        with self._lock:
            for name, other in loaded.items():
                h = self._hists.get(name)
                if h is None:
                    self._hists[name] = other
                else:
                    h.merge(other)

    # -- journal (trainer_state.json "latency") ------------------------ #

    def journal(self) -> dict:
        return {"hists": self.states()}

    def restore(self, state: dict) -> None:
        hists = (state or {}).get("hists", {})
        loaded = {name: StreamingHistogram.load(s) for name, s in hists.items()}
        with self._lock:
            self._hists.update(loaded)


def percentiles_from_samples(samples: list[float]) -> dict:
    """Exact order-statistic digest of a raw sample list, shaped like
    `StreamingHistogram.summary()` — the jax-free offline reconstruction
    path (tools/inspect_run.py --latency) and its cross-check tests share
    this so 'reconstructed from the ledger' and 'recorded live' disagree
    only by bucket width."""
    if not samples:
        return {"count": 0, "mean_s": None, "p50_s": None, "p95_s": None,
                "p99_s": None, "min_s": None, "max_s": None}
    xs = sorted(float(x) for x in samples)
    n = len(xs)

    def pct(q: float) -> float:
        # linear interpolation between closest ranks (numpy default)
        pos = q * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    return {
        "count": n,
        "mean_s": sum(xs) / n,
        "p50_s": pct(0.50),
        "p95_s": pct(0.95),
        "p99_s": pct(0.99),
        "min_s": xs[0],
        "max_s": xs[-1],
    }
