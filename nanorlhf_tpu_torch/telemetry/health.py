"""Run-health plane: O(1)-memory streaming aggregators + anomaly rules.

The telemetry subsystem made runs explainable AFTER the fact (trace.json,
blackbox dumps); this module makes them diagnosable WHILE running. Async
RL pipelines fail quietly — reward collapse, entropy collapse, KL blowup,
queue starvation, recompile storms — long before anything crashes, so the
trainer routes every metric row it emits through a `HealthMonitor`:

- per-metric **streaming aggregates** with O(1) memory: a fast and a slow
  EWMA (mean + West variance, the sentinel's recurrence) plus P² quantile
  sketches (Jain & Chlamtac 1985 — five markers track a quantile without
  storing observations) for the p50/p95 of the series;
- **windowed rates** for cumulative counters (consumer_wait_s, fleet
  quarantines, perf/recompiles), measured on the monotonic clock — the
  same clock discipline as PhaseTimer, so an NTP step cannot fake a storm;
- a **declarative rule set** (`HealthRule`) evaluated against those
  aggregates into per-rule OK/WARN/CRIT levels and an overall verdict.

Each `observe()` call returns `health/*` gauge rows that ride the same
metrics row (docs/METRICS.md), emits trace instants on a "health" track at
every rule transition, and — on an OK/WARN→CRIT transition — dumps a
flight-recorder blackbox (`reason="health"`, via the callable the trainer
wires to `SpanTracer.dump_blackbox`) and invokes the optional `on_crit`
hook (cfg.health_arm_sentinel). Monitor state journals into
`trainer_state.json` under `"health"` — same restart/resume continuity
contract as the fleet counters (windowed rates deliberately excluded: the
monotonic clock does not survive the process; windows re-warm).

Thread-safe: the exporter's HTTP threads read (`gauges`, `snapshot`,
`verdict`) while the trainer thread writes (`observe`). jax-free on
purpose, like tracer.py — unit-testable with plain dict rows.

The port's copy of `nanorlhf_tpu/telemetry/health.py` (the port imports nothing
of the JAX package); `tests/test_torch_telemetry.py` and
`tests/test_torch_resilience.py` hold it against the original.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
import time
from typing import Callable, Optional

OK, WARN, CRIT = "ok", "warn", "crit"
_LEVELS = {OK: 0, WARN: 1, CRIT: 2}


# --------------------------------------------------------------------- #
# streaming aggregators
# --------------------------------------------------------------------- #


class Ewma:
    """EWMA mean + West's EWMA variance (the sentinel's recurrence)."""

    __slots__ = ("alpha", "n", "mean", "var")

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float, winsor_floor: Optional[float] = None) -> None:
        """`winsor_floor` turns on a winsorized VARIANCE update: the mean
        still adapts with the full deviation (the baseline must converge to
        a genuine regime change), but the variance contribution is clipped
        at 4 effective sigma — otherwise the first anomalous observations
        inflate the baseline's own sigma and cap every later z-score at ~2,
        hiding the very collapse the z-rules exist to catch."""
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            if winsor_floor is not None:
                lim = 4.0 * max(self.sigma, winsor_floor)
                dv = max(-lim, min(lim, d))
            else:
                dv = d
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * dv * dv)
        self.n += 1

    @property
    def sigma(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def state(self) -> dict:
        return {"n": self.n, "mean": self.mean, "var": self.var}

    def load(self, s: dict) -> None:
        self.n = int(s.get("n", 0))
        self.mean = float(s.get("mean", 0.0))
        self.var = float(s.get("var", 0.0))


class P2Quantile:
    """P² single-quantile sketch (Jain & Chlamtac 1985): five markers whose
    heights converge to the q-quantile, adjusted with a piecewise-parabolic
    interpolation per observation. O(1) memory, no stored samples — the
    running p50/p95 of a metric series at the cost of ~20 float ops."""

    __slots__ = ("q", "n", "heights", "npos", "desired", "dn")

    def __init__(self, q: float = 0.5):
        self.q = float(q)
        self.n = 0
        self.heights: list[float] = []
        self.npos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.desired = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self.dn = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def update(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return
        self.n += 1
        h = self.heights
        if len(h) < 5:  # warmup: the first five observations seed the markers
            h.append(x)
            h.sort()
            return
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            self.npos[i] += 1.0
        for i in range(5):
            self.desired[i] += self.dn[i]
        for i in (1, 2, 3):
            d = self.desired[i] - self.npos[i]
            if (d >= 1.0 and self.npos[i + 1] - self.npos[i] > 1.0) or (
                d <= -1.0 and self.npos[i - 1] - self.npos[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic estimate escaped its cell: linear fallback
                    j = i + int(d)
                    h[i] = h[i] + d * (h[j] - h[i]) / (self.npos[j] - self.npos[i])
                self.npos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self.heights, self.npos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def value(self) -> float:
        if not self.heights:
            return float("nan")
        if len(self.heights) < 5:  # warmup: order statistic of what we have
            s = sorted(self.heights)
            return s[min(len(s) - 1, max(0, math.ceil(self.q * len(s)) - 1))]
        return self.heights[2]

    def state(self) -> dict:
        return {"q": self.q, "n": self.n, "heights": list(self.heights),
                "npos": list(self.npos), "desired": list(self.desired)}

    def load(self, s: dict) -> None:
        self.n = int(s.get("n", 0))
        self.heights = [float(v) for v in s.get("heights", [])]
        if s.get("npos"):
            self.npos = [float(v) for v in s["npos"]]
        if s.get("desired"):
            self.desired = [float(v) for v in s["desired"]]


class WindowedRate:
    """Per-second rate of a CUMULATIVE counter over a sliding time window.
    Timestamps come from the monotonic clock (perf_counter — PhaseTimer's
    clock discipline), so NTP steps can neither fake nor hide a storm. The
    point buffer is bounded: O(1) memory like everything else here."""

    __slots__ = ("window_s", "max_points", "_pts")

    def __init__(self, window_s: float = 60.0, max_points: int = 256):
        self.window_s = float(window_s)
        self.max_points = int(max_points)
        self._pts: collections.deque = collections.deque()

    def update(self, t: float, v: float) -> None:
        self._pts.append((float(t), float(v)))
        cut = t - self.window_s
        while len(self._pts) > 2 and (
            self._pts[0][0] < cut or len(self._pts) > self.max_points
        ):
            self._pts.popleft()

    def rate(self) -> float:
        if len(self._pts) < 2:
            return 0.0
        t0, v0 = self._pts[0]
        t1, v1 = self._pts[-1]
        if t1 <= t0:
            return 0.0
        # counters are cumulative and monotone; a reset (restart) would show
        # as a negative delta — clamp rather than report a negative storm
        return max(0.0, (v1 - v0) / (t1 - t0))


class MetricAggregate:
    """The per-metric O(1) state: fast + slow EWMA, p50/p95 sketches, last
    value and count. ~40 floats per metric, updated in ~O(1) per row."""

    __slots__ = ("count", "last", "fast", "slow", "p50", "p95",
                 "var_floor_frac")

    def __init__(self, fast_alpha: float, slow_alpha: float,
                 var_floor_frac: float = 0.05):
        self.count = 0
        self.last = float("nan")
        self.var_floor_frac = float(var_floor_frac)
        self.fast = Ewma(fast_alpha)
        self.slow = Ewma(slow_alpha)
        self.p50 = P2Quantile(0.5)
        self.p95 = P2Quantile(0.95)

    def update(self, x: float) -> None:
        self.count += 1
        self.last = x
        self.fast.update(x)
        # the slow tracker IS the anomaly baseline: winsorize its variance
        # update so an anomaly cannot widen its own detection band
        self.slow.update(x, winsor_floor=self.var_floor_frac
                         * abs(self.slow.mean))
        self.p50.update(x)
        self.p95.update(x)

    def state(self) -> dict:
        return {"count": self.count, "last": self.last,
                "fast": self.fast.state(), "slow": self.slow.state(),
                "p50": self.p50.state(), "p95": self.p95.state()}

    @classmethod
    def from_state(cls, s: dict, fast_alpha: float, slow_alpha: float,
                   var_floor_frac: float = 0.05) -> "MetricAggregate":
        agg = cls(fast_alpha, slow_alpha, var_floor_frac)
        agg.count = int(s.get("count", 0))
        agg.last = float(s.get("last", float("nan")))
        agg.fast.load(s.get("fast", {}))
        agg.slow.load(s.get("slow", {}))
        agg.p50.load(s.get("p50", {}))
        agg.p95.load(s.get("p95", {}))
        return agg


# --------------------------------------------------------------------- #
# declarative rules
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class HealthRule:
    """One anomaly rule over one metric's aggregate.

    kinds (warn/crit thresholds, warn fires first):
    - "drop_z":   fast EWMA fell below the slow baseline by >= k sigma
                  (sigma floored at var_floor_frac·|baseline|, like the
                  sentinel — a near-constant series must still trip)
    - "rise_z":   symmetric blowup above the baseline
    - "below_frac": fast EWMA <= frac × running p50 (thresholds are
                  fractions; crit < warn)
    - "above_abs": last value >= threshold
    - "rate_above": windowed per-second rate of a cumulative counter
                  >= threshold
    - "quantile_above": the `quantile` of the attached LatencyHub's
                  histogram named by `metric` >= threshold seconds (the
                  SLO rule shape — p95 TTFT, p99 queue wait, RPC RTT).
                  `warmup` counts histogram SAMPLES, not metric rows;
                  evaluates OK when no hub is attached, so the rule set
                  is safe on monitors without a latency surface.
    """

    name: str
    metric: str
    kind: str
    warn: float
    crit: float
    warmup: int = 8          # min observations of the metric before firing
    description: str = ""
    quantile: float = 0.95   # quantile_above only: which quantile to score


DEFAULT_RULES: tuple = (
    HealthRule("reward_collapse", "eval_objective/rlhf_reward_old",
               "drop_z", warn=3.0, crit=6.0,
               description="reward fast-EWMA fell k·sigma below the slow "
                           "baseline"),
    HealthRule("reward_drift", "eval_objective/rlhf_reward_old",
               "rise_z", warn=4.0, crit=10.0,
               description="reward runaway above the slow baseline (grader "
                           "drift / reward hacking)"),
    HealthRule("entropy_collapse", "policy/entropy_avg_new",
               "below_frac", warn=0.5, crit=0.2,
               description="policy entropy fell below a fraction of its "
                           "running median"),
    HealthRule("kl_blowup", "objective/kl_rollout_old",
               "rise_z", warn=4.0, crit=8.0,
               description="rollout KL-to-reference blowing up vs its slow "
                           "baseline"),
    HealthRule("draft_acceptance_degradation", "rollout/draft_acceptance",
               "below_frac", warn=0.7, crit=0.4,
               description="speculative-decode acceptance degraded vs its "
                           "running median"),
    HealthRule("queue_starvation", "orchestrator/consumer_wait_s",
               "rate_above", warn=0.5, crit=0.9,
               description="trainer starved: consumer wait accruing at >= "
                           "threshold seconds per wall second"),
    HealthRule("fleet_reassignment_rate", "fleet/reassigned_leases",
               "rate_above", warn=0.05, crit=0.2,
               description="lease reassignment churn (workers failing or "
                           "straggling)"),
    HealthRule("fleet_quarantine_rate", "fleet/quarantines",
               "rate_above", warn=0.05, crit=0.2,
               description="workers entering quarantine"),
    HealthRule("recompile_storm", "perf/recompiles",
               "rate_above", warn=0.05, crit=0.5,
               description="XLA backend recompiles accruing mid-run (silent "
                           "retraces)"),
    HealthRule("rpc_error_rate", "fleet/rpc_errors",
               "rate_above", warn=0.5, crit=2.0,
               description="fleet RPC transport errors (torn frames, resets, "
                           "timeouts) accruing per wall second"),
    HealthRule("heartbeat_miss_rate", "fleet/heartbeat_misses",
               "rate_above", warn=0.2, crit=1.0,
               description="worker heartbeats failing to reach the "
                           "coordinator (link degradation before lease "
                           "expiry fires)"),
)

# SLO rules over latency-histogram quantiles (docs/OBSERVABILITY.md §7) —
# the verdicts ROADMAP item 5's autoscaler consumes. Kept OUT of
# DEFAULT_RULES: they only evaluate against an attached LatencyHub, and
# the trainers append them when cfg.latency is on. Thresholds are
# deliberately generous for the CPU CI rig (a cold-compile generation
# wall lands in the TTFT sketch); production overrides pass a custom
# rule tuple through HealthConfig.
SLO_RULES: tuple = (
    HealthRule("slo_ttft_p95", "latency/ttft_s",
               "quantile_above", warn=60.0, crit=300.0,
               warmup=16, quantile=0.95,
               description="p95 admission-to-first-token over the SLO"),
    HealthRule("slo_queue_wait_p99", "latency/queue_wait_s",
               "quantile_above", warn=10.0, crit=60.0,
               warmup=16, quantile=0.99,
               description="p99 sample queue wait over the SLO (trainer "
                           "about to starve or producer racing ahead)"),
    HealthRule("slo_rpc_rtt_p95", "latency/rpc_heartbeat_s",
               "quantile_above", warn=1.0, crit=5.0,
               warmup=16, quantile=0.95,
               description="p95 heartbeat RTT over the SLO (control-plane "
                           "link degradation — heartbeats are small and "
                           "frequent, so their RTT isolates the wire)"),
)


@dataclasses.dataclass
class HealthConfig:
    enabled: bool = True
    fast_alpha: float = 0.5      # tracks the last ~2 rows
    slow_alpha: float = 0.05     # the baseline the fast tracker is judged by
    var_floor_frac: float = 0.05  # sigma floor as a fraction of |baseline|
    warmup: int = 8              # default per-rule min observations
    window_s: float = 60.0       # rate-rule sliding window
    max_events: int = 64         # transition ring kept for /statusz
    # hysteresis: a rule's level steps DOWN only after this many consecutive
    # calmer evaluations — the adapting baseline absorbs a collapse within
    # ~1/slow_alpha rows, and without a hold a 30s-interval scraper would
    # miss the CRIT window entirely (alert resolve-delay semantics)
    recovery_rows: int = 8
    blackbox_on_crit: bool = True
    rules: tuple = DEFAULT_RULES


# --------------------------------------------------------------------- #
# the monitor
# --------------------------------------------------------------------- #


class HealthMonitor:
    """Consumes every metric row the trainers emit; see module docstring.

    `blackbox_fn(step, extra)` is the flight-recorder dump seam (the
    trainer wires `SpanTracer.dump_blackbox(dir, step, "health", extra)`;
    a disabled tracer makes it a no-op). `on_crit(step, rules)` is the
    optional escalation hook (cfg.health_arm_sentinel)."""

    def __init__(self, config: Optional[HealthConfig] = None, tracer=None,
                 blackbox_fn: Optional[Callable] = None,
                 on_crit: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 latency=None):
        self.cfg = config or HealthConfig()
        self.enabled = bool(self.cfg.enabled)
        self._tracer = tracer
        self._blackbox_fn = blackbox_fn
        self._on_crit = on_crit
        self._clock = clock
        # LatencyHub the quantile_above (SLO) rules read; hub quantile
        # reads acquire telemetry.hist, ranked ABOVE telemetry.health in
        # LOCK_ORDER, so reading it during rule eval is order-legal
        self._latency = latency
        self._lock = make_lock("telemetry.health")
        self._aggs: dict[str, MetricAggregate] = {}
        self._rates: dict[str, WindowedRate] = {
            r.metric: WindowedRate(self.cfg.window_s)
            for r in self.cfg.rules if r.kind == "rate_above"
        }
        self._rule_levels: dict[str, str] = {r.name: OK for r in self.cfg.rules}
        self._improve_streak: dict[str, int] = {}
        self._events: collections.deque = collections.deque(
            maxlen=int(self.cfg.max_events)
        )
        self._verdict = OK
        self.rows = 0        # metric rows observed
        self.trips = 0       # OK/WARN -> CRIT transitions

    def attach_latency(self, hub) -> None:
        """Wire a LatencyHub after construction (the trainer builds the
        hub and the monitor in either order)."""
        self._latency = hub

    # ---------------------------------------------------------------- #
    # observation
    # ---------------------------------------------------------------- #

    def observe(self, step: int, row: dict) -> dict:
        """Fold one metric row into the aggregates, evaluate the rules, and
        return the `health/*` gauge rows to ride the same metrics record.
        {} when disabled (the observation itself is the only cost)."""
        if not self.enabled:
            return {}
        with self._lock:
            t = self._clock()
            for k, v in row.items():
                if k.startswith("health/"):
                    continue  # never aggregate our own output
                try:
                    x = float(v)
                except (TypeError, ValueError):
                    continue
                if not math.isfinite(x):
                    continue
                agg = self._aggs.get(k)
                if agg is None:
                    agg = self._aggs[k] = MetricAggregate(
                        self.cfg.fast_alpha, self.cfg.slow_alpha,
                        self.cfg.var_floor_frac,
                    )
                agg.update(x)
                rate = self._rates.get(k)
                if rate is not None:
                    rate.update(t, x)
            self.rows += 1
            transitions = []
            for rule in self.cfg.rules:
                level, signal, detail = self._eval_rule_locked(rule)
                prev = self._rule_levels[rule.name]
                if _LEVELS[level] < _LEVELS[prev]:
                    # hysteresis hold: step down only after recovery_rows
                    # consecutive calmer evaluations
                    streak = self._improve_streak.get(rule.name, 0) + 1
                    if streak < int(self.cfg.recovery_rows):
                        self._improve_streak[rule.name] = streak
                        level = prev
                    else:
                        self._improve_streak[rule.name] = 0
                else:
                    self._improve_streak[rule.name] = 0
                if level != prev:
                    ev = {"unix_time": time.time(), "step": int(step),
                          "rule": rule.name, "level": level, "prev": prev,
                          "signal": round(float(signal), 4),
                          "detail": detail or rule.description}
                    self._events.append(ev)
                    transitions.append(ev)
                    self._rule_levels[rule.name] = level
            prev_verdict = self._verdict
            verdict = self._verdict_locked()
            self._verdict = verdict
            crit_extra = None
            if verdict == CRIT and prev_verdict != CRIT:
                self.trips += 1
                crit_extra = {
                    "rules": sorted(n for n, l in self._rule_levels.items()
                                    if l == CRIT),
                    "step": int(step),
                }
            rows_out = self._gauges_locked()
        # tracer/blackbox/escalation OUTSIDE the monitor lock: the tracer has
        # its own lock and blackbox_fn reaches back into the trainer
        if self._tracer is not None:
            for ev in transitions:
                self._tracer.instant(
                    f"health.{ev['rule']}", track="health", level=ev["level"],
                    prev=ev["prev"], step=ev["step"], signal=ev["signal"],
                )
            if verdict != prev_verdict:
                self._tracer.instant("health.verdict", track="health",
                                     level=verdict, prev=prev_verdict,
                                     step=int(step))
        if crit_extra is not None:
            if self.cfg.blackbox_on_crit and self._blackbox_fn is not None:
                try:
                    self._blackbox_fn(int(step), dict(crit_extra))
                except Exception as e:  # post-mortem aid must not kill the run
                    print(f"[health] blackbox dump failed: "
                          f"{type(e).__name__}: {e}")
            if self._on_crit is not None:
                self._on_crit(int(step), list(crit_extra["rules"]))
        return rows_out

    def _eval_rule_locked(self, rule: HealthRule) -> tuple:
        """-> (level, signal, detail). The signal is the breach magnitude in
        the rule's own units (z-score, fraction-of-median, rate/s)."""
        warmup = rule.warmup if rule.warmup else self.cfg.warmup
        if rule.kind == "quantile_above":
            # histogram-backed: no MetricAggregate exists for the metric
            # (it names a latency sketch, not a row) — gate on the sketch
            return self._eval_quantile_rule(rule, warmup)
        agg = self._aggs.get(rule.metric)
        if agg is None or agg.count < max(int(warmup), 1):
            return OK, 0.0, ""
        if rule.kind in ("drop_z", "rise_z"):
            floor = self.cfg.var_floor_frac * abs(agg.slow.mean)
            sigma = max(agg.slow.sigma, floor)
            if sigma <= 0.0:
                return OK, 0.0, ""
            z = (agg.fast.mean - agg.slow.mean) / sigma
            signal = -z if rule.kind == "drop_z" else z
            level = (CRIT if signal >= rule.crit
                     else WARN if signal >= rule.warn else OK)
            return level, signal, (
                f"fast={agg.fast.mean:.4g} baseline={agg.slow.mean:.4g} "
                f"z={z:+.2f}" if level != OK else ""
            )
        if rule.kind == "below_frac":
            base = agg.p50.value()
            if not math.isfinite(base) or base <= 0.0:
                return OK, 0.0, ""
            frac = agg.fast.mean / base
            level = (CRIT if frac <= rule.crit
                     else WARN if frac <= rule.warn else OK)
            return level, frac, (
                f"fast={agg.fast.mean:.4g} is {frac:.2f}× the running "
                f"median {base:.4g}" if level != OK else ""
            )
        if rule.kind == "above_abs":
            v = agg.last
            level = (CRIT if v >= rule.crit
                     else WARN if v >= rule.warn else OK)
            return level, v, (f"last={v:.4g}" if level != OK else "")
        if rule.kind == "rate_above":
            r = self._rates[rule.metric].rate()
            level = (CRIT if r >= rule.crit
                     else WARN if r >= rule.warn else OK)
            return level, r, (
                f"{r:.4g}/s over the last {self.cfg.window_s:.0f}s"
                if level != OK else ""
            )
        raise ValueError(f"unknown rule kind {rule.kind!r}")

    def _eval_quantile_rule(self, rule: HealthRule, warmup) -> tuple:
        """SLO rule: score one quantile of an attached latency histogram
        against absolute-seconds thresholds. The warmup gate counts the
        SKETCH's samples (rule.metric names a histogram, not a metric
        row), so a rule cannot fire off two noisy observations. The agg
        warmup gate in _eval_rule_locked does not apply — histograms fill
        many samples per metric row."""
        hub = self._latency
        if hub is None or not getattr(hub, "enabled", False):
            return OK, 0.0, ""
        if hub.count(rule.metric) < max(int(warmup), 1):
            return OK, 0.0, ""
        v = hub.quantile(rule.metric, rule.quantile)
        if not math.isfinite(v):
            return OK, 0.0, ""
        level = (CRIT if v >= rule.crit
                 else WARN if v >= rule.warn else OK)
        return level, v, (
            f"p{rule.quantile * 100:g}={v:.4g}s "
            f"(warn>={rule.warn:g}s crit>={rule.crit:g}s)"
            if level != OK else ""
        )

    def _verdict_locked(self) -> str:
        worst = max(_LEVELS[l] for l in self._rule_levels.values()) \
            if self._rule_levels else 0
        return {0: OK, 1: WARN, 2: CRIT}[worst]

    def _gauges_locked(self) -> dict:
        n_warn = sum(1 for l in self._rule_levels.values() if l == WARN)
        n_crit = sum(1 for l in self._rule_levels.values() if l == CRIT)
        out = {
            "health/verdict": float(_LEVELS[self._verdict]),
            "health/rules_warn": float(n_warn),
            "health/rules_crit": float(n_crit),
            "health/trips": float(self.trips),
        }
        out.update({
            f"health/rule_{name}": float(_LEVELS[level])
            for name, level in self._rule_levels.items()
        })
        return out

    # ---------------------------------------------------------------- #
    # read side (exporter HTTP threads)
    # ---------------------------------------------------------------- #

    @property
    def verdict(self) -> str:
        with self._lock:
            return self._verdict

    def gauges(self) -> dict:
        """Current `health/*` gauge values (the /metrics merge — live even
        between logging_steps rows). {} when disabled."""
        if not self.enabled:
            return {}
        with self._lock:
            return self._gauges_locked()

    def events(self, n: Optional[int] = None) -> list:
        """The most recent rule-transition events (newest last)."""
        with self._lock:
            evs = list(self._events)
        return evs if n is None else evs[-int(n):]

    def snapshot(self) -> dict:
        """JSON-able state for /statusz."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "verdict": self._verdict,
                "trips": self.trips,
                "rows": self.rows,
                "rules": dict(self._rule_levels),
                "events": list(self._events),
            }

    # ---------------------------------------------------------------- #
    # checkpoint journal (trainer_state.json under "health")
    # ---------------------------------------------------------------- #

    def journal(self) -> dict:
        with self._lock:
            return {
                "rows": self.rows,
                "trips": self.trips,
                "verdict": self._verdict,
                "rule_levels": dict(self._rule_levels),
                "improve_streaks": dict(self._improve_streak),
                "events": list(self._events),
                "aggregates": {k: a.state() for k, a in self._aggs.items()},
            }

    def restore(self, journal: dict) -> None:
        """Resume the aggregates/verdict/trip accounting from a checkpoint.
        Windowed rates are NOT restored — their monotonic timestamps died
        with the old process; the windows re-warm, which only delays a
        rate rule, never double-counts."""
        with self._lock:
            self.rows = int(journal.get("rows", 0))
            self.trips = int(journal.get("trips", 0))
            self._verdict = str(journal.get("verdict", OK))
            levels = journal.get("rule_levels") or {}
            self._rule_levels = {
                r.name: str(levels.get(r.name, OK)) for r in self.cfg.rules
            }
            self._improve_streak = {
                k: int(v)
                for k, v in (journal.get("improve_streaks") or {}).items()
            }
            self._events = collections.deque(
                list(journal.get("events") or []),
                maxlen=int(self.cfg.max_events),
            )
            self._aggs = {
                k: MetricAggregate.from_state(
                    s, self.cfg.fast_alpha, self.cfg.slow_alpha,
                    self.cfg.var_floor_frac,
                )
                for k, s in (journal.get("aggregates") or {}).items()
            }
