"""Offered-load sweep → goodput curve (docs/TRAFFIC.md §5).

(the port's copy of `nanorlhf_tpu/loadgen/report.py`.)

A single episodes/s number hides the part of the serving story that
matters under load: where goodput stops tracking offered load, how much
traffic is shed past that knee, and how far p95 TTFT degrades before
admission control kicks in. `run_sweep` replays the SAME workload spec
at a grid of offered rates (only `rate_rps` varies; the seed and every
distribution stay fixed, so the curve is deterministic and
regression-testable — the arxiv 2605.25645 goodput-vs-offered-load
framing) and tabulates one SweepPoint per rate.

The sweep owns no engine: the caller passes `run_point(spec)` which must
build a FRESH target per point (bench.py's `detail.traffic` does this so
shed state and hub histograms never bleed across rates), run a
TrafficDriver over it, and return the TrafficSummary. jax-free.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from nanorlhf_tpu_torch.loadgen.workload import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One offered-load grid point's aggregate row."""

    offered_rps: float      # what the spec asked for (nominal rate)
    achieved_rps: float     # what the open-loop driver actually offered
    goodput_rps: float      # completed requests per second
    shed_frac: float
    completed: int
    shed: int
    errors: int
    p50_ttft_s: float | None
    p95_ttft_s: float | None


def run_sweep(run_point: Callable, spec: WorkloadSpec,
              rates: Iterable[float]) -> list[SweepPoint]:
    """Replay `spec` at each rate in `rates`; one SweepPoint per rate."""
    points: list[SweepPoint] = []
    for rate in rates:
        point_spec = dataclasses.replace(spec, rate_rps=float(rate))
        summary = run_point(point_spec)
        points.append(SweepPoint(
            offered_rps=float(rate),
            achieved_rps=round(summary.offered_rps, 4),
            goodput_rps=round(summary.goodput_rps, 4),
            shed_frac=round(summary.shed_frac, 4),
            completed=summary.completed,
            shed=summary.shed,
            errors=summary.errors,
            p50_ttft_s=(round(summary.p50_ttft_s, 6)
                        if summary.p50_ttft_s is not None else None),
            p95_ttft_s=(round(summary.p95_ttft_s, 6)
                        if summary.p95_ttft_s is not None else None),
        ))
    return points


def points_as_detail(points: list[SweepPoint]) -> dict:
    """Column-oriented dict for bench.py's `detail.traffic` JSON."""
    return {
        "offered_rps": [p.offered_rps for p in points],
        "goodput_rps": [p.goodput_rps for p in points],
        "shed_frac": [p.shed_frac for p in points],
        "p95_ttft_s": [p.p95_ttft_s for p in points],
        "completed": [p.completed for p in points],
        "shed": [p.shed for p in points],
        "errors": [p.errors for p in points],
    }


def format_table(points: list[SweepPoint]) -> str:
    """Human-readable curve (inspect_run / bench stderr)."""
    header = (f"{'offered':>9} {'goodput':>9} {'shed%':>7} "
              f"{'p50_ttft':>10} {'p95_ttft':>10} {'done':>6} {'shed':>6}")
    lines = [header]
    for p in points:
        p50 = f"{p.p50_ttft_s:.4f}" if p.p50_ttft_s is not None else "-"
        p95 = f"{p.p95_ttft_s:.4f}" if p.p95_ttft_s is not None else "-"
        lines.append(
            f"{p.offered_rps:>9.2f} {p.goodput_rps:>9.2f} "
            f"{100.0 * p.shed_frac:>6.1f}% {p50:>10} {p95:>10} "
            f"{p.completed:>6d} {p.shed:>6d}")
    return "\n".join(lines)
