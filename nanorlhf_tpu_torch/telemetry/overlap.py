"""Rollout/train overlap accounting — the port's copy of `OverlapMeter`
(with `_merge_intervals` and `_sweep_overlap`) from
`nanorlhf_tpu/orchestrator/orchestrator.py`. The trainer feeds it the
generation window of every rollout and its own busy window of every update
and reports `time/rollout_overlap_frac` from it; the synchronous loop's
windows are disjoint, so the fraction stays near 0 until the orchestrator
is ported.
"""

from __future__ import annotations

from nanorlhf_tpu_torch.analysis.lockorder import make_lock


def _merge_intervals(ivs: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for t0, t1 in sorted(ivs):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def _sweep_overlap(gen, busy) -> float:
    """Σ |gen_i ∩ busy_j| over two merged, sorted interval lists."""
    overlap, j = 0.0, 0
    for g0, g1 in gen:
        while j < len(busy) and busy[j][1] <= g0:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < g1:
            overlap += min(g1, busy[k][1]) - max(g0, busy[k][0])
            k += 1
    return overlap


class OverlapMeter:
    """Rollout/train overlap accounting from measured wall-clock intervals.

    Producers record generation busy windows [dispatch, device-ready];
    the consumer records its own busy windows (everything between fetching
    a sample and asking for the next one — reward, scoring, update).
    `overlap_fraction()` = |union(gen) ∩ union(busy)| / |union(gen)|: the
    fraction of generation wall-clock that ran CONCURRENTLY with useful
    trainer work. 0 for the serial trainer (generation only runs while the
    consumer waits); → 1 when the pipeline fully hides generation.

    With N producers (the rollout fleet) the generation windows of
    different workers legitimately OVERLAP each other; the union in the
    numerator/denominator counts concurrently-generating wall-clock once,
    which is the honest "fraction of generation time hidden by training"
    reading. Producers tag their intervals with a per-producer `track`
    (fleet workers use their worker id); the default track 0 reproduces
    the single-producer behavior exactly.

    The metric is cumulative over the trainer's lifetime but the interval
    history is NOT: past `_COMPACT_AT` stored intervals the prefix below a
    watermark is folded into scalar accumulators (overlap seconds + gen
    seconds), so a long run pays O(_COMPACT_AT) per reading instead of an
    ever-growing sweep. The watermark is the minimum over every track (gen
    and busy) of that track's latest recorded end-time: each TRACK records
    chronologically non-overlapping windows (a worker's next dispatch
    starts after its previous sample is device-ready), so every FUTURE
    interval starts at or after its own track's last end ≥ the watermark —
    clipping both histories there makes the folded / retained
    decomposition exact, not an approximation. (Taking the min over the
    raw append order instead would be wrong with N producers: arrivals
    interleave, so the last-appended interval's end is not a lower bound
    on future starts.) A producer that leaves for good must be retired
    (`retire_gen_track`) or its stale watermark pins compaction forever.
    """

    _COMPACT_AT = 4096

    def __init__(self):
        self._lock = make_lock("orchestrator.meter")
        self._gen: list[tuple[float, float]] = []
        self._busy: list[tuple[float, float]] = []
        self._gen_ends: dict[int, float] = {}    # track -> latest end time
        self._busy_ends: dict[int, float] = {}
        self._overlap_acc = 0.0   # folded prefix: overlap seconds
        self._gen_acc = 0.0       # folded prefix: generation seconds

    def note_gen(self, t0: float, t1: float, track: int = 0) -> None:
        with self._lock:
            self._gen.append((t0, t1))
            self._gen_ends[track] = max(self._gen_ends.get(track, t1), t1)
            self._maybe_compact()

    def note_busy(self, t0: float, t1: float, track: int = 0) -> None:
        with self._lock:
            self._busy.append((t0, t1))
            self._busy_ends[track] = max(self._busy_ends.get(track, t1), t1)
            self._maybe_compact()

    def retire_gen_track(self, track: int) -> None:
        """A producer left the fleet for good: stop holding the compaction
        watermark down at its last recorded window."""
        with self._lock:
            self._gen_ends.pop(track, None)

    def _maybe_compact(self) -> None:
        # caller holds the lock
        if len(self._gen) + len(self._busy) < self._COMPACT_AT \
                or not self._gen or not self._busy:
            return
        if not self._gen_ends or not self._busy_ends:
            # every producing track on one side was retired while its
            # intervals are still retained (e.g. all fleet workers lost
            # before the degraded fallback records again): no watermark
            # exists, so skip — the next note_gen/note_busy re-adds a
            # track (whose windows start later in wall-clock) and
            # compaction resumes
            return
        cutoff = min(
            min(self._gen_ends.values()), min(self._busy_ends.values())
        )

        def clip(ivs):
            below, above = [], []
            for t0, t1 in ivs:
                if t1 <= cutoff:
                    below.append((t0, t1))
                elif t0 >= cutoff:
                    above.append((t0, t1))
                else:  # straddler: split exactly at the watermark
                    below.append((t0, cutoff))
                    above.append((cutoff, t1))
            return below, above

        gen_lo, gen_hi = clip(_merge_intervals(self._gen))
        busy_lo, busy_hi = clip(_merge_intervals(self._busy))
        self._overlap_acc += _sweep_overlap(gen_lo, busy_lo)
        self._gen_acc += sum(t1 - t0 for t0, t1 in gen_lo)
        self._gen, self._busy = gen_hi, busy_hi

    def overlap_fraction(self) -> float:
        with self._lock:
            gen = _merge_intervals(self._gen)
            busy = _merge_intervals(self._busy)
            overlap = self._overlap_acc + _sweep_overlap(gen, busy)
            total = self._gen_acc + sum(t1 - t0 for t0, t1 in gen)
        if total <= 0.0:
            return 0.0
        return min(1.0, max(0.0, overlap / total))
