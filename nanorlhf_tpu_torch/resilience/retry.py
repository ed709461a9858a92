"""Bounded retry-with-backoff for host-side I/O — a copy of
`nanorlhf_tpu/resilience/retry.py` (the port does not import the JAX
package): synchronous sleep, exponential backoff, exception allowlist,
and the same seeded jitter stream, so a fresh process replays the same
delay sequence as JAX's."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Type

# Default jitter stream for callers that don't pass their own rng. A
# module-level seeded instance (not the global `random` module): the jitter
# draw must never depend on whatever unrelated code did to global random
# state, and a fresh process replays the same delay sequence.
_JITTER_RNG = random.Random(0x6A177E12)


def retry_with_backoff(
    fn: Callable,
    attempts: int = 3,
    backoff_base: float = 0.25,
    backoff_max: float = 30.0,
    retry_on: tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    jitter: float = 0.0,
    rng: Optional[random.Random] = None,
):
    """Call `fn()` up to `attempts` times; sleep base·2^k (capped) between
    tries, spread by ±`jitter` fraction (see `backoff_delay` for why).
    `on_retry(attempt_index, exc)` observes each failure that will be
    retried — the hook where callers count retries into metrics. The final
    failure propagates unchanged."""
    if attempts < 1:
        raise ValueError(f"attempts={attempts} must be >= 1")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(backoff_delay(attempt, backoff_base, backoff_max,
                                jitter=jitter, rng=rng))


def backoff_delay(attempt: int, base: float, cap: float,
                  jitter: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """Exponential backoff schedule shared by the producer watchdog and the
    fleet's worker-quarantine re-admission.

    `jitter` spreads the delay uniformly over ±jitter·delay: N workers (or N
    restarted producers) that failed on the same cause at the same moment
    would otherwise all sleep EXACTLY base·2^k and stampede the weight
    store / checkpoint filesystem in lockstep on every retry wave. Callers
    that need per-caller determinism pass a seeded `random.Random`; the
    default draws from a module-level SEEDED stream (never the global
    `random` module, whose state any unrelated code may have perturbed), so
    the default delay sequence is identical in every fresh process."""
    delay = min(cap, base * (2 ** max(0, attempt)))
    if jitter > 0.0 and delay > 0.0:
        draw = (rng if rng is not None else _JITTER_RNG).random()
        delay *= 1.0 + jitter * (2.0 * draw - 1.0)
    return min(cap, delay)
