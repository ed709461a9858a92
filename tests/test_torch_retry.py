"""The port's copy of `resilience/retry.py` against the JAX package's: the
same attempts, delays, retry hooks and final exception, and the same
seeded default jitter stream in a fresh process."""

import os
import random
import subprocess
import sys

import pytest

from nanorlhf_tpu.resilience import retry as jax_retry
from nanorlhf_tpu_torch.resilience import retry as port_retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mod, fail_times: int, attempts: int, **kw):
    calls, sleeps, seen = [], [], []

    def fn():
        calls.append(len(calls))
        if len(calls) <= fail_times:
            raise OSError(f"try {len(calls)}")
        return "done"

    try:
        out = mod.retry_with_backoff(fn, attempts=attempts, sleep=sleeps.append,
                                     on_retry=lambda i, e: seen.append((i, str(e))), **kw)
    except OSError as e:
        out = f"raised {e}"
    return out, len(calls), sleeps, seen


@pytest.mark.parametrize("fail_times,attempts", [(0, 3), (2, 3), (3, 3), (5, 6), (1, 1)])
@pytest.mark.parametrize("jitter", [0.0, 0.25])
def test_retry_matches_jax(fail_times, attempts, jitter):
    kw = dict(backoff_base=0.5, backoff_max=3.0, jitter=jitter)
    got = _run(port_retry, fail_times, attempts, rng=random.Random(7), **kw)
    want = _run(jax_retry, fail_times, attempts, rng=random.Random(7), **kw)
    assert got == want


def test_retry_rejects_zero_attempts_and_other_exceptions():
    for mod in (port_retry, jax_retry):
        with pytest.raises(ValueError):
            mod.retry_with_backoff(lambda: 1, attempts=0)
        with pytest.raises(KeyError):
            mod.retry_with_backoff(lambda: {}["x"], attempts=3, retry_on=(OSError,),
                                   sleep=lambda s: None)


def test_default_jitter_stream_is_jaxs_in_a_fresh_process():
    code = (
        "from nanorlhf_tpu.resilience.retry import backoff_delay as j\n"
        "from nanorlhf_tpu_torch.resilience.retry import backoff_delay as p\n"
        "a = [j(k % 6, 0.25, 30.0, jitter=0.3) for k in range(12)]\n"
        "b = [p(k % 6, 0.25, 30.0, jitter=0.3) for k in range(12)]\n"
        "assert a == b and len(set(a)) == 12, (a, b)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
