"""Subprocess reaping shared by the grader hosts — a copy of
`nanorlhf_tpu/resilience/procs.py`."""

from __future__ import annotations


def reap_process(p, grace: float = 2.0) -> None:
    """terminate → join(grace) → kill → join: SIGTERM first, SIGKILL for a
    child that ignores/blocks it (signal-handler games, D-state I/O). A
    grader host must never leave an immortal child pinning its scratch
    dir. One implementation so every timeout path escalates identically."""
    p.terminate()
    p.join(grace)
    if p.is_alive():
        p.kill()
        p.join()
