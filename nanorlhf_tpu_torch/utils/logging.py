"""Small logging helpers shared across host-side modules — a copy of
`nanorlhf_tpu/utils/logging.py`."""

from __future__ import annotations

import logging

_seen: set[tuple[str, str]] = set()


def warn_once(logger_name: str, msg: str, *args, level: int = logging.WARNING) -> None:
    """Log a formatted message at most once per unique (logger, rendered
    message) pair — for per-row lookup fallbacks that would otherwise spam
    one identical line per dataset row."""
    rendered = msg % args if args else msg
    key = (logger_name, rendered)
    if key in _seen:
        return
    _seen.add(key)
    logging.getLogger(logger_name).log(level, rendered)
