"""Shape-menu de-padding — the port of the pieces of
`nanorlhf_tpu/trainer/bucketing.py` the rollout uses. Host-side numpy."""

from __future__ import annotations

import numpy as np


def shape_menu(max_value: int, min_value: int = 16) -> list[int]:
    """Powers of two from min_value up, capped at (and including) max_value."""
    menu = []
    v = min_value
    while v < max_value:
        menu.append(v)
        v *= 2
    menu.append(max_value)
    return menu


def round_up_to_menu(value: int, menu: list[int]) -> int:
    """Smallest menu entry ≥ value (menu sorted ascending)."""
    for m in menu:
        if m >= value:
            return m
    return menu[-1]


def depad_queries(queries: np.ndarray, pad_id: int, menu: list[int]) -> np.ndarray:
    """Strip the batch's common left pad, menu-rounded."""
    nz = queries != pad_id
    q_pad = np.where(nz.any(axis=1), nz.argmax(axis=1), queries.shape[1])
    ctx_needed = queries.shape[1] - int(q_pad.min())
    ctx = min(round_up_to_menu(max(ctx_needed, 1), menu), queries.shape[1])
    return queries[:, queries.shape[1] - ctx:]
