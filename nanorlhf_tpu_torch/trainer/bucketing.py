"""Length bucketing and shape-menu de-padding — the port of
`nanorlhf_tpu/trainer/bucketing.py`. Host-side numpy.

The r1 trainer packs samples into buckets under the memory model
`max_len × rows ≤ budget` and de-pads between phases; bucket lengths and
row counts are rounded up to a menu of powers of two, so a bucket takes
one of few shapes (the kernels and the allocator see a handful of sizes
across updates).
"""

from __future__ import annotations

import numpy as np


def create_batches(lengths, max_batch_memory_size: int) -> list[list[int]]:
    """Greedy length-sorted packing: fill a bucket while
    max(cur_len, next_len) × (count+1) ≤ budget. Returns index lists into
    `lengths` (a stable argsort: equal lengths keep their order)."""
    lengths = np.asarray(lengths)
    order = np.argsort(lengths, kind="stable")
    batches: list[list[int]] = []
    current: list[int] = []
    cur_len = 0
    for idx in order:
        sample_len = int(lengths[idx])
        future = max(cur_len, sample_len) * (len(current) + 1)
        if future > max_batch_memory_size and current:
            batches.append(current)
            current = []
            cur_len = 0
        current.append(int(idx))
        cur_len = max(cur_len, sample_len)
    if current:
        batches.append(current)
    return batches


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


def pad_rows(arrays: dict, n_rows: int, fill: dict) -> dict:
    """Pad each [B, ...] array in `arrays` to n_rows with `fill[key]`
    (default 0). The added rows are masked downstream (all-pad tokens,
    padding_mask True), so only their shape matters."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.shape[0] == n_rows:
            out[k] = v
            continue
        pad_shape = (n_rows - v.shape[0],) + v.shape[1:]
        filler = np.full(pad_shape, fill.get(k, 0), dtype=v.dtype)
        out[k] = np.concatenate([v, filler], axis=0)
    return out
