"""Page allocator + per-row block tables for the paged KV cache — the port
of `nanorlhf_tpu/sampler/paged/pages.py`.

Logical cache slot t of row r lives at page `table[r, t // page_size]`,
offset `t % page_size`, of a pool shared by every row
(`core/model.init_paged_kv_cache`). Rows that finish hand their pages back
to a free stack, so the continuous-batching scheduler
(`sampler/paged/scheduler.py`) can prefill the next queued prompt into the
freed pages mid-loop.

The port's decode loop is driven by the host, so the allocator lives on the
host too: `PageState` holds numpy arrays, and the session uploads the table
to the device when it changes (at an admission or a release, never per
decode step). The functions are pure — they return a new state — and keep
JAX's invariants, which the tests hold against the JAX allocator op for op:

  * `free[:top]` are the free page ids, a stack popped from `top - 1`
    downward;
  * unallocated and released table entries hold the sentinel `num_pages`;
  * a failed allocation (too few free pages) returns the state unchanged;
  * releasing an already-sentinel row is a no-op that frees 0 pages.

Allocation is full-budget-at-admission: a row claims
`blocks_per_row(prompt_len + max_tokens, page_size)` pages up front and
releases them all when it is flushed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PageState(NamedTuple):
    """Free stack + block table (host numpy arrays)."""
    free: np.ndarray   # [num_pages] int32
    top: int           # number of free pages
    table: np.ndarray  # [rows, blocks_per_row] int32


def blocks_per_row(tokens: int, page_size: int) -> int:
    """Pages a row needs to hold `tokens` logical cache slots."""
    return -(-int(tokens) // int(page_size))


def full_table(rows: int, n_blocks: int) -> np.ndarray:
    """Dense identity table: row r owns pages [r·n_blocks, (r+1)·n_blocks).
    The monolithic paged path and the session's initial batch use it, which
    makes the paged cache a pure re-layout of the contiguous one."""
    return np.arange(rows * n_blocks, dtype=np.int32).reshape(rows, n_blocks)


def init_page_state(num_pages: int, rows: int, n_blocks: int) -> PageState:
    """All pages free, all table entries sentinel."""
    return PageState(free=np.arange(num_pages, dtype=np.int32), top=num_pages,
                     table=np.full((rows, n_blocks), num_pages, np.int32))


def alloc_row(state: PageState, row: int, n_blocks: int) -> tuple[PageState, bool]:
    """Pop `n_blocks` pages (at most the table width) off the free stack
    into `table[row]`; the rest of the row becomes sentinel. Returns
    `(new_state, ok)`; when the stack is too short, `ok` is False and the
    state is returned unchanged."""
    nb = state.table.shape[1]
    num_pages = state.free.shape[0]
    k = min(int(n_blocks), nb)
    if k > state.top:
        return state, False
    row_pages = np.full((nb,), num_pages, np.int32)
    row_pages[:k] = state.free[state.top - 1 - np.arange(k)]
    table = state.table.copy()
    table[row] = row_pages
    return PageState(state.free, state.top - k, table), True


def release_row(state: PageState, row: int) -> tuple[PageState, int]:
    """Push `table[row]`'s live pages back onto the free stack (in table
    order) and reset the row to sentinel. Returns `(new_state, n_released)`;
    a second release of the same row frees 0 pages."""
    num_pages = state.free.shape[0]
    pages = state.table[row]
    live = pages[pages < num_pages]
    free = state.free.copy()
    dest = state.top + np.arange(live.size)
    keep = dest < num_pages  # JAX drops pushes past the stack's storage
    free[dest[keep]] = live[keep]
    table = state.table.copy()
    table[row] = num_pages
    return PageState(free, state.top + int(live.size), table), int(live.size)
