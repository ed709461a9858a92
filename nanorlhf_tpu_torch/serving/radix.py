"""Cross-request radix prefix cache over the ref-counted paged KV pool —
the port of `nanorlhf_tpu/serving/radix.py`. The host side (`RefPagePool`,
the tree, `AdmissionPlan`, `RadixCache`, `bucket_len`, `prompt_key`) is a
copy, held against the original by `tests/test_torch_serving.py`; the two
device helpers are rewritten on torch: `copy_page` copies one page of every
layer's pool in place, and `suffix_logits` runs the port's
`core/model.decode_verify` through the row's table (K9 on the card, at
Tq = the suffix's bucket, up to the prompt width).

`rollout_shared_prefill` (sampler.py) shares prompt KV only when N
samples fan out of ONE prompt inside one jit. This module generalizes
that to arbitrary cross-request overlap, the way SGLang-style radix
caches do, on top of the paged layout from sampler/paged/:

  * `RefPagePool` extends the page allocator to REFCOUNTS: a physical
    page may back the block tables of several requests plus the cache
    tree at once; alloc/release become ref/unref, and a page returns to
    the free stack only at refcount zero. Unlike `pages.PageState` (a
    jitted device free-stack), the pool is host-side — admission is
    host-driven in both consumers (the continuous-batching scheduler
    and the serving engine), so the allocator never needs to trace.
  * `RadixCache` maps token-prefix keys to page ids. Keys are the
    LEFT-PADDED prompt rows with the mask bit folded into each element
    (`k_i = tok_i * 2 + mask_i`): two rows match only when their pad
    layout matches, which is exactly the condition under which their
    cache-slot layouts (and hence their per-slot KV values) coincide.
    A node's edge is a token-key span; a node owns the pages whose
    coverage ENDS inside its span, so an edge split at a non-page-
    aligned boundary re-partitions page ownership without copying.
  * A matched prefix of `m` tokens installs `m // P` full shared pages
    into the new request's block table with zero prefill FLOPs
    (refcount inc only). A match ending MID-PAGE is a copy-on-write
    split: the straddling donor page — valid for slots
    `[m_full, m)`, garbage beyond (the donor branch's divergent
    tokens) — is device-copied into a fresh page the request owns, and
    only the suffix `[m, Tp)` is prefilled through `suffix_logits`
    below (a `decode_verify` forward: the existing single-row jitted
    prefill primitive at suffix granularity).
  * Under memory pressure `plan()` evicts least-recently-used
    refcount-0 subtrees (leaves whose pages are referenced by the tree
    alone — never a page a live request still holds) until the
    admission fits.

Parity: in JAX the suffix forward reproduces full prefill bit-for-bit on
the CPU mesh because every per-position computation (attention row, MLP,
norms) is row-independent and the effective masks/positions/embeddings
coincide — the same argument `decode_verify` vs `decode_step` rests
on, pinned by tests/test_serving.py. Matches that end inside a row's
pad region are deliberately treated as cold (`m = 0`): a suffix
containing pad slots would attend them as real candidates and break
that equivalence.

Staleness: cached KV is only valid for the params that produced it.
The rollout scheduler therefore `reset()`s the cache at the start of
every `generate` call (prefix reuse across the repeated prompts of one
rollout queue — the n>1 queued path and dataset-level prompt repeats),
while the serving engine, whose params are fixed, keeps one tree alive
across its whole lifetime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from nanorlhf_tpu_torch.analysis.lockorder import make_lock
from nanorlhf_tpu_torch.core.model import decode_verify


class RefPagePool:
    """Host-side ref-counted page allocator. `alloc()` pops a free page
    at refcount 1; `ref()` adds a holder; `unref()` drops one and frees
    the page at zero. Double-unref of a free page is a hard error — the
    holders (request block tables, tree nodes) each own exactly one
    reference and must release it exactly once (see the
    `pages.release_row` docstring for the jitted allocator's analogous
    idempotence contract)."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self.ref = np.zeros(self.num_pages, np.int32)
        self._free = list(range(self.num_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        p = self._free.pop()
        assert self.ref[p] == 0
        self.ref[p] = 1
        return p

    def inc(self, page: int) -> None:
        assert self.ref[page] > 0, f"ref of free page {page}"
        self.ref[page] += 1

    def unref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert self.ref[page] > 0, f"unref of free page {page}"
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def shared_count(self) -> int:
        """Pages currently held by more than one owner."""
        return int(np.sum(self.ref > 1))


class _Node:
    __slots__ = ("edge", "end", "children", "page_map", "parent",
                 "last_use")

    def __init__(self, edge: tuple, end: int, parent: "_Node | None"):
        self.edge = edge          # token-key span labelling the inbound edge
        self.end = end            # cumulative key length at this node's end
        self.children: dict = {}  # first key element -> _Node
        self.page_map: dict = {}  # page index -> page id (ends in this span)
        self.parent = parent
        self.last_use = 0


@dataclass
class AdmissionPlan:
    """One admission's page layout, refs already taken: `row_pages` is
    the full block-table row (every entry allocated or shared),
    `m` the matched key length (0 = cold), `cow_src/cow_dst` the
    device copy the caller must issue before the suffix prefill."""
    m: int
    hit_tokens: int               # matched REAL tokens (pads excluded)
    row_pages: np.ndarray         # [n_blocks] int32
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None
    evicted: int = 0
    shared: int = 0               # pages installed by refcount inc alone


class RadixCache:
    """The tree + pool + stats, all under `make_lock("serving.radix")`.

    `headroom` scales the extra pages the consumers add past the
    resident rows' full budget (`extra = ceil(R * nb * headroom)`) —
    the slack that lets released rows' prefixes stay cached instead of
    being evicted the moment their row is recycled."""

    def __init__(self, enabled: bool = True, headroom: float = 1.0):
        self.enabled = enabled
        self.headroom = float(headroom)
        self._lock = make_lock("serving.radix")
        self.page_size = 0
        self.pool: Optional[RefPagePool] = None
        self._root = _Node((), 0, None)
        self._clock = 0
        # cumulative across resets — the serving/* and pages/shared
        # metric surfaces read these
        self.stats = {
            "lookups": 0, "lookup_tokens": 0, "hit_tokens": 0,
            "cow_splits": 0, "evicted_pages": 0, "inserted_nodes": 0,
            "shared_pages_acquired": 0,
        }

    # ------------------------------------------------------------- #
    # lifecycle
    # ------------------------------------------------------------- #

    def extra_pages(self, rows: int, n_blocks: int) -> int:
        return max(n_blocks, int(np.ceil(rows * n_blocks * self.headroom)))

    def reset(self, num_pages: int, page_size: int) -> None:
        """Fresh pool + empty tree. Cached KV is tied to the params that
        wrote it, so the rollout path resets per generate call; stats
        accumulate across resets."""
        with self._lock:
            self.page_size = int(page_size)
            self.pool = RefPagePool(num_pages)
            self._root = _Node((), 0, None)

    # ------------------------------------------------------------- #
    # match / admit
    # ------------------------------------------------------------- #

    def _match(self, key: tuple):
        """(m, node, pages): longest tree prefix of `key`, the node the
        match ends in (or at), and {page index: (page id, coverage
        end)} along the matched path — deeper occurrences override."""
        node, pos, pages = self._root, 0, {}
        self._clock += 1
        while True:
            node.last_use = self._clock
            for idx, pid in node.page_map.items():
                pages[idx] = (pid, min((idx + 1) * self.page_size, node.end))
            if pos >= len(key):
                return pos, node, pages
            child = node.children.get(key[pos])
            if child is None:
                return pos, node, pages
            common = 0
            limit = min(len(child.edge), len(key) - pos)
            while common < limit and child.edge[common] == key[pos + common]:
                common += 1
            if common < len(child.edge):
                # match dies inside this edge: the child's pages with
                # coverage start below the match point are still valid
                # donors/shares up to pos+common
                child.last_use = self._clock
                for idx, pid in child.page_map.items():
                    pages[idx] = (pid,
                                  min((idx + 1) * self.page_size, child.end))
                return pos + common, child, pages
            node, pos = child, pos + common

    def _find_donor(self, node: _Node, idx: int):
        """DFS below/at `node` for any page with index `idx` — every
        branch agrees on the matched slots, so the first found works."""
        stack = [node]
        while stack:
            n = stack.pop()
            if idx in n.page_map:
                return n.page_map[idx]
            stack.extend(n.children.values())
        return None

    def _evictable(self):
        """Leaves whose pages are tree-only (refcount 1), LRU first."""
        assert self.pool is not None
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self._root or n.children:
                continue
            if all(self.pool.ref[p] == 1 for p in n.page_map.values()):
                out.append(n)
        out.sort(key=lambda n: n.last_use)
        return out

    def _evict_one(self) -> int:
        """Drop LRU evictable leaves until at least one page is freed;
        returns pages freed (0 = none evictable). Never touches a page
        some request still references — shared pages keep their node
        pinned (refcount > 1). Leaves with an empty page_map (their
        whole coverage lives in an ancestor, e.g. after a split) free
        nothing, so they are collapsed and the scan continues rather
        than being reported as pool exhaustion."""
        while True:
            cands = self._evictable()
            if not cands:
                return 0
            victim = cands[0]
            freed = 0
            for pid in victim.page_map.values():
                freed += 1 if self.pool.unref(pid) else 0
            assert freed == len(victim.page_map), \
                "evicted a page another holder still references"
            parent = victim.parent
            del parent.children[victim.edge[0]]
            self.stats["evicted_pages"] += freed
            if freed:
                return freed

    def plan(self, key: tuple, *, pad_count: int, n_blocks: int,
             prompt_len: int) -> AdmissionPlan:
        """Match `key`, take refs on the shared full pages, allocate the
        rest of the row's full page budget (evicting LRU refcount-0
        subtrees when the free stack runs short), and return the
        admission layout. Raises RuntimeError when the pool cannot fit
        the row even after eviction — callers size rollout pools so this
        never fires there; the serving engine sheds instead."""
        assert self.pool is not None, "RadixCache.reset() before plan()"
        P = self.page_size
        with self._lock:
            m, node, pages = self._match(key)
            m = min(m, prompt_len - 1)       # >= 1 suffix token for logits
            if m < pad_count:
                m = 0                        # suffix must be pad-free
            m_full = (m // P) * P
            self.stats["lookups"] += 1
            self.stats["lookup_tokens"] += prompt_len - pad_count
            shared = {}
            for idx in range(m // P):
                ent = pages.get(idx)
                if ent is None or ent[1] < (idx + 1) * P:
                    # coverage gap (shouldn't happen on contiguous
                    # inserts) — degrade to the covered prefix
                    m, m_full = idx * P, idx * P
                    break
                shared[idx] = ent[0]
            if m < pad_count:                # degrade re-entered the pads
                m = 0
            if m == 0:
                shared = {}
                m_full = 0
            donor = None
            # a straddler is only worth a COW copy when its valid slots
            # [m_full, m) contain REAL tokens; a pads-only straddler
            # (m == pad_count) is never read, so skip the device copy
            # and let the suffix prefill own the page outright
            if m > m_full and m > pad_count:
                ent = pages.get(m // P)
                if ent is not None and ent[1] >= m:
                    donor = ent[0]
                else:
                    donor = self._find_donor(node, m // P)
                if donor is None:
                    # no straddler cached: degrade to the page-aligned
                    # prefix — cold if that boundary sits inside the pads
                    m = m_full if m_full >= pad_count else 0
            if m == 0:
                shared, m_full, donor = {}, 0, None

            need = n_blocks - len(shared)
            evicted = self.stats["evicted_pages"]
            # the pages this plan shares, and its COW donor, are referenced
            # BEFORE eviction runs, so it cannot free them: JAX's plan takes
            # them after the loop, and an LRU leaf holding a page it is
            # about to share (tree-only, refcount 1) trips `inc`'s
            # assertion there
            held = list(shared.values())
            if donor is not None and m > m_full:
                held.append(donor)
            for pid in held:
                self.pool.inc(pid)
            while self.pool.free_count < need:
                if self._evict_one() == 0:
                    for pid in held:
                        self.pool.unref(pid)
                    raise RuntimeError(
                        f"radix pool exhausted: need {need} pages, "
                        f"{self.pool.free_count} free, nothing evictable")
            row = np.full(n_blocks, self.pool.num_pages, np.int32)
            for idx, pid in shared.items():
                row[idx] = pid
            for idx in range(len(shared), n_blocks):
                row[idx] = self.pool.alloc()
            cow_src = cow_dst = None
            if donor is not None and m > m_full:
                self.pool.unref(donor)   # the tree's reference remains
                cow_src, cow_dst = donor, int(row[m // P])
                self.stats["cow_splits"] += 1
            hit = max(0, m - pad_count)
            self.stats["hit_tokens"] += hit
            self.stats["shared_pages_acquired"] += len(shared)
            return AdmissionPlan(
                m=m, hit_tokens=hit, row_pages=row, cow_src=cow_src,
                cow_dst=cow_dst, shared=len(shared),
                evicted=self.stats["evicted_pages"] - evicted)

    # ------------------------------------------------------------- #
    # insert / release
    # ------------------------------------------------------------- #

    def insert(self, key: tuple, row_pages: np.ndarray,
               cached_len: int) -> None:
        """Install the freshly prefilled row's prefix `key[:cached_len]`
        into the tree; the tree takes one extra reference per page it
        adopts (pages already covered by an existing branch stay
        private to the row)."""
        assert self.pool is not None
        key = tuple(key[:cached_len])
        P = self.page_size
        with self._lock:
            self._clock += 1
            node, pos = self._root, 0
            while pos < len(key):
                node.last_use = self._clock
                child = node.children.get(key[pos])
                if child is None:
                    break
                common = 0
                limit = min(len(child.edge), len(key) - pos)
                while common < limit and \
                        child.edge[common] == key[pos + common]:
                    common += 1
                if common < len(child.edge):
                    self._split(child, common)
                    child = node.children[key[pos]]
                node, pos = child, pos + common
            if pos >= len(key):
                node.last_use = self._clock
                return                       # full key already cached
            leaf = _Node(key[pos:], len(key), node)
            node.children[key[pos]] = leaf
            leaf.last_use = self._clock
            for idx in range(pos // P, -(-len(key) // P)):
                pid = int(row_pages[idx])
                self.pool.inc(pid)
                leaf.page_map[idx] = pid
            self.stats["inserted_nodes"] += 1

    def extend_text(self, key: tuple) -> None:
        """Insert `key` into the tree as TEXT ONLY — no pages adopted
        (empty `page_map`). The decode session calls this at row release
        with the row's prompt key extended by its GENERATED tokens
        (mask bit 1), so the tree remembers what followed each cached
        prefix even though the generated tokens' KV pages were recycled.
        `matched_continuation` reads these nodes to seed the n-gram
        drafter (sampler/speculative.py). Text-only nodes are safe by
        construction elsewhere: `plan()` degrades a match to the covered
        page prefix when it walks past the paged region (the existing
        coverage-gap rule), and `_evict_one` collapses empty-page_map
        leaves instead of counting them as pool exhaustion."""
        assert self.pool is not None
        with self._lock:
            self._clock += 1
            node, pos = self._root, 0
            while pos < len(key):
                node.last_use = self._clock
                child = node.children.get(key[pos])
                if child is None:
                    break
                common = 0
                limit = min(len(child.edge), len(key) - pos)
                while common < limit and \
                        child.edge[common] == key[pos + common]:
                    common += 1
                if common < len(child.edge):
                    self._split(child, common)
                    child = node.children[key[pos]]
                node, pos = child, pos + common
            if pos >= len(key):
                node.last_use = self._clock
                return                       # full key already cached
            leaf = _Node(key[pos:], len(key), node)
            node.children[key[pos]] = leaf
            leaf.last_use = self._clock
            self.stats["inserted_nodes"] += 1

    def matched_continuation(self, key: tuple, window: int) -> np.ndarray:
        """Up to `window` DECODE-TOKEN ids cached past `key`'s longest
        tree match — what some earlier request's text continued with
        after this prompt's matched prefix (descending the most recently
        used child at each branch). Elements with the mask bit unset
        (pad-layout keys) are dropped, so the result is plain token ids
        ready for the drafter's seed buffer. Empty when the key is cold."""
        with self._lock:
            m, node, _pages = self._match(key)
            if m == 0:
                return np.zeros((0,), np.int32)
            cont: list = []
            # tail of the edge the match ended inside (m == node.end
            # means the edge is fully consumed and we descend directly)
            edge_off = m - (node.end - len(node.edge))
            cur = node
            while len(cont) < window:
                cont.extend(cur.edge[edge_off:])
                edge_off = 0
                if not cur.children:
                    break
                cur = max(cur.children.values(), key=lambda n: n.last_use)
            toks = [k // 2 for k in cont if k & 1]
            return np.asarray(toks[:window], np.int32)

    def _split(self, child: _Node, at: int) -> None:
        """Split `child`'s edge `at` elements in: a new mid node takes
        the pages whose coverage ends at or before the split point."""
        parent = child.parent
        split_end = child.end - len(child.edge) + at
        mid = _Node(child.edge[:at], split_end, parent)
        mid.last_use = child.last_use
        parent.children[child.edge[0]] = mid
        child.edge = child.edge[at:]
        child.parent = mid
        mid.children[child.edge[0]] = child
        P = self.page_size
        for idx in [i for i in child.page_map
                    if min((i + 1) * P, child.end) <= split_end]:
            mid.page_map[idx] = child.page_map.pop(idx)

    def release(self, row_pages: np.ndarray) -> int:
        """Drop the ROW's reference on each allocated table entry (tree
        references survive — that is the cache). Returns pages actually
        freed. Sentinel entries (== num_pages) are skipped, so a
        released row's sentinel-reset table is safe to pass again —
        idempotence lives at the row-hold level, mirroring
        `pages.release_row`."""
        assert self.pool is not None
        freed = 0
        with self._lock:
            for pid in np.asarray(row_pages).ravel():
                pid = int(pid)
                if pid >= self.pool.num_pages:
                    continue
                freed += 1 if self.pool.unref(pid) else 0
        return freed

    # ------------------------------------------------------------- #
    # introspection
    # ------------------------------------------------------------- #

    def snapshot(self) -> dict:
        """JSON-able state for /statusz and tools/inspect_run.py."""
        with self._lock:
            nodes = cached = 0
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                nodes += 1
                cached += len(n.page_map)
            hit, total = self.stats["hit_tokens"], self.stats["lookup_tokens"]
            return {
                "nodes": nodes - 1,          # root is structural
                "cached_pages": cached,
                "free_pages": self.pool.free_count if self.pool else 0,
                "num_pages": self.pool.num_pages if self.pool else 0,
                "shared_pages": self.pool.shared_count() if self.pool else 0,
                "page_size": self.page_size,
                "hit_frac": hit / max(total, 1),
                **dict(self.stats),
            }


# ----------------------------------------------------------------- #
# device helpers (shared by the rollout scheduler and the engine)
# ----------------------------------------------------------------- #

@torch.no_grad()
def copy_page(caches, src: int, dst: int):
    """COW split: duplicate physical page `src` into `dst` across every
    layer of the pool tuple ([L, num_pages + 1, ...] tensors), in place
    (JAX returns new pools). Returns `caches`."""
    for c in caches:
        c[:, dst].copy_(c[:, src])
    return caches


@torch.no_grad()
def suffix_logits(params, config, suffix_ids, positions, fill, last,
                  key_mask, caches, row_table, *, page_size, lora_scale):
    """Single-row suffix prefill: a `decode_verify` forward over the
    unmatched prompt tail writes its KV at slots [fill, fill+Sb) through
    the row's block table (in place) and returns the last REAL token's
    next-token logits ([V]) — `last` indexes past the bucket-padding tail,
    whose garbage KV lands in decode-region slots that the decode loop
    overwrites before ever marking them attendable. The caller buckets
    suffix lengths (`bucket_len`), as JAX does to bound its retraces; here
    the bucket is the K9 launch's Tq. suffix_ids / positions: [1, Sb];
    fill: [1]; key_mask: [1, T_max]; row_table: [nb]. Returns (logits,
    caches)."""
    logits, caches = decode_verify(
        params, config, suffix_ids, positions, fill, key_mask, caches,
        lora_scale=lora_scale, page_table=row_table[None, :],
        page_size=page_size)
    return logits[0, int(last)], caches


def bucket_len(n: int, cap: int) -> int:
    """Round a suffix length up to a power of two, clamped to `cap`
    (the slots left in the row's page budget) — in JAX one retrace per
    bucket instead of one per distinct suffix length."""
    b = 1
    while b < n:
        b *= 2
    return max(n, min(b, cap))


def prompt_key(tokens: np.ndarray, mask: np.ndarray) -> tuple:
    """Radix key for one left-padded prompt row: the mask bit folds into
    each element so prefixes only match when their pad layout does —
    the condition for slot-identical KV."""
    return tuple(int(t) * 2 + int(b) for t, b in
                 zip(np.asarray(tokens), np.asarray(mask).astype(bool)))
