"""Paged KV-cache bookkeeping for the continuous engine: the twin of the
JAX package's ``serving/paging.py`` (allocator part; the prefix index
and the delta spill store come with the scheduler slice).

A ``BlockAllocator`` owns a global pool of fixed-size KV pages.  Each
active sequence holds a growable block table (list of page ids); pages
are handed out as prompt chunks land and during decode (one page every
``page_size`` generated tokens) and returned to the free list on
eviction.  Memory therefore scales with ``sum_i ceil(len_i/page_size)``
instead of ``n_slots * max_seq``.  Pages are refcounted so that shared
pages cost the pool once.

Admission uses a *reservation* discipline so decode can never stall on
an empty pool: a request is only admitted when its worst-case lifetime
page count (``ceil((prompt + max_new - 1)/page_size)``) can be reserved
up front.  Pages are still allocated lazily against that reservation,
and any unused reservation is released on eviction.

Page id 0 is a scratch page: inactive slots (and unused block-table
entries) point at it, so their dummy decode writes land somewhere no
live sequence ever reads.  The allocator hands out ids ``1..n_pages``.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List

SCRATCH_PAGE = 0


def pages_for(n_positions: int, page_size: int) -> int:
    """Number of pages covering ``n_positions`` cache positions."""
    return max(0, -(-n_positions // page_size))


def default_pool_pages(n_slots: int, max_seq: int, page_size: int,
                       frac: float = 0.75) -> int:
    """Default pool sizing: ``frac`` of the contiguous layout's
    ``n_slots * max_seq`` positions, but never smaller than one
    worst-case request (``ceil(max_seq/page_size)`` pages) so any
    request the engine accepts can always eventually be admitted."""
    budget = pages_for(int(frac * n_slots * max_seq), page_size)
    return max(pages_for(max_seq, page_size), budget)


class PoolExhausted(RuntimeError):
    """Raised on an allocation the reservation discipline should have
    made impossible (internal invariant violation)."""


class BlockAllocator:
    """Free-list allocator over ``n_pages`` KV pages (ids 1..n_pages;
    id 0 is the scratch page and is never handed out).

    Pages are REFCOUNTED: ``alloc`` hands a page out with one
    reference, ``share`` adds holders (prefix sharing — several block
    tables pointing at the same immutable prompt page), and ``release``
    drops one reference per listed id.  A page returns to the free list
    only when its refcount reaches zero, so ``in_use`` counts DISTINCT
    live pages (``len(_free) == n_pages - in_use`` always holds) while
    shared pages cost the pool — and the reservation ledger — only
    once."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free: Deque[int] = collections.deque(range(1, n_pages + 1))
        self._free_set = set(self._free)   # double-release detection
        self._refcount: Dict[int, int] = {}   # live page -> holders
        self.reserved = 0                  # promised but not yet allocated
        self.in_use = 0
        self.peak_in_use = 0
        self.peak_committed = 0            # in_use + outstanding reservation

    # -- reservation (admission control) -----------------------------------
    def available(self) -> int:
        """Pages free AND not spoken for by an existing reservation."""
        return len(self._free) - self.reserved

    def can_reserve(self, n: int) -> bool:
        return self.available() >= n

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise PoolExhausted(
                f"cannot reserve {n} pages ({self.available()} available)")
        self.reserved += n
        self.peak_committed = max(self.peak_committed,
                                  self.in_use + self.reserved)

    # -- allocation (always against a prior reservation) -------------------
    def alloc(self, n: int = 1) -> List[int]:
        if n > self.reserved or n > len(self._free):
            raise PoolExhausted(
                f"alloc({n}) exceeds reservation {self.reserved} / "
                f"free {len(self._free)}")
        ids = [self._free.popleft() for _ in range(n)]
        self._free_set.difference_update(ids)
        for i in ids:
            self._refcount[i] = 1
        self.reserved -= n
        self.in_use += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    # -- sharing (prefix cache) ---------------------------------------------
    def share(self, ids: List[int]) -> None:
        """Add one holder to each live page in ``ids`` (a block table —
        or the prefix index — attaching cached pages by reference).
        Consumes no reservation: the pages are already in use, and the
        new holder's ``release`` merely drops its reference."""
        for i in ids:
            if not 1 <= i <= self.n_pages or i in self._free_set:
                raise PoolExhausted(f"share of invalid/free page {i}")
        for i in ids:
            self._refcount[i] += 1

    def refcount(self, i: int) -> int:
        """Current holders of page ``i`` (0 when free)."""
        return self._refcount.get(i, 0)

    def n_live_refs(self) -> int:
        """Total outstanding references across all live pages — 0 iff
        every holder released everything (the drain gate)."""
        return sum(self._refcount.values())

    def release(self, ids: List[int], unreserve: int = 0) -> None:
        """Drop one reference per page in ``ids``; pages reaching
        refcount zero return to the free list.  ``unreserve`` drops that
        many pages of never-allocated reservation (eviction before
        max_new)."""
        freed = []
        for i in ids:
            if not 1 <= i <= self.n_pages or i in self._free_set:
                # a double-released page would later be handed to two
                # live sequences — silent KV corruption, so fail loudly
                raise PoolExhausted(f"release of invalid/free page {i}")
            rc = self._refcount[i] - 1
            if rc:
                self._refcount[i] = rc
            else:
                del self._refcount[i]
                freed.append(i)
                self._free.append(i)
                self._free_set.add(i)
        self.in_use -= len(freed)
        self.reserved -= unreserve
        if self.in_use < 0 or self.reserved < 0:
            raise PoolExhausted(
                f"accounting went negative (in_use={self.in_use}, "
                f"reserved={self.reserved}) — over-release or bad unreserve")

    # -- stats --------------------------------------------------------------
    def utilization(self) -> float:
        """Peak fraction of the pool ever holding live KV."""
        return self.peak_in_use / self.n_pages
