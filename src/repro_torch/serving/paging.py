"""Paged KV-cache bookkeeping for the continuous engine: the twin of the
JAX package's ``serving/paging.py`` (allocator, prefix index and KV-delta
spill store).

A ``BlockAllocator`` owns a global pool of fixed-size KV pages.  Each
active sequence holds a growable block table (list of page ids); pages
are handed out as prompt chunks land and during decode (one page every
``page_size`` generated tokens) and returned to the free list on
eviction.  Memory therefore scales with ``sum_i ceil(len_i/page_size)``
instead of ``n_slots * max_seq``.

Pages are refcounted so immutable prompt pages can be SHARED: a
``PagePrefixIndex`` (radix trie keyed on page-granular token runs)
maps full prompt pages to page ids, letting sequences with a common
prefix attach cache-hit pages by reference instead of recomputing
them; the first write into a shared page forks a private copy
(copy-on-write, in ``serving.engine.PagedSlotManager``).

Admission uses a *reservation* discipline so decode can never stall on
an empty pool: a request is only admitted when its worst-case lifetime
page count (``ceil((prompt + max_new - 1)/page_size)``) can be reserved
up front.  Pages are still allocated lazily against that reservation,
and any unused reservation is released on eviction.

Page id 0 is a scratch page: inactive slots (and unused block-table
entries) point at it, so their dummy decode writes land somewhere no
live sequence ever reads.  The allocator hands out ids ``1..n_pages``.

``DeltaSpillStore`` keeps spilled sequences' KV on the host (CPU
tensors) across preemption epochs; its leaf order, byte counts and CRC32
values are the reference store's, bf16 included.
"""
from __future__ import annotations

import collections
import zlib
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

try:                                   # optional, as in the reference
    import zstandard as zstd
except ImportError:                    # pragma: no cover - env dependent
    zstd = None

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


class SpillCorruption(RuntimeError):
    """A spill record failed its checksum: the host copy cannot be
    trusted and must never be grafted back into paged KV.  The caller
    redoes the sequence from prefill instead."""


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


def per_device_pool_stats(allocator: BlockAllocator, *, n_shards: int,
                          kv_bytes_per_device: int) -> dict:
    """Per-device ledger view of a head-sharded paged pool.

    The mesh cuts only the KV-head (or MLA latent-rank) axis of the pool
    leaves, never the layer, page or offset axes, so every rank holds
    the SAME page ids and the global :class:`BlockAllocator` ledger is
    every rank's: per-device page counts EQUAL the global counts while
    bytes scale down by the head shard.  ``kv_bytes_per_device *
    n_shards`` equals the global bytes when every leaf's cut divides,
    and exceeds them when a leaf replicates."""
    return {
        "n_kv_shards": n_shards,
        "kv_bytes_per_device": kv_bytes_per_device,
        "pages_in_use_per_device": allocator.in_use,
        "peak_pages_in_use_per_device": allocator.peak_in_use,
    }


# ==========================================================================
# prefix sharing: radix index over full prompt pages
# ==========================================================================

class PagePrefixIndex:
    """Radix (trie) index mapping FULL prompt pages to pooled page ids.

    Level ``d`` of the trie is keyed by the tuple of token ids filling
    prompt page ``d``, so a lookup walks a prompt page-by-page and
    returns the longest run of leading pages whose KV is already
    resident in the pool.  Only IMMUTABLE pages are ever indexed —
    pages fully covered by a prompt (decode never writes into them),
    registered when their sequence finishes prefill.

    The index holds ONE allocator reference per indexed page (via
    ``BlockAllocator.share``), so cached pages survive the sequences
    that produced them; each attaching sequence adds its own reference
    and a page only frees once the index AND every sequence released
    it.  ``reclaimable``/``evict`` let admission reclaim index-only
    pages (refcount 1) leaf-first when the pool runs dry — evicting a
    leaf can cascade to its (now-leaf) ancestors, never the other way,
    so the trie's prefix property is preserved.  ``clear`` drops every
    index reference (the benchmark's refcount-drain gate)."""

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # node: key (page-token tuple) -> [page_id, children, lru_stamp]
        self._root: Dict[tuple, list] = {}
        self._clock = 0
        self.n_pages = 0            # pages currently holding an index ref
        self.hits = 0               # admissions that attached >= 1 page
        self.misses = 0
        self.pages_attached = 0     # pages attached by reference, total
        self.pages_evicted = 0

    def _keys(self, tokens) -> List[tuple]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[d * ps:(d + 1) * ps])
                for d in range(len(tokens) // ps)]

    def match(self, tokens) -> List[int]:
        """Page ids of the longest indexed run of ``tokens``'s leading
        full pages.  Read-only: takes no references — the caller
        attaches via ``BlockAllocator.share``."""
        self._clock += 1
        node, out = self._root, []
        for key in self._keys(tokens):
            ent = node.get(key)
            if ent is None:
                break
            ent[2] = self._clock
            out.append(ent[0])
            node = ent[1]
        return out

    def note_attach(self, n_pages: int) -> None:
        """Hit/miss accounting for one admission lookup."""
        if n_pages:
            self.hits += 1
            self.pages_attached += n_pages
        else:
            self.misses += 1

    def insert(self, tokens, pages: List[int]) -> int:
        """Index the leading full pages of ``tokens`` (their KV living
        in ``pages``).  Already-indexed prefixes keep their existing
        page (first writer wins — both copies are bit-identical, built
        from the same token prefix).  Takes one index reference per
        NEWLY indexed page; returns how many were new."""
        self._clock += 1
        node, added = self._root, 0
        for d, key in enumerate(self._keys(tokens)):
            ent = node.get(key)
            if ent is None:
                self.allocator.share([pages[d]])
                ent = node[key] = [pages[d], {}, self._clock]
                self.n_pages += 1
                added += 1
            else:
                ent[2] = self._clock
            node = ent[1]
        return added

    def reclaimable(self, keep=()) -> int:
        """Pages a cascade of leaf evictions could free right now:
        index-only pages (refcount 1) whose whole subtree is likewise
        evictable.  Pages in ``keep`` (an admission's own hit, which it
        attaches before evicting) count as held."""
        keep = set(keep)

        def count(node) -> tuple:
            n, full = 0, True
            for ent in node.values():
                sub_n, sub_full = count(ent[1])
                n += sub_n
                ok = (sub_full and ent[0] not in keep
                      and self.allocator.refcount(ent[0]) == 1)
                n += int(ok)
                full = full and ok
            return n, full
        return count(self._root)[0]

    def _evictable_leaves(self) -> List[tuple]:
        """(lru_stamp, page_id, key, parent) for every leaf node whose
        page only the index still references."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            for key, ent in node.items():
                if ent[1]:
                    stack.append(ent[1])
                elif self.allocator.refcount(ent[0]) == 1:
                    out.append((ent[2], ent[0], key, node))
        return out

    def evict(self, n: int) -> int:
        """Free up to ``n`` index-only pages, least-recently-used leaf
        first (an emptied parent becomes evictable next round); returns
        how many were actually freed."""
        freed = 0
        while freed < n:
            cands = sorted(self._evictable_leaves(), key=lambda c: c[:2])
            if not cands:
                break
            for _, page, key, parent in cands[:n - freed]:
                del parent[key]
                self.allocator.release([page])
                self.n_pages -= 1
                self.pages_evicted += 1
                freed += 1
        return freed

    def clear(self) -> None:
        """Drop every index reference (end-of-run drain)."""
        def drop(node):
            for ent in node.values():
                drop(ent[1])
                self.allocator.release([ent[0]])
            node.clear()
        drop(self._root)
        self.n_pages = 0

    def stats(self) -> dict:
        return {
            "prefix_index_pages": self.n_pages,
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_pages_attached": self.pages_attached,
            "prefix_pages_evicted": self.pages_evicted,
        }


# ==========================================================================
# KV-delta spill store
# ==========================================================================

def _host_bytes(t: torch.Tensor) -> memoryview:
    """The contiguous little-endian bytes of a CPU tensor (bf16 by its
    16-bit pattern): what the reference hashes and compresses."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


@dataclass
class SpillRecord:
    """Host-side spill state of one sequence across preemption epochs."""
    kv: object                  # prefix-shaped tree, leaves (L,1,n*ps,...)
    #                             or its packed form under a codec:
    #                             (template, [(blob, dtype, shape), ...])
    synced_pages: int           # pages of ``kv`` merged so far
    epoch: int = 0              # spills merged into this record
    nbytes: int = 0             # bytes held on the host (compressed under
    #                             a codec)
    crc: int = 0                # CRC32 over the packed record bytes,
    #                             computed at merge, verified on every read


class DeltaSpillStore:
    """Host store for spilled KV with per-sequence delta merging.

    A sequence's first spill ships its whole live page set; every later
    spill ships only the pages dirtied since (the block table's
    ``synced_pages`` watermark).  ``merge`` reassembles base + delta into
    the full prefix-shaped snapshot a resume grafts back, and meters
    actual against full-spill bytes.  Records persist across resumes and
    are dropped when the sequence finishes.

    ``codec="zstd"`` (needs ``zstandard``) keeps entries compressed.
    ``max_entries`` / ``max_bytes`` evict least-recently-spilled records
    (never the one just written); ``take_evicted`` hands their rids to
    the scheduler, which redoes them from prefill.

    INTEGRITY: every record carries a CRC32 over its packed host bytes
    (the compressed blobs under a codec), verified on every read
    (``snapshot``, the base inside ``merge``) and audited at ``drop`` and
    eviction.  A mismatch discards the record, counts a detection and,
    on the read paths, raises :class:`SpillCorruption`.  An optional
    ``core.faults.FaultInjector`` flips a byte in every k-th merged
    record.
    """

    def __init__(self, page_size: int, *, codec: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 injector=None):
        if codec not in (None, "zstd"):
            raise ValueError(f"unknown spill codec {codec!r}")
        if codec == "zstd" and zstd is None:
            raise RuntimeError(
                "spill codec 'zstd' requested but the 'zstandard' package "
                "is not installed — install it or pass codec=None")
        self.page_size = page_size
        self.codec = codec
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.injector = injector
        self._by_rid: Dict[int, SpillRecord] = {}   # insertion order: LRU
        self._evicted: List[int] = []
        self.stored_bytes = 0       # live host bytes (compressed if codec)
        self.n_corruptions_detected = 0
        self.n_evictions = 0
        self.n_spills = 0
        self.n_delta_spills = 0     # spills that shipped < the live set
        self.bytes_spilled = 0      # actually shipped (delta) bytes
        self.bytes_compressed = 0   # same deltas after the codec (0 w/o)
        self.bytes_full_equiv = 0   # what full spills would have shipped

    def __contains__(self, rid: int) -> bool:
        return rid in self._by_rid

    def __len__(self) -> int:
        return len(self._by_rid)

    def record(self, rid: int) -> Optional[SpillRecord]:
        return self._by_rid.get(rid)

    def snapshot(self, rid: int):
        """The full prefix-shaped KV snapshot of ``rid``'s record (the
        only host copy of a store-managed spill).  Raises
        :class:`SpillCorruption` (and discards the record) if its bytes
        no longer match their merge-time checksum."""
        rec = self._by_rid[rid]
        if self._crc(rec.kv) != rec.crc:
            self._discard_corrupt(rid)
            raise SpillCorruption(
                f"spill record for rid {rid} failed its checksum at "
                f"snapshot (epoch {rec.epoch})")
        return self._unpack(rec.kv)

    def synced_pages(self, rid: int) -> int:
        rec = self._by_rid.get(rid)
        return rec.synced_pages if rec is not None else 0

    # -- integrity -----------------------------------------------------------
    def _crc(self, kv) -> int:
        c = 0
        if self.codec is None:
            for t in tree_leaves(kv):
                c = zlib.crc32(_host_bytes(t), c)
        else:
            for blob, _, _ in kv[1]:
                c = zlib.crc32(blob, c)
        return c

    def _discard_corrupt(self, rid: int) -> None:
        rec = self._by_rid.pop(rid)
        self.stored_bytes -= rec.nbytes
        self.n_corruptions_detected += 1

    def _maybe_inject(self, rid: int) -> None:
        """Fault hook: flip one byte of the freshly merged record (in a
        copy: ``merge``'s return value aliases it) without touching its
        checksum, as at-rest host corruption the next read must catch."""
        if self.injector is None or not self.injector.spill_corruption_due():
            return
        rec = self._by_rid[rid]
        if self.codec is None:
            leaves = tree_leaves(rec.kv)
            i = next(j for j, t in enumerate(leaves) if t.numel() > 0)
            a = leaves[i].clone()
            raw = a.view(-1).view(torch.uint8)
            raw[self.injector.corrupt_offset(raw.numel())] ^= 0x01
            leaves[i] = a
            rec.kv = tree_unflatten(rec.kv, leaves)
        else:
            template, packed = rec.kv
            blob, dt, shape = packed[0]
            buf = bytearray(blob)
            buf[self.injector.corrupt_offset(len(buf))] ^= 0x01
            rec.kv = (template, [(bytes(buf), dt, shape)] + packed[1:])

    # -- codec --------------------------------------------------------------
    def _pack(self, tree):
        """(packed_kv, host_bytes); identity without a codec."""
        if self.codec is None:
            return tree, _nbytes(tree)
        cctx = zstd.ZstdCompressor(level=3)
        packed = [(cctx.compress(_host_bytes(t)), t.dtype, tuple(t.shape))
                  for t in tree_leaves(tree)]
        return (tree_map(lambda t: None, tree), packed), \
            sum(len(b) for b, _, _ in packed)

    def _unpack(self, kv):
        if self.codec is None:
            return kv
        template, packed = kv
        dctx = zstd.ZstdDecompressor()
        leaves = []
        for blob, dt, shape in packed:
            raw = bytearray(dctx.decompress(blob))
            view = torch.int16 if dt == torch.bfloat16 else dt
            leaves.append(torch.frombuffer(raw, dtype=view).view(dt)
                          .reshape(shape) if raw else
                          torch.empty(shape, dtype=dt))
        return tree_unflatten(template, leaves)

    # -- LRU eviction --------------------------------------------------------
    def _evict_over_caps(self, keep: int) -> None:
        def over() -> bool:
            return ((self.max_entries is not None
                     and len(self._by_rid) > self.max_entries)
                    or (self.max_bytes is not None
                        and self.stored_bytes > self.max_bytes))
        # merge() re-inserts, so the head is the least recently spilled
        while over() and len(self._by_rid) > 1:
            rid = next(iter(self._by_rid))
            if rid == keep:
                break                  # never evict the record just written
            rec = self._by_rid.pop(rid)
            self.stored_bytes -= rec.nbytes
            self.n_evictions += 1
            if self._crc(rec.kv) != rec.crc:
                self.n_corruptions_detected += 1    # exit audit
            self._evicted.append(rid)

    def take_evicted(self) -> List[int]:
        """Evicted rids since the last call (the scheduler's redo hook)."""
        out, self._evicted = self._evicted, []
        return out

    def merge(self, rid: int, delta, synced: int, total_pages: int):
        """Merge ``delta`` (pages [synced, total_pages) of the live block
        table, prefix-shaped, or None when nothing was dirtied) into the
        sequence's record and return the full reassembled snapshot."""
        ps = self.page_size
        rec = self._by_rid.get(rid)
        if rec is not None and self._crc(rec.kv) != rec.crc:
            self._discard_corrupt(rid)
            raise SpillCorruption(
                f"spill record for rid {rid} failed its checksum at merge "
                f"(epoch {rec.epoch}) — base unusable, re-spill full")
        base = self._unpack(rec.kv) if rec is not None else None
        if rec is None or synced == 0:
            if delta is None or synced != 0:
                raise RuntimeError(
                    f"spill of rid {rid}: no base record yet its delta "
                    f"starts at page {synced} — stale synced watermark")
            merged = delta
        elif delta is None:                      # re-spill, no new pages
            if synced != total_pages:
                raise RuntimeError(
                    f"spill of rid {rid}: empty delta but only {synced} of "
                    f"{total_pages} pages are synced")
            merged = base
        else:
            merged = tree_map(
                lambda b, d: torch.cat([b[:, :, :synced * ps], d], dim=2),
                base, delta)
        delta_bytes = _nbytes(delta) if delta is not None else 0
        full_bytes = _nbytes(merged)
        self.n_spills += 1
        self.n_delta_spills += int(delta_bytes < full_bytes)
        self.bytes_spilled += delta_bytes
        self.bytes_full_equiv += full_bytes
        if rec is not None:
            self.stored_bytes -= rec.nbytes
            del self._by_rid[rid]                # re-insert at the MRU end
        kv, nbytes = self._pack(merged)
        if self.codec is not None and delta is not None:
            self.bytes_compressed += (nbytes if merged is delta
                                      else self._pack(delta)[1])
        self._by_rid[rid] = SpillRecord(kv=kv, synced_pages=total_pages,
                                        epoch=(rec.epoch + 1) if rec else 1,
                                        nbytes=nbytes, crc=self._crc(kv))
        self.stored_bytes += nbytes
        self._evict_over_caps(keep=rid)
        self._maybe_inject(rid)
        return merged

    def drop(self, rid: int) -> None:
        rec = self._by_rid.pop(rid, None)
        if rec is not None:
            self.stored_bytes -= rec.nbytes
            if self._crc(rec.kv) != rec.crc:
                self.n_corruptions_detected += 1    # exit audit

    @staticmethod
    def empty_stats() -> dict:
        """The all-zero stats schema that ``stats()`` fills."""
        return {
            "n_delta_spills": 0,
            "spill_bytes": 0,
            "spill_bytes_full_equiv": 0,
            "spill_bytes_compressed": 0,
            "n_store_evictions": 0,
            "n_spill_corruptions_detected": 0,
            "spill_store_entries": 0,
            "spill_store_bytes": 0,
        }

    def stats(self) -> dict:
        out = self.empty_stats()
        out.update(
            n_delta_spills=self.n_delta_spills,
            spill_bytes=self.bytes_spilled,
            spill_bytes_full_equiv=self.bytes_full_equiv,
            spill_bytes_compressed=self.bytes_compressed,
            n_store_evictions=self.n_evictions,
            n_spill_corruptions_detected=self.n_corruptions_detected,
            spill_store_entries=len(self._by_rid),
            spill_store_bytes=self.stored_bytes,
        )
        return out

    # -- checkpoint bookkeeping ---------------------------------------------
    # Records re-materialize as swap-entry snapshots after a restore; only
    # the cumulative counters travel through a checkpoint.
    _COUNTER_KEYS = ("n_evictions", "n_spills", "n_delta_spills",
                     "bytes_spilled", "bytes_compressed", "bytes_full_equiv",
                     "n_corruptions_detected")

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in self._COUNTER_KEYS}

    def load_counters(self, d: dict) -> None:
        for k in self._COUNTER_KEYS:
            setattr(self, k, d[k])
