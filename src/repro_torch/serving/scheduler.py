"""Contact-window preemptive scheduling on the continuous engine: the
twin of the JAX package's ``serving/scheduler.py``.

The paper's setting (section II): onboard compute must yield to
downlink work whenever a ground-station pass opens, and the downlink is
only available during those passes.  A live sequence is just (slot
state, block table, KV pages), so yielding is cheap:

  * ``PreemptiveScheduler`` — a priority scheduler over ONE
    ``ContinuousEngine``.  ``preempt(slot)`` moves the slot's state
    into a swap ledger and frees the slot; the KV either stays resident
    (pages stay committed in the pool) or spills to the host
    (``extract_paged_cache`` into a ``DeltaSpillStore`` record, pages
    released for waiting requests).  ``resume()`` re-places the
    sequence token-exactly: a spilled snapshot is grafted back through
    ``graft_paged_cache`` into freshly allocated pages, a whole number
    of pages, so the round trip is bit-exact.  Higher
    ``Request.priority`` arrivals may preempt lower-priority sequences;
    swapped sequences resume highest-priority-first.  ``checkpoint`` /
    ``restore`` write and read the whole serving state in the JAX
    package's ``.ckpt`` layout (the same meta keys and ``kv/{rid}/{i}``
    leaves), so a checkpoint written by either package restores in the
    other.
  * ``SpaceGroundScheduler`` — drives a (satellite, ground) engine pair
    (``configs/tiansuan_pair``) against ``ContactSchedule`` windows: an
    overlapped transmit lane (``core.link.TransmitLane``, framed ARQ
    when ``frame_bytes`` is set) beside satellite decode, the
    ``ConfidenceGate`` deciding which finished sequences escalate to the
    ground tier (raw prompt, or with ``speculative`` only the draft
    token ids, which the ground engine verifies in chunked passes),
    periodic checkpoints, a ``core.faults.FaultInjector`` and reboot
    through ``ContinuousEngine.clone_fresh`` + ``restore``.

On CUDA engines the gate runs the hand-written gate kernel once per
classified sequence (its logits are moved to the satellite engine's
device first), and every decode token of either tier runs the paged
decode kernel.  Both schedulers are deterministic: same trace + same
windows => same tokens, preemption points and ledger.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import load_checkpoint_raw, save_checkpoint
from repro_torch.core.energy import EnergyModel
from repro_torch.core.faults import FaultInjector
from repro_torch.core.gating import ConfidenceGate
from repro_torch.core.link import ContactSchedule, TransmitLane, \
    payload_bytes_draft, payload_bytes_raw, payload_bytes_result
from repro_torch.core.telemetry import Ledger
from repro_torch.serving.batching import Request, ensure_rid_floor
from repro_torch.serving.engine import ContinuousEngine, RequestResult, \
    _PagedSlotState, _SlotState
from repro_torch.serving.paging import DeltaSpillStore, SpillCorruption
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclass
class SwapEntry:
    """One preempted sequence in the swap ledger."""
    state: object                       # the engine's detached _SlotState
    kv: Optional[dict]                  # host KV snapshot; None when the
    #                                     swap is resident, when the spill
    #                                     lives in the DeltaSpillStore (the
    #                                     store's record is the ONLY host
    #                                     copy), or when a PREFILLING
    #                                     sequence had no pages yet
    preempted_step: int                 # engine clock at preemption
    spilled: bool = True                # pages released (resume re-reserves)

    @property
    def rid(self) -> int:
        return self.state.request.rid

    @property
    def priority(self) -> int:
        return self.state.request.priority


class PreemptiveScheduler:
    """Preempt-and-resume scheduling over one ``ContinuousEngine``.

    preempt_mode: "spill" (default) releases the sequence's pages to
    the pool so waiting requests can claim them; "resident" keeps pages
    committed for a zero-copy resume (right when the pool is
    uncontended and the pause is short).  Either way resume is
    token-exact — the resident path never moves KV, the spill path
    round-trips whole pages through ``extract_paged_cache`` /
    ``graft_paged_cache`` (contiguous layout: the full cache row).
    """

    def __init__(self, engine: ContinuousEngine, *,
                 preempt_mode: str = "spill", delta_spill: bool = True,
                 spill_codec: Optional[str] = None,
                 spill_max_entries: Optional[int] = None,
                 spill_max_bytes: Optional[int] = None,
                 fault_injector: Optional[FaultInjector] = None):
        if preempt_mode not in ("spill", "resident"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        self.engine = engine
        self.preempt_mode = preempt_mode
        # KV-delta spills (paged layout only): the host store keeps each
        # spilled sequence's snapshot across resumes, so a re-preemption
        # ships only the pages dirtied since — the block table's
        # ``synced_pages`` watermark — instead of the whole live set.
        # spill_codec="zstd" compresses host entries (optional dep);
        # spill_max_entries/_bytes cap the store with LRU eviction —
        # an evicted, still-swapped sequence redoes from prefill.
        self.store: Optional[DeltaSpillStore] = (
            DeltaSpillStore(engine.slots.page_size, codec=spill_codec,
                            max_entries=spill_max_entries,
                            max_bytes=spill_max_bytes,
                            injector=fault_injector)
            if delta_spill and hasattr(engine.slots, "allocator") else None)
        self.held_pages = 0             # transmit-lane page hold (overlap)
        self.swapped: Dict[int, SwapEntry] = {}      # rid -> entry
        self.n_preemptions = 0
        self.n_spills = 0
        self.n_resumes = 0
        self.n_redo_from_prefill = 0    # swap entries lost to store eviction
        self.n_redo_from_corruption = 0  # swap entries lost to a failed
        #                                  spill-record checksum
        self.swapped_steps = 0          # total clock ticks spent swapped out
        self.resume_s: List[float] = [] # wall seconds per restore

    # -- delegation ---------------------------------------------------------
    @property
    def clock(self) -> int:
        return self.engine.clock

    @property
    def results(self) -> Dict[int, RequestResult]:
        return self.engine.results

    def submit(self, req: Request) -> int:
        return self.engine.submit(req)

    def has_work(self) -> bool:
        return bool(len(self.engine.queue) or self.engine.slots.any_active()
                    or self.swapped)

    # -- preemption ---------------------------------------------------------
    def preempt(self, slot: int, mode: Optional[str] = None) -> int:
        """Swap the sequence in ``slot`` out; returns its rid.  The slot
        is free afterwards, and under "spill" its KV pages are back in
        the pool for waiting requests."""
        mode = mode or self.preempt_mode
        slots = self.engine.slots
        if not hasattr(slots, "allocator"):
            mode = "spill"       # contiguous rows have no resident identity:
            #                      the slot may be regrafted while swapped
        st0 = slots.states[slot]
        if st0 is None:
            raise RuntimeError(f"preempt of empty slot {slot}")
        kv = None
        if mode == "spill":
            shared = getattr(st0, "shared_pages", 0)
            if not hasattr(slots, "allocator"):
                kv = slots.snapshot(slot)          # contiguous: full row
            elif len(st0.pages) > shared:
                # shared-prefix pages stay pinned in the pool (the swap
                # entry keeps its refs), so only the private tail is
                # spilled — store records live in PRIVATE page
                # coordinates (page 0 of a record == first page past
                # the shared prefix)
                if self.store is not None:
                    # the store's record IS the host copy — the swap
                    # entry carries no duplicate snapshot, so the
                    # codec/caps really bound host spill memory
                    synced = max(st0.synced_pages, shared)
                    delta = slots.snapshot(slot, since=synced)
                    try:
                        self.store.merge(st0.request.rid, delta,
                                         synced - shared,
                                         len(st0.pages) - shared)
                    except SpillCorruption:
                        # the base record failed its checksum (the store
                        # discarded it) — but every live page is still
                        # on device, so re-ship the FULL private set as
                        # a fresh record instead of grafting garbage
                        full = slots.snapshot(slot, since=shared)
                        self.store.merge(st0.request.rid, full, 0,
                                         len(st0.pages) - shared)
                else:
                    kv = slots.snapshot(slot, since=shared)
            # else: PREFILLING with no chunk landed yet — nothing to
            # snapshot; the re-placed state redoes its chunks on resume
        st = slots.detach(slot, release_pages=mode == "spill")
        st.n_preemptions += 1
        self.swapped[st.request.rid] = SwapEntry(
            state=st, kv=kv, preempted_step=self.engine.clock,
            spilled=mode == "spill")
        self.n_preemptions += 1
        self.n_spills += int(mode == "spill")
        self._drain_store_evictions()
        return st.request.rid

    def preempt_all(self, mode: Optional[str] = None) -> List[int]:
        """Yield every active slot — the contact-window entry point."""
        return [self.preempt(s, mode) for s in self.engine.slots.active_slots()]

    def _drain_store_evictions(self) -> None:
        """A spill-store eviction invalidates its rid's host snapshot
        lineage.  If that sequence is still swapped out spilled, the
        evicted record WAS its KV — drop the swap entry and redo the
        request from prefill (progress is discarded; greedy decode makes
        the redo token-exact).  A rid that already resumed (or swapped
        resident) merely loses delta eligibility: its live watermark is
        reset so its next spill ships the full live set again."""
        if self.store is None:
            return
        for rid in self.store.take_evicted():
            e = self.swapped.get(rid)
            if e is not None and e.spilled:
                del self.swapped[rid]
                # drop any shared-prefix refs the swap entry pinned —
                # the redo re-attaches them through the index
                self.engine.slots.discard_detached(e.state)
                self.engine.queue.requeue_front(e.state.request)
                self.n_redo_from_prefill += 1
                continue
            # still live (active slot or resident swap): pages [0,
            # synced) no longer have a host copy, so a stale watermark
            # would make the next spill a partial snapshot
            st = (e.state if e is not None else
                  next((s for s in self.engine.slots.states
                        if s is not None and s.request.rid == rid), None))
            if st is not None:
                # shared-prefix pages never ship, so the watermark
                # floors at the shared boundary, not 0
                st.synced_pages = getattr(st, "shared_pages", 0)

    def _redo_corrupt(self, entry: SwapEntry) -> None:
        """A spill record failed its checksum: the host copy is gone and
        was the ONLY copy, so the request redoes from prefill — the same
        recovery lane as a store eviction (greedy decode keeps the redo
        token-exact), never a garbage graft."""
        self.engine.slots.discard_detached(entry.state)
        self.engine.queue.requeue_front(entry.state.request)
        self.n_redo_from_corruption += 1

    def resume(self, rid: int, slot: int) -> None:
        """Re-place a swapped sequence into a free slot, token-exactly.
        If the sequence's spill record fails its integrity check the
        resume turns into a redo-from-prefill (the slot stays free)."""
        entry = self.swapped.pop(rid)
        t0 = time.perf_counter()
        kv = entry.kv
        from_store = (entry.spilled and kv is None and self.store is not None
                      and rid in self.store)
        if from_store:
            try:
                kv = self.store.snapshot(rid)
            except SpillCorruption:
                self._redo_corrupt(entry)
                return
        self.engine.slots.restore(slot, entry.state, kv,
                                  spilled=entry.spilled)
        if from_store:
            # every restored page now matches the host store's copy:
            # raise the watermark so the NEXT spill ships only pages
            # dirtied from here on (decode lowers it again per write)
            entry.state.synced_pages = len(entry.state.pages)
        self.resume_s.append(time.perf_counter() - t0)
        self.n_resumes += 1
        self.swapped_steps += self.engine.clock - entry.preempted_step

    # -- transmit-lane page hold (overlapped contact pipeline) ---------------
    def hold_pages(self, n: int) -> int:
        """Reserve ``n`` pool pages for a contact window's transmit lane
        (downlink staging buffers), spilling active sequences — lowest
        priority first, then the largest block table, so the fewest
        victims free the most pages — until the hold fits.  Everything
        not spilled keeps decoding through the pass; the spilled victims
        resume (token-exactly, via their delta snapshots) once
        ``release_hold`` returns the pages at window close.  Holds what
        is actually attainable and returns the total held; idempotent
        across the in-window ticks of one pass."""
        slots = self.engine.slots
        alloc = getattr(slots, "allocator", None)
        if alloc is None or n <= 0:
            return 0
        need = min(n, alloc.n_pages) - self.held_pages
        if need <= 0:
            return self.held_pages
        while alloc.available() < need and slots.any_active():
            # spilling a victim only returns its PRIVATE pages (shared
            # prefix refs stay pinned), so rank by reclaimable pages
            victims = sorted(
                slots.active_slots(),
                key=lambda s: (slots.states[s].request.priority,
                               -(len(slots.states[s].pages)
                                 - getattr(slots.states[s], "shared_pages",
                                           0)),
                               -slots.states[s].request.arrival_t,
                               slots.states[s].request.rid))
            self.preempt(victims[0], "spill")
        take = min(need, alloc.available())
        if take > 0:
            alloc.reserve(take)
            self.held_pages += take
        return self.held_pages

    def release_hold(self) -> None:
        """Return the transmit lane's page hold to the pool (window
        close) — spilled victims become resumable again."""
        if self.held_pages:
            self.engine.slots.allocator.release([],
                                                unreserve=self.held_pages)
            self.held_pages = 0

    # -- the scheduling loop -------------------------------------------------
    def _resume_order(self) -> List[SwapEntry]:
        return sorted(self.swapped.values(),
                      key=lambda e: (-e.priority, e.preempted_step, e.rid))

    def _arrived(self) -> List[Request]:
        return self.engine.queue.arrived(self.engine.clock)

    def _budget_pages(self, req: Request) -> int:
        slots = self.engine.slots
        if hasattr(slots, "_lifetime_pages"):
            return slots._lifetime_pages(req)
        return 0                               # contiguous: slots only

    def _fill_free_slots(self) -> None:
        """Fill free slots highest-priority-first: swapped sequences
        (they hold progress) compete with arrived queue entries; ties go
        to the earlier preemption/arrival.  Both lists keep a
        head-of-line discipline so a large request cannot be starved by
        a stream of smaller later ones: only the queue head (in priority
        order) is ever considered, and a spilled swap head whose pages
        are not yet reservable blocks later SPILLED entries (resident
        entries may still skip ahead — resuming them consumes no pages,
        so they cannot starve the head)."""
        slots = self.engine.slots
        for slot in slots.free_slots():
            cands: List[Tuple[tuple, str, object]] = []
            blocked_prio: Optional[int] = None
            for e in self._resume_order():
                if not slots.can_restore(e.state, e.spilled):
                    if blocked_prio is None:   # only spilled entries fail
                        blocked_prio = e.priority
                    continue
                if e.spilled and blocked_prio is not None:
                    continue                   # don't steal the head's pages
                cands.append(((-e.priority, e.preempted_step, e.rid),
                              "swap", e))
                break
            arrived = sorted(self._arrived(),
                             key=lambda r: (-r.priority, r.arrival_t, r.rid))
            if arrived and slots.can_admit(arrived[0]):
                r = arrived[0]
                # a blocked swap head also vetoes page-consuming queue
                # admissions of its own (or lower) priority — the swapped
                # sequence holds progress and must not be starved by a
                # steady stream of fresh arrivals
                if blocked_prio is None or r.priority > blocked_prio:
                    cands.append(((-r.priority, r.arrival_t, r.rid),
                                  "queue", r))
            if not cands:
                break
            _, kind, obj = min(cands)
            if kind == "swap":
                self.resume(obj.rid, slot)
            else:
                self.engine._admit(self.engine.queue.take(obj), slot)

    def _best_blocked(self) -> Optional[Tuple[Request, int]]:
        """Highest-priority waiting work that cannot be placed right now
        (no free slot, or — paged — not enough reservable pages), with
        the page count a placement would actually consume: the full
        lifetime budget for queue/spilled entries, zero for resident
        entries (their pages are still committed — only a slot is
        missing)."""
        slots = self.engine.slots
        free = bool(slots.free_slots())
        out: List[Tuple[tuple, Request, int]] = []
        for e in self.swapped.values():
            if not free or not slots.can_restore(e.state, e.spilled):
                # contiguous states carry no page budget: slots only
                need = getattr(e.state, "budget", 0) if e.spilled else 0
                out.append(((-e.priority, e.preempted_step, e.rid),
                            e.state.request, need))
        for r in self._arrived():
            if not free or not slots.can_admit(r):
                out.append(((-r.priority, r.arrival_t, r.rid), r,
                            self._budget_pages(r)))
        if not out:
            return None
        _, req, need = min(out)
        return req, need

    def _admit_by_priority(self) -> None:
        """Fill free slots, then let blocked higher-priority work spill
        STRICTLY-lower-priority active sequences — but only when
        reclaiming every such victim would actually cover the blocked
        request's page need (otherwise preemption is pure churn: the
        victim's pages can never add up to an admission)."""
        self._fill_free_slots()
        slots = self.engine.slots
        while True:
            blocked = self._best_blocked()
            if blocked is None:
                return
            best, need = blocked
            victims = [s for s in slots.active_slots()
                       if slots.states[s].request.priority < best.priority]
            if not victims:
                return
            alloc = getattr(slots, "allocator", None)
            if alloc is not None:
                reclaim = sum(slots.states[s].budget for s in victims)
                if alloc.available() + reclaim < need:
                    return                     # infeasible even spilling all
            # spill weakest-first until the blocked request fits
            victims.sort(key=lambda s: (slots.states[s].request.priority,
                                        -slots.states[s].request.arrival_t))
            for v in victims:
                self.preempt(v, "spill")       # frees the slot AND its pages
                if alloc is None or alloc.available() >= need:
                    break
            self._fill_free_slots()

    def step(self, *, decode: bool = True) -> List[int]:
        """One scheduler tick: resume/admit by priority, then one
        unified token-budget step (or an idle tick with ``decode=False``
        — a contact window holding the compute).  Returns rids finished
        this tick."""
        eng = self.engine
        before = len(eng.finish_order)
        self._drain_store_evictions()
        if decode:
            self._admit_by_priority()
            eng._unified_step()
        else:
            eng._idle_tick()                   # compute yielded
        finished = eng.finish_order[before:]
        if self.store is not None:
            for rid in finished:               # spill history is dead weight
                self.store.drop(rid)
        return finished

    def run(self, requests: Optional[List[Request]] = None,
            ) -> Dict[int, RequestResult]:
        """Drain: submit ``requests``, then step until queue, slots and
        swap ledger are all empty."""
        for r in sorted(requests or [], key=lambda r: r.arrival_t):
            self.submit(r)
        while self.has_work():
            self.step()
        return self.engine.results

    def stats(self) -> dict:
        lat = self.resume_s
        delta = (self.store.stats() if self.store is not None else
                 DeltaSpillStore.empty_stats())
        return {
            "n_preemptions": self.n_preemptions,
            "n_spills": self.n_spills,
            "n_resumes": self.n_resumes,
            "n_redo_from_prefill": self.n_redo_from_prefill,
            "n_redo_from_corruption": self.n_redo_from_corruption,
            "swapped_steps": self.swapped_steps,
            "resume_latency_s_mean": round(float(np.mean(lat)), 6) if lat
            else 0.0,
            "resume_latency_s_max": round(float(np.max(lat)), 6) if lat
            else 0.0,
            **delta,
        }

    # -- crash-safe checkpoint / restore -------------------------------------
    _COUNTER_KEYS = ("n_preemptions", "n_spills", "n_resumes",
                     "n_redo_from_prefill", "n_redo_from_corruption",
                     "swapped_steps")

    def checkpoint(self, path: str,
                   extra_meta: Optional[dict] = None) -> int:
        """Serialize the COMPLETE serving state — request queue, swap
        ledger (store-managed spill records materialize through
        ``DeltaSpillStore.snapshot``), active slot states with their
        live KV, finished results and cumulative counters — through
        ``checkpoint.store``.  Non-destructive: the engine keeps
        running; call it periodically and a crash loses at most the
        work since the last call (``restore`` resumes token-exactly —
        greedy decode re-derives identical tokens from the snapshotted
        KV).  A spill record that fails its checksum here is handled
        like any detected corruption: the sequence redoes from prefill
        and enters the checkpoint as queued.  Returns bytes written.

        On a mesh every rank calls this (the snapshots gather whole
        pages from every rank); rank 0 writes the file, the others wait
        at a barrier for it.  The meta records the mesh's axis shape."""
        eng = self.engine
        slots = eng.slots
        paged = hasattr(slots, "allocator")
        tree: Dict[str, object] = {}
        seqs: List[dict] = []
        requests: Dict[int, Request] = {}

        def add_seq(st, kind: str, kv, preempted_step: int) -> None:
            rid = st.request.rid
            requests[rid] = st.request
            n = 0
            if kv is not None:
                leaves = tree_leaves(kv)
                for i, leaf in enumerate(leaves):
                    tree[f"kv/{rid}/{i}"] = leaf
                n = len(leaves)
            if st.last_logits is not None:
                tree[f"logits/{rid}"] = np.asarray(st.last_logits)
            seqs.append({
                "rid": int(rid), "kind": kind, "pos": int(st.pos),
                "next_tok": int(st.next_tok),
                "emitted": [int(x) for x in st.emitted],
                "admitted_step": int(st.admitted_step),
                "first_token_step": int(st.first_token_step),
                "phase": st.phase,
                "n_preemptions": int(st.n_preemptions),
                "preempted_step": int(preempted_step),
                "n_kv_leaves": n,
                "drafts": [int(x) for x in st.drafts],
            })

        # swapped entries first: materializing a store-managed spill can
        # DETECT a corrupted record, which requeues its request — the
        # queue must be serialized after that can no longer happen
        for e in list(self.swapped.values()):
            rid = e.rid
            if e.kv is not None:
                kv = e.kv
            elif not e.spilled:
                kv = slots.snapshot_state(e.state)   # resident (paged)
            elif self.store is not None and rid in self.store:
                try:
                    kv = self.store.snapshot(rid)
                except SpillCorruption:
                    del self.swapped[rid]
                    self._redo_corrupt(e)
                    continue
            else:
                kv = None    # PREFILLING spill before any page landed
            add_seq(e.state, "swapped", kv, e.preempted_step)
        for slot in slots.active_slots():
            add_seq(slots.states[slot], "active", slots.snapshot(slot),
                    eng.clock)
        queued = []
        for r in eng.queue.items():
            requests[r.rid] = r
            queued.append(int(r.rid))
        results_meta = {}
        for rid, res in eng.results.items():
            results_meta[str(rid)] = {
                "prompt_len": int(res.prompt_len),
                "admitted_step": int(res.admitted_step),
                "finished_step": int(res.finished_step),
                "first_token_step": int(res.first_token_step),
                "n_preemptions": int(res.n_preemptions),
            }
            tree[f"rtokens/{rid}"] = np.asarray(res.tokens)
            if res.logits_last is not None:
                tree[f"rlogits/{rid}"] = np.asarray(res.logits_last)
        req_meta = {}
        for rid, r in requests.items():
            req_meta[str(rid)] = {
                "max_new": int(r.max_new),
                "arrival_t": float(r.arrival_t),
                "priority": int(r.priority),
                "prefill_pos": int(r.prefill_pos),
            }
            tree[f"prompt/{rid}"] = np.asarray(r.prompt)
        all_rids = [*requests, *eng.results]
        meta = {
            "kv_layout": eng.kv_layout,
            "page_size": int(slots.page_size) if paged else 0,
            # axis names and sizes only: snapshots hold whole pages, so
            # only the mesh's SHAPE must agree on restore
            "mesh": _mesh_meta(eng),
            "clock": int(eng.clock),
            "prefill_tokens_total": int(eng.prefill_tokens_total),
            "finish_order": [int(x) for x in eng.finish_order],
            "queued": queued,
            "sequences": seqs,
            "requests": req_meta,
            "results": results_meta,
            "max_rid": int(max(all_rids)) if all_rids else -1,
            "sched": {k: int(getattr(self, k))
                      for k in self._COUNTER_KEYS},
            "store": (self.store.counters()
                      if self.store is not None else None),
            "extra": extra_meta or {},
        }
        mesh = getattr(eng, "mesh", None)
        if mesh is None:
            return save_checkpoint(path, tree, meta=meta)
        if mesh.rank == 0:
            save_checkpoint(path, tree, meta=meta)
        mesh.barrier()
        return os.path.getsize(path)

    def restore(self, path: str) -> dict:
        """Rebuild serving state from a checkpoint into THIS (fresh)
        scheduler/engine pair — the reboot path: device KV did not
        survive, so every checkpointed sequence re-enters as a spilled
        swap entry whose resume re-reserves pages and grafts the
        snapshotted KV back (bit-exact), and queued requests rejoin the
        queue in order.  Returns the checkpoint's ``extra`` meta."""
        eng = self.engine
        slots = eng.slots
        paged = hasattr(slots, "allocator")
        if (eng.clock != 0 or eng.results or eng.finish_order
                or len(eng.queue) or slots.any_active() or self.swapped):
            raise RuntimeError(
                "restore() needs a FRESH engine/scheduler (reboot builds "
                "new ones, e.g. via ContinuousEngine.clone_fresh)")
        leaves, meta = load_checkpoint_raw(path)
        if meta["kv_layout"] != eng.kv_layout:
            raise RuntimeError(
                f"checkpoint kv_layout {meta['kv_layout']!r} != engine "
                f"{eng.kv_layout!r}")
        if paged and meta["page_size"] != slots.page_size:
            raise RuntimeError(
                f"checkpoint page_size {meta['page_size']} != engine "
                f"{slots.page_size}")
        here = _mesh_meta(eng)
        if meta.get("mesh") != here:
            raise RuntimeError(
                f"checkpoint mesh {meta.get('mesh')} != engine {here} — "
                "restore into an engine with the same mesh axis shape")

        def kv_of(rid: int, n: int):
            if n == 0:
                return None
            return tree_unflatten(
                slots.cache, [leaves[f"kv/{rid}/{i}"] for i in range(n)])

        def host(key: str) -> Optional[np.ndarray]:
            t = leaves.get(key)
            return None if t is None else t.numpy()

        requests: Dict[int, Request] = {}
        for rid_s, r in meta["requests"].items():
            rid = int(rid_s)
            requests[rid] = Request(
                prompt=host(f"prompt/{rid}"),
                max_new=int(r["max_new"]), rid=rid,
                arrival_t=float(r["arrival_t"]),
                priority=int(r["priority"]),
                prefill_pos=int(r["prefill_pos"]))
        eng.clock = int(meta["clock"])
        eng.prefill_tokens_total = int(meta["prefill_tokens_total"])
        eng.finish_order = [int(x) for x in meta["finish_order"]]
        for rid_s, r in meta["results"].items():
            rid = int(rid_s)
            eng.results[rid] = RequestResult(
                rid=rid, tokens=host(f"rtokens/{rid}"),
                prompt_len=int(r["prompt_len"]),
                admitted_step=int(r["admitted_step"]),
                finished_step=int(r["finished_step"]),
                first_token_step=int(r["first_token_step"]),
                n_preemptions=int(r["n_preemptions"]),
                logits_last=host(f"rlogits/{rid}"))
        for rid in meta["queued"]:
            eng.queue.submit(requests[int(rid)])
        for s in meta["sequences"]:
            rid = int(s["rid"])
            req = requests[rid]
            common = dict(request=req, pos=int(s["pos"]),
                          next_tok=int(s["next_tok"]),
                          emitted=[int(x) for x in s["emitted"]],
                          admitted_step=int(s["admitted_step"]),
                          first_token_step=int(s["first_token_step"]),
                          phase=s["phase"],
                          n_preemptions=int(s["n_preemptions"]),
                          last_logits=host(f"logits/{rid}"),
                          drafts=[int(x) for x in s.get("drafts", [])])
            if paged:
                # shared-prefix refs died with the old pool: the restored
                # entry is fully private, budgeted for its whole lifetime
                st = _PagedSlotState(**common, pages=[],
                                     budget=slots._lifetime_pages(req),
                                     synced_pages=0, shared_pages=0)
            else:
                st = _SlotState(**common)
            self.swapped[rid] = SwapEntry(
                state=st, kv=kv_of(rid, int(s["n_kv_leaves"])),
                preempted_step=int(s["preempted_step"]), spilled=True)
        for k in self._COUNTER_KEYS:
            setattr(self, k, int(meta["sched"][k]))
        if self.store is not None and meta.get("store"):
            self.store.load_counters(meta["store"])
        # restored rids must never collide with future fresh Requests
        ensure_rid_floor(int(meta["max_rid"]) + 1)
        return meta.get("extra", {})


def _mesh_meta(eng) -> Optional[list]:
    """The engine's mesh as a checkpoint records it: [[axis, size], ...],
    or None without one."""
    mesh = getattr(eng, "mesh", None)
    if mesh is None:
        return None
    return [[str(a), int(mesh.shape[a])] for a in mesh.axis_names]


# ==========================================================================
# space-ground tiering
# ==========================================================================

@dataclass
class SpaceGroundReport:
    """Final answers plus the byte/energy ledger of one replay."""
    tokens: Dict[int, np.ndarray]       # rid -> final token stream
    sat_results: Dict[int, RequestResult]
    ground_results: Dict[int, RequestResult]
    escalated: List[int]                # rids re-answered by the ground tier
    undelivered: List[int]              # rids whose downlink missed the horizon
    ledger: Ledger = field(default_factory=Ledger)
    n_preemptions: int = 0
    windows: List[Tuple[int, int]] = field(default_factory=list)
    sat_stats: dict = field(default_factory=dict)   # PreemptiveScheduler.stats
    decode_steps_in_window: int = 0     # overlap: decode ticks during passes
    n_reboots: int = 0                  # injected crashes survived via restore
    lane_stats: dict = field(default_factory=dict)  # TransmitLane.state()
    spec_stats: dict = field(default_factory=dict)  # ground-tier draft-verify
    #                                     counters (ContinuousEngine.spec_stats)


class SpaceGroundScheduler:
    """Two-tier scheduling between a satellite and a ground engine.

    Each ground-station pass (``ContactSchedule`` quantized to decode
    ticks via ``step_windows``) is split into two lanes:

      * a **transmit lane** (``core.link.TransmitLane``) draining the
        downlink backlog incrementally against the pass's per-tick byte
        budget, in FIFO order: (a) compact results of confident finished
        sequences, (b) raw prompts of low-confidence ones — the
        ``core/cascade`` gate decides which — which the ground engine
        then re-answers.  With ``speculative=True`` an escalation ships
        only the satellite's DRAFT TOKEN IDS
        (``core.link.payload_bytes_draft`` — the ground already holds
        the prompt from the uplink relay, exactly as the raw path
        already assumes when it resubmits ``by_rid[rid]``) and the
        ground engine verifies the whole draft stream in chunked
        passes (``ContinuousEngine.attach_drafts``) instead of
        re-decoding token-by-token — same greedy answers, a fraction
        of the downlink bytes and of the ground decode ticks; and
      * a **compute lane**: with ``overlap`` (the default) satellite
        decode *continues through the pass*, interleaved one decode
        step per transmitted tick.  Only the transmit lane's staging
        reserve (``comm_reserve_pages`` KV pages held for the pass via
        ``PreemptiveScheduler.hold_pages``) can force preemption, and
        only of the sequences whose pages must spill to cover it; the
        rest never stop.  Spilled victims resume token-exactly after
        the pass — re-preempted long sequences ship only KV-delta
        pages.  ``overlap=False`` is the stop-the-world behavior:
        every in-flight sequence preempted for the whole pass.

    The ground tier is always-on (it's on Earth) and steps once per
    satellite tick.

    Deterministic: the only clock is the satellite engine's decode tick
    (``s_per_step`` seconds each), so the same trace + schedule replays
    to identical tokens, preemptions, and ledger totals.
    """

    def __init__(self, sat_engine: ContinuousEngine,
                 ground_engine: ContinuousEngine, *,
                 schedule: Optional[ContactSchedule] = None,
                 gate: Optional[ConfidenceGate] = None,
                 energy: Optional[EnergyModel] = None,
                 s_per_step: float = 0.35,
                 horizon_s: float = 86_400.0,
                 preempt_mode: str = "spill",
                 overlap: bool = True,
                 comm_reserve_pages: int = 2,
                 delta_spill: bool = True,
                 frame_bytes: Optional[int] = None,
                 link_max_retries: int = 8,
                 faults: Optional[FaultInjector] = None,
                 checkpoint_every: int = 0,
                 checkpoint_path: Optional[str] = None,
                 speculative: bool = False):
        self._sat_kw = dict(preempt_mode=preempt_mode,
                            delta_spill=delta_spill)
        self.faults = faults
        self.sat = PreemptiveScheduler(sat_engine, fault_injector=faults,
                                       **self._sat_kw)
        self.overlap = overlap
        self.comm_reserve_pages = comm_reserve_pages
        self.ground = ground_engine
        self.speculative = speculative
        if speculative and ground_engine.kv_layout != "paged":
            raise ValueError(
                "speculative escalation needs a paged-layout ground "
                "engine (draft verification runs through the chunk path)")
        # fresh default instances per scheduler: the models hold mutable
        # dict fields a caller may tune (e.g. energy.subsystem_w)
        self.schedule = schedule if schedule is not None else ContactSchedule()
        self.gate = gate if gate is not None else ConfidenceGate()
        self.energy = energy if energy is not None else EnergyModel()
        self.s_per_step = s_per_step
        self.horizon_steps = int(horizon_s / s_per_step)
        self.windows = self.schedule.step_windows(s_per_step, horizon_s)
        self.frame_bytes = frame_bytes
        self.link_max_retries = link_max_retries
        self.checkpoint_every = int(checkpoint_every)
        if faults is not None:
            p = faults.plan
            if ((p.frame_loss_rate > 0.0 or p.frame_corrupt_rate > 0.0)
                    and frame_bytes is None):
                raise ValueError(
                    "a lossy FaultPlan needs frame_bytes: only the framed "
                    "lane can detect loss/corruption and retransmit")
            if p.crash_at_tick is not None and self.checkpoint_every <= 0:
                raise ValueError(
                    "FaultPlan schedules a crash but checkpoint_every is "
                    "0 — there would be nothing to restore from")
            # early LOS: ionospheric scintillation cuts passes short
            self.windows = faults.truncate_step_windows(self.windows)
        if self.checkpoint_every > 0 and checkpoint_path is None:
            checkpoint_path = os.path.join(
                tempfile.mkdtemp(prefix="sgs_ckpt_"), "sat.ckpt")
        self._ckpt_path = checkpoint_path
        # downlink budget per in-window tick, derived from the link
        # model's own loss-adjusted rate (downlink_time_s(1) = s/byte)
        self.bytes_per_step = (s_per_step
                               / self.schedule.link.downlink_time_s(1.0))

    def _in_window(self, t: int) -> bool:
        return any(lo <= t < hi for lo, hi in self.windows)

    def _next_window_start(self, t: int) -> Optional[int]:
        starts = [lo for lo, hi in self.windows if hi > t]
        return min(starts) if starts else None

    def _make_lane(self) -> TransmitLane:
        if self.frame_bytes is not None:
            return TransmitLane(frame_bytes=self.frame_bytes,
                                max_retries=self.link_max_retries,
                                injector=self.faults)
        return TransmitLane()

    def _write_checkpoint(self, lane: TransmitLane) -> None:
        """Checkpoint the full satellite side: serving state through
        ``PreemptiveScheduler.checkpoint`` plus the downlink backlog,
        lane counters and injector state as ``extra`` meta, so a reboot
        rolls the WHOLE satellite back to one consistent instant (the
        injector's RNG rolls back too — post-restore fault draws replay
        identically, keeping injected == detected accounting exact)."""
        extra = {
            "lane": [[int(rid), bool(esc), float(nb)]
                     for (rid, esc), nb in lane.pending_payloads()],
            "lane_state": lane.state(),
        }
        if self.faults is not None:
            extra["faults"] = self.faults.state()
        self.sat.checkpoint(self._ckpt_path, extra_meta=extra)

    def _reboot(self) -> TransmitLane:
        """Simulated satellite reboot: device memory and every live
        Python object on the sat side are gone; rebuild a fresh engine
        (weights persist — they live in the read-only image) + scheduler
        + lane from the last checkpoint.  Ground-side state is on Earth
        and survives untouched."""
        eng = self.sat.engine.clone_fresh()
        self.sat = PreemptiveScheduler(eng, fault_injector=self.faults,
                                       **self._sat_kw)
        extra = self.sat.restore(self._ckpt_path)
        lane = self._make_lane()
        for rid, esc, nb in extra["lane"]:
            lane.enqueue((int(rid), bool(esc)), float(nb))
        lane.load_state(extra["lane_state"])
        if self.faults is not None and "faults" in extra:
            self.faults.load_state(extra["faults"])
        return lane

    def run(self, requests: List[Request]) -> SpaceGroundReport:
        rep = SpaceGroundReport(tokens={}, sat_results={}, ground_results={},
                                escalated=[], undelivered=[],
                                windows=list(self.windows))
        led = rep.ledger
        for r in sorted(requests, key=lambda r: r.arrival_t):
            self.sat.submit(r)
        by_rid = {r.rid: r for r in requests}
        ground_to_rid: Dict[int, int] = {}
        lane = self._make_lane()         # items: (rid, escalate)
        # ground-side memory: a crash rolls the SATELLITE back to its
        # last checkpoint, so work finished/downlinked in between is
        # redone and re-delivered — Earth must not double-count it
        classified: set = set()          # rids already in the ledger
        delivered: set = set()           # rids already landed on Earth
        last_ckpt: Optional[int] = None

        def classify(rid: int) -> None:
            """Queue a finished satellite sequence for downlink."""
            res = self.sat.results[rid]
            rep.sat_results[rid] = res
            # the gate runs where the satellite engine runs: on CUDA the
            # gate kernel, once per classified sequence
            logits = torch.from_numpy(res.logits_last[None]).to(
                self.sat.engine.device)
            esc = bool(self.gate.decide(logits)["escalate"][0])
            if not esc:
                nbytes = payload_bytes_result(len(res.tokens))
            elif self.speculative:
                # the ground tier verifies the satellite's draft instead
                # of re-decoding from the (already-relayed) raw prompt:
                # only the draft token ids cross the downlink
                nbytes = payload_bytes_draft(len(res.tokens))
            else:
                nbytes = payload_bytes_raw(1, (res.prompt_len,), 4)
            if rid not in classified:    # a post-reboot redo re-finishes
                classified.add(rid)
                led.add("items_total", 1)
                led.add("items_escalated", int(esc))
                led.add("bytes_results", 0 if esc else nbytes)
                if self.speculative:
                    led.add("bytes_draft_escalated", nbytes if esc else 0)
                    led.add("draft_tokens_shipped",
                            len(res.tokens) if esc else 0)
                else:
                    led.add("bytes_raw_escalated", nbytes if esc else 0)
                led.add("bytes_bentpipe_baseline",
                        payload_bytes_raw(1, (res.prompt_len,), 4))
            lane.enqueue((rid, esc), nbytes)

        def decode_tick(in_window: bool) -> None:
            """One compute-lane tick: decode, meter energy, classify."""
            finished = self.sat.step()
            if self.sat.engine.slots.any_active() or finished:
                led.add("energy_compute_j",
                        self.energy.inference_energy_j(1, self.s_per_step))
                if in_window:
                    rep.decode_steps_in_window += 1
            for rid in finished:
                classify(rid)

        t = self.sat.clock
        while True:
            ground_busy = bool(len(self.ground.queue)
                               or self.ground.slots.any_active())
            if not (self.sat.has_work() or len(lane) or ground_busy):
                break
            if t >= self.horizon_steps and not (self.sat.has_work()
                                                or ground_busy):
                # backlog missed every window: record, don't silently drop
                rep.undelivered = [rid for rid, _ in lane.clear()]
                break
            if (self._ckpt_path is not None and self.checkpoint_every > 0
                    and (last_ckpt is None
                         or t - last_ckpt >= self.checkpoint_every)):
                self._write_checkpoint(lane)
                last_ckpt = t
            if self.faults is not None and self.faults.crash_due(t):
                # injected satellite reboot: everything on the sat side
                # rolls back to the last checkpoint and replays
                # token-exactly; Earth keeps what already landed
                self.faults.note_crash()
                rep.n_reboots += 1
                lane = self._reboot()
                t = self.sat.clock
                last_ckpt = t            # restore IS the checkpoint state
                continue
            in_window = self._in_window(t)
            if in_window:
                if self.overlap:
                    # compute keeps running: hold only the transmit
                    # lane's staging reserve, spilling the fewest
                    # sequences whose pages must cover it
                    self.sat.hold_pages(self.comm_reserve_pages)
                else:
                    # stop-the-world: the pass holds the compute
                    self.sat.preempt_all()
                # the transmit lane drains this tick's byte budget FIFO
                tx_active = len(lane) > 0
                sent_before = lane.bytes_sent
                lost_before = lane.bytes_lost
                retx_before = lane.bytes_retransmitted
                for rid, esc in lane.tick(self.bytes_per_step):
                    if rid in delivered:
                        continue         # post-reboot re-delivery: Earth
                        #                  already has this answer
                    delivered.add(rid)
                    if esc:
                        rep.escalated.append(rid)
                        src = by_rid[rid]
                        # clone keeps priority/prompt/max_new; arrival
                        # is the downlink tick the answer landed on the
                        # ground, so ground-tier admission order matches
                        # downlink order (not a flat 0.0 for everyone)
                        g = src.clone()
                        g.arrival_t = float(self.ground.clock)
                        if self.speculative:
                            # the landed payload IS the draft stream:
                            # the ground verifies it in chunked passes
                            # rather than re-decoding the prompt
                            g.draft_toks = np.asarray(
                                rep.sat_results[rid].tokens, np.int32)
                        ground_to_rid[g.rid] = rid
                        self.ground.submit(g)
                # a payload that burned its whole retry budget goes back
                # on the queue: the satellite never silently drops an
                # answer — it re-ships (and re-meters) until it lands
                for item, nb in lane.take_failed():
                    led.add("n_payload_retransmits", 1)
                    lane.enqueue(item, nb)
                if tx_active:
                    led.add("bytes_downlinked", lane.bytes_sent - sent_before)
                    if lane.framed:
                        led.add("bytes_lost", lane.bytes_lost - lost_before)
                        led.add("bytes_retransmitted",
                                lane.bytes_retransmitted - retx_before)
                    led.add("downlink_s", self.s_per_step)
                    led.add("energy_comm_j",
                            self.energy.comm_energy_j(self.s_per_step))
                if self.overlap:
                    decode_tick(True)    # compute lane: same tick
                else:
                    self.sat.step(decode=False)
                    # stop-the-world invariant tripwire: preempt_all
                    # just ran, so an active slot here means decode
                    # leaked into the pass — surface it in the metric
                    # instead of silently reporting 0
                    if self.sat.engine.slots.any_active():
                        rep.decode_steps_in_window += 1
            else:
                self.sat.release_hold()  # window closed: staging pages back
                if self.sat.has_work():
                    decode_tick(False)
                elif len(lane):
                    nxt = self._next_window_start(t)
                    if nxt is None:      # no pass left in the horizon
                        rep.undelivered = [rid for rid, _ in lane.clear()]
                        continue
                    self.sat.engine.clock = nxt     # sleep to the next pass
                    # the ground tier gets the whole inter-pass gap, not
                    # one tick: drain whatever it is already decoding
                    while (len(self.ground.queue)
                           or self.ground.slots.any_active()):
                        self.ground.step()
                else:
                    self.sat.step()      # idle tick: wait for arrivals
            self.ground.step()           # always-on tier
            t = self.sat.clock

        self.sat.release_hold()          # horizon may end mid-window
        # drain the ground tier (it may still be decoding escalations)
        while len(self.ground.queue) or self.ground.slots.any_active():
            self.ground.step()

        rep.ground_results = {ground_to_rid[grid]: res
                              for grid, res in self.ground.results.items()
                              if grid in ground_to_rid}
        for rid, res in rep.sat_results.items():
            if rid in rep.ground_results:
                rep.tokens[rid] = rep.ground_results[rid].tokens
            else:
                rep.tokens[rid] = res.tokens
        rep.n_preemptions = self.sat.n_preemptions
        rep.sat_stats = self.sat.stats()
        rep.lane_stats = lane.state()
        if self.speculative:
            rep.spec_stats = self.ground.spec_stats()
        return rep
