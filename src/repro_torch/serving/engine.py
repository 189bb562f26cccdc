"""Serving engines for the dense and hybrid (zamba2) families: the twin
of the JAX package's ``serving/engine.py``.

  * ``ServingEngine`` — fixed-slot batches: the batch is prefilled in one
    monolithic ``forward`` (the flash kernel, once per layer) into a
    contiguous cache, then decoded one token per step for the whole batch
    (the contiguous decode kernel, once per layer and step).
  * ``ContinuousEngine`` — continuous batching under ONE unified
    token-budget step per tick.  Its KV memory comes in two layouts:
    ``PagedSlotManager`` (the default): a ``BlockAllocator`` owns the
    page pool, each sequence holds a growable block table, admission
    reserves the worst-case lifetime page count up front, and prompts
    stream in as chunks of up to ``prefill_budget_tokens`` tokens,
    bucketed exactly as the reference buckets them (next power of two,
    floor 8) so every chunk runs the same positions and pads and the
    per-position logits match; a one-pass verify of pending speculative
    drafts runs before the batched decode.  ``SlotManager``
    (``kv_layout="contiguous"``, the memory baseline): one contiguous
    ``(n_slots, max_seq)`` cache row per slot, filled at admission by a
    monolithic bucketed prefill and a graft.  The hybrid family (Mamba2
    state plus shared-attention K/V) always takes this layout, and its
    prompts run at their exact length.

Both slot managers carry the preemption surface that
``serving.scheduler`` drives: ``snapshot`` (a host copy of a slot's KV),
``detach``, ``discard_detached``, ``can_restore`` and ``restore``; the
paged manager also keeps a ``synced_pages`` watermark per sequence for
KV-delta spills.  ``ContinuousEngine.clone_fresh`` is the reboot path.

Not ported yet (they raise ``NotImplementedError``): the xLSTM family
(``ssm``), prefix sharing (``prefix_cache=True``), mesh serving
(``mesh=``), MoE, MLA, VLM and audio inputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.batching import Request, RequestQueue
from repro_torch.serving.paging import (BlockAllocator, default_pool_pages,
                                        pages_for)


# ==========================================================================
# fixed-slot engine
# ==========================================================================

@dataclass
class GenerateResult:
    tokens: np.ndarray                 # (B, n_new)
    logits_last: np.ndarray            # (B, V) final-step logits
    prompt_logits: np.ndarray          # (B, V) last prompt-position logits


class ServingEngine:
    """Fixed-slot batches: every prompt of a batch has the same length,
    the batch is prefilled at once and drains together.  ``device``
    (default ``"cuda"``) is the params' device; on CUDA the prefill runs
    the flash kernel (hybrid: once per shared-attention application, and
    the SSD scan kernel once per Mamba2 block) and every decode step the
    contiguous decode kernel."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 2048):
        T.require_ported(cfg, "ServingEngine")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = params["embed"].device

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, max_seq: int = 2048,
             device="cuda"):
        """An engine with random params from a seeded generator on
        ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
        return cls(cfg, T.init_params(cfg, seed=seed, device=device),
                   max_seq=max_seq)

    def full_cache(self, prompt_cache, batch: int):
        """The prompt's cache placed in a zero ``max_seq`` cache: K/V
        (L, B, S, ...) at the start of the sequence axis, recurrent
        leaves (same shape in both) whole."""
        template = T.init_cache(self.cfg, batch, self.max_seq,
                                device=self.device)
        return T.graft_slot_cache(template, prompt_cache, 0)

    def generate(self, tokens: np.ndarray, *, max_new: int = 16,
                 greedy: bool = True, extra_inputs: Optional[dict] = None,
                 seed: int = 0) -> GenerateResult:
        """tokens: (B, S_prompt) int32.  ``greedy=False`` samples each
        token from the softmax with a ``torch.Generator`` seeded by
        ``seed`` (not the JAX package's ``jax.random`` stream)."""
        if extra_inputs:
            raise NotImplementedError(
                "ServingEngine: VLM and audio inputs are not ported yet")
        cfg = self.cfg
        B, S = tokens.shape
        if not cfg.sliding_window and S + max_new > self.max_seq:
            raise ValueError(f"prompt {S} + max_new {max_new} exceeds "
                             f"max_seq {self.max_seq}")
        toks = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        logits, cache = T.prefill(self.params, cfg, {"tokens": toks})
        cache = self.full_cache(cache, B)
        cur = logits[:, -1]
        prompt_logits = cur
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        out = torch.empty((B, max_new), dtype=torch.int32, device=self.device)
        for t in range(max_new):
            if greedy:
                nxt = torch.argmax(cur, dim=-1)
            else:
                nxt = torch.multinomial(torch.softmax(cur, dim=-1), 1,
                                        generator=gen)[:, 0]
            out[:, t] = nxt
            step_logits, cache = T.decode_step(
                self.params, cfg, cache, nxt[:, None].to(torch.int32), S + t)
            cur = step_logits[:, 0]
        return GenerateResult(tokens=out.cpu().numpy(),
                              logits_last=cur.float().cpu().numpy(),
                              prompt_logits=prompt_logits.float().cpu().numpy())


# ==========================================================================
# continuous batching
# ==========================================================================

@dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray                 # (n_new,) greedy continuation
    prompt_len: int
    admitted_step: int                 # engine clock at admission
    finished_step: int = 0
    first_token_step: int = 0          # clock when the prefill completed
    #                                    and the first token was emitted
    n_preemptions: int = 0             # times swapped out mid-decode
    logits_last: Optional[np.ndarray] = None   # (V,) final-step logits


# lifecycle phases of a slot-resident sequence: PREFILLING sequences are
# still streaming prompt chunks into the cache; DECODING sequences step
# one token per tick.
PREFILLING = "prefill"
DECODING = "decode"


@dataclass
class _SlotState:
    request: Request
    pos: int                           # absolute position of the NEXT write
    next_tok: int                      # last emitted token (next decode input)
    emitted: List[int] = field(default_factory=list)
    admitted_step: int = 0
    first_token_step: int = 0          # clock at prefill completion
    phase: str = DECODING              # PREFILLING | DECODING
    n_preemptions: int = 0
    last_logits: Optional[np.ndarray] = None   # (V,) set at finish
    drafts: List[int] = field(default_factory=list)   # pending drafts


@dataclass
class _PagedSlotState(_SlotState):
    pages: List[int] = field(default_factory=list)    # block table
    budget: int = 0                    # lifetime pages reserved
    synced_pages: int = 0              # leading pages bit-identical to the
    #                                    host spill store: decode and chunk
    #                                    writes lower it, a spill or a
    #                                    resume raises it
    shared_pages: int = 0              # leading pages attached from a
    #                                    prefix index (0 until the prefix
    #                                    cache is ported)


class _SlotOccupancy:
    """Slot-occupancy bookkeeping shared by both cache layouts."""

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s is not None]

    def decoding_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states)
                if s is not None and s.phase == DECODING]

    def prefilling_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states)
                if s is not None and s.phase == PREFILLING]

    def any_active(self) -> bool:
        return any(s is not None for s in self.states)

    def decode_inputs(self, skip=()):
        """(tokens (n_slots, 1) int32, pos (n_slots,) int32).  Idle,
        PREFILLING and ``skip`` slots feed token 0 at position 0 of a
        region no live sequence reads (their own cache row here, the
        scratch page in the paged layout), leaving garbage there that
        admission overwrites before the slot is read again."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self.states):
            if s is not None and s.phase == DECODING and i not in skip:
                toks[i, 0] = s.next_tok
                pos[i] = s.pos
        return toks, pos

    def cache_bytes(self) -> int:
        leaves = [t for d in self.cache.values() for t in d.values()]
        return int(sum(t.numel() * t.element_size() for t in leaves))


class SlotManager(_SlotOccupancy):
    """Owns the contiguous multi-slot KV cache
    ``models.transformer.init_cache(cfg, n_slots, max_seq)``: slot ``i``
    is batch row ``i`` of every leaf.  Admission grafts a
    single-sequence prefix cache into a free slot; eviction just frees
    the slot id: stale keys/values beyond a new occupant's prefix stay
    masked by the per-slot ``kv_len`` until overwritten."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int, *,
                 device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = T.init_cache(cfg, n_slots, max_seq, device=device)
        self.states: List[Optional[_SlotState]] = [None] * n_slots
        self._template = None          # batch-1 host cache, first snapshot

    # -- admission / eviction ----------------------------------------------
    def can_admit(self, req: Request) -> bool:
        return True                    # a free slot is the only resource

    def place(self, slot: int, prefix_cache, state: _SlotState) -> None:
        if self.states[slot] is not None:
            raise RuntimeError(f"slot {slot} occupied")
        T.graft_slot_cache(self.cache, prefix_cache, slot)
        self.states[slot] = state

    def evict(self, slot: int) -> None:
        self.states[slot] = None

    # -- preemption (snapshot / detach / restore) ---------------------------
    def snapshot(self, slot: int) -> dict:
        """Host copy of slot ``slot``'s full cache row (the whole max_seq
        reservation, so restore needs no length bookkeeping)."""
        if self._template is None:
            self._template = T.init_cache(self.cfg, 1, self.max_seq,
                                          device="cpu")
        row = T.extract_slot_cache(self.cache, self._template, slot)
        return {n: {k: t.cpu() for k, t in d.items()} for n, d in row.items()}

    def detach(self, slot: int, *, release_pages: bool = True) -> _SlotState:
        """Remove the slot's state without finishing it.  The contiguous
        row holds no pooled resource, so ``release_pages`` is a no-op."""
        st = self.states[slot]
        self.states[slot] = None
        return st

    def discard_detached(self, state: _SlotState) -> None:
        """Drop a detached sequence for good: no pooled resource to
        return in the contiguous layout."""

    def can_restore(self, state: _SlotState, spilled: bool) -> bool:
        return True

    def restore(self, slot: int, state: _SlotState, kv=None, *,
                spilled: bool = True) -> None:
        """Re-place a detached sequence; ``kv`` is a ``snapshot`` (required
        here: the row may have been reused since detach)."""
        if self.states[slot] is not None:
            raise RuntimeError(f"slot {slot} occupied")
        if kv is None:
            raise RuntimeError("contiguous restore needs the KV snapshot")
        T.graft_slot_cache(self.cache, kv, slot)
        self.states[slot] = state

    def kv_cache_stats(self) -> dict:
        return {"kv_layout": "contiguous", "kv_cache_bytes": self.cache_bytes()}


class PagedSlotManager(_SlotOccupancy):
    """Owns the paged KV pool and per-slot block tables.

    The cache is ``models.transformer.init_paged_cache(cfg, n_pages + 1,
    page_size)``: page 0 is the scratch page idle slots write to.
    Admission reserves a request's worst-case lifetime page count but
    allocates nothing; prompt chunks draw pages as they land
    (``grow_for_chunk``), decode grows the table one page per
    ``page_size`` steps, and eviction returns pages plus any unused
    reservation.  Stale KV in recycled pages beyond a slot's ``kv_len``
    stays masked until overwritten (overwrite-before-read)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int, *,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        if pool_pages is None:
            pool_pages = default_pool_pages(n_slots, max_seq, page_size)
        self.allocator = BlockAllocator(pool_pages)
        self.max_bt = pages_for(max_seq, page_size)
        self.cache = T.init_paged_cache(cfg, pool_pages + 1, page_size,
                                        device=device)
        self.states: List[Optional[_PagedSlotState]] = [None] * n_slots

    def _lifetime_pages(self, req: Request) -> int:
        return req.pages_needed(self.page_size)

    # -- admission / eviction ----------------------------------------------
    def can_admit(self, req: Request) -> bool:
        return self.allocator.can_reserve(self._lifetime_pages(req))

    def fits_pool(self, req: Request) -> bool:
        """Whether the request could EVER be admitted (pool capacity)."""
        return self._lifetime_pages(req) <= self.allocator.n_pages

    def place_prefilling(self, slot: int, req: Request, clock: int) -> None:
        """Open ``slot`` PREFILLING: reserve the lifetime page budget,
        allocate nothing yet."""
        if self.states[slot] is not None:
            raise RuntimeError(f"slot {slot} occupied")
        budget = self._lifetime_pages(req)
        self.allocator.reserve(budget)
        self.states[slot] = _PagedSlotState(
            request=req, pos=req.prefill_pos, next_tok=0,
            admitted_step=clock, phase=PREFILLING, budget=budget)

    def grow_for_chunk(self, slot: int, n_positions: int) -> None:
        """Allocate pages (against the reservation) so the slot's block
        table covers positions [0, n_positions), and lower the
        ``synced_pages`` watermark to the first page the chunk writes."""
        st = self.states[slot]
        first_write = st.pos // self.page_size
        while len(st.pages) * self.page_size < n_positions:
            st.pages.extend(self.allocator.alloc(1))
        st.synced_pages = min(st.synced_pages, first_write)

    def evict(self, slot: int) -> None:
        st = self.states[slot]
        n_private = len(st.pages) - st.shared_pages
        self.allocator.release(st.pages, unreserve=st.budget - n_private)
        self.states[slot] = None

    # -- preemption (snapshot / detach / restore) ---------------------------
    def _host_pages(self, pages: List[int]) -> dict:
        """Host copy of ``pages`` as a prefix-shaped cache (leaves
        (L, 1, len(pages) * page_size, Hkv, D)).  ``.cpu()`` is a
        blocking copy: the pages may be recycled right after a spill."""
        snap = T.extract_paged_cache(self.cache, pages)
        return {n: {k: t.cpu() for k, t in d.items()}
                for n, d in snap.items()}

    def snapshot(self, slot: int, since: int = 0) -> Optional[dict]:
        """Host copy of the slot's live pages past the first ``since``
        (the KV-delta spill ships only pages dirtied since the last
        spill); None when there is nothing past ``since``.  Restores
        bit-exactly through ``graft_paged_cache``."""
        st = self.states[slot]
        if since >= len(st.pages):
            return None
        return self._host_pages(st.pages[since:])

    def snapshot_state(self, state: _PagedSlotState) -> Optional[dict]:
        """Host copy of a detached but resident sequence's pages (a
        resident swap entry at checkpoint time); None without pages."""
        if not state.pages:
            return None
        return self._host_pages(state.pages)

    def detach(self, slot: int, *, release_pages: bool) -> _PagedSlotState:
        """Remove the slot's state without finishing it.  With
        ``release_pages`` (spill preemption) its private pages and unused
        reservation go back to the pool and the caller must hold a
        ``snapshot`` of them; without (resident preemption) everything
        stays committed and restore is free."""
        st = self.states[slot]
        self.states[slot] = None
        if release_pages:
            private = st.pages[st.shared_pages:]
            self.allocator.release(private,
                                   unreserve=st.budget - len(private))
            st.pages = st.pages[:st.shared_pages]
        return st

    def discard_detached(self, state: _PagedSlotState) -> None:
        """Drop a detached (spilled) sequence without resuming it (the
        redo-from-prefill path): release what it still pins."""
        if state.pages:
            self.allocator.release(state.pages)
            state.pages = []
        state.shared_pages = 0
        state.synced_pages = 0

    def can_restore(self, state: _PagedSlotState, spilled: bool) -> bool:
        """A spilled sequence re-reserves its whole lifetime budget, the
        same discipline as first admission."""
        return (not spilled) or self.allocator.can_reserve(state.budget)

    def restore(self, slot: int, state: _PagedSlotState, kv=None, *,
                spilled: bool = True) -> None:
        """Re-place a detached sequence.  ``spilled`` re-reserves its
        budget; ``kv`` (a ``snapshot`` of its private pages) is grafted
        into freshly allocated pages.  None for a resident swap, or for a
        sequence preempted before its first page landed."""
        if self.states[slot] is not None:
            raise RuntimeError(f"slot {slot} occupied")
        if spilled:
            self.allocator.reserve(state.budget)
            if kv is not None:
                n = kv["blocks"]["k"].shape[2] // self.page_size
                new = self.allocator.alloc(n)
                state.pages.extend(new)
                T.graft_paged_cache(self.cache, kv, new)
        self.states[slot] = state

    # -- paged decode plumbing ---------------------------------------------
    def ensure_write_pages(self, skip=()) -> None:
        """Grow each DECODING slot's block table to cover its next write
        position (drawn from the admission reservation), and lower its
        ``synced_pages`` watermark to the page this tick writes."""
        for slot, st in enumerate(self.states):
            if st is None or st.phase != DECODING or slot in skip:
                continue
            while len(st.pages) <= st.pos // self.page_size:
                st.pages.extend(self.allocator.alloc(1))
            st.synced_pages = min(st.synced_pages, st.pos // self.page_size)

    def block_tables(self, skip=()) -> np.ndarray:
        """(n_slots, max_bt) int32 page ids for the decode sub-batch;
        unused entries and non-decoding rows point at scratch page 0."""
        bt = np.zeros((self.n_slots, self.max_bt), np.int32)
        for i, st in enumerate(self.states):
            if st is not None and st.phase == DECODING and i not in skip:
                bt[i, :len(st.pages)] = st.pages
        return bt

    def chunk_block_table(self, slot: int) -> np.ndarray:
        """(1, max_bt) int32: the table a prefill chunk writes through."""
        bt = np.zeros((1, self.max_bt), np.int32)
        pages = self.states[slot].pages
        bt[0, :len(pages)] = pages
        return bt

    def kv_cache_stats(self) -> dict:
        a = self.allocator
        return {
            "kv_layout": "paged",
            "page_size": self.page_size,
            "pool_pages": a.n_pages,
            "peak_pages_in_use": a.peak_in_use,
            "peak_pages_committed": a.peak_committed,
            "page_pool_utilization": round(a.utilization(), 4),
            "kv_cache_bytes": self.cache_bytes(),
        }


class ContinuousEngine:
    """Continuous-batching greedy decoding under one unified token-budget
    step, on the paged KV pool (``kv_layout="paged"``, and ``"auto"`` for
    the dense family) or on the contiguous cache (``"contiguous"``, and
    ``"auto"`` for the hybrid family, whose fixed-size recurrent state
    has no paged layout).

    Contiguous layout: admission runs the whole prompt, bucketed to the
    next power of two (floor 8, capped at max_seq; hybrid: its exact
    length, since recurrent state is length-exact), as one monolithic
    ``forward`` and grafts its cache into the slot's row; the sequence
    decodes from the next tick on.  Drafts are not verified there (no
    chunk machinery): plain decode proceeds.

    Paged layout: admission opens a sequence PREFILLING; every tick spends up to
    ``prefill_budget_tokens`` REAL prompt tokens across PREFILLING slots
    (FIFO by admission), each chunk bucketed to the next power of two
    (floor 8, capped at max_seq) with pads on the scratch page.
    ``prefill_budget_tokens=None`` lands each prompt as one chunk.

    Speculative draft verification: a DECODING slot holding drafts
    (``attach_drafts`` or a ``Request.draft_toks`` stream) verifies up
    to ``draft_k`` of them in ONE ``prefill_chunk`` pass instead of
    taking the tick's decode step; the emitted stream is token-for-token
    the plain greedy one whatever the drafts were.

    ``device`` (default ``"cuda"``) holds the cache and must be the
    params' device; on CUDA the decode attention runs the hand-written
    paged (or contiguous) decode kernel, and a contiguous admission's
    prefill the flash kernel (and, hybrid, the SSD scan kernel)."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_seq: int = 2048, queue_capacity: Optional[int] = None,
                 kv_layout: str = "auto", page_size: int = 16,
                 pool_pages: Optional[int] = None,
                 prefill_budget_tokens: Optional[int] = 64,
                 prefix_cache: bool = False, draft_k: int = 8,
                 mesh=None):
        T.require_ported(cfg, "ContinuousEngine")
        if kv_layout not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "auto":
            kv_layout = ("paged" if cfg.family in T.PAGED_FAMILIES
                         else "contiguous")
        if prefix_cache:
            raise NotImplementedError("prefix_cache is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        if draft_k < 1:
            raise ValueError("draft_k must be >= 1 (max draft tokens "
                             "verified per slot per tick)")
        if prefill_budget_tokens is not None and prefill_budget_tokens < 1:
            raise ValueError("prefill_budget_tokens must be >= 1 (or None "
                             "for an unbounded, monolithic-style tick)")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_seq = max_seq
        self.kv_layout = kv_layout
        self.prefill_budget_tokens = prefill_budget_tokens
        if kv_layout == "paged":
            self.slots = PagedSlotManager(cfg, n_slots, max_seq,
                                          page_size=page_size,
                                          pool_pages=pool_pages,
                                          device=self.device)
        else:
            self.slots = SlotManager(cfg, n_slots, max_seq,
                                     device=self.device)
        self.queue = RequestQueue(max_batch=n_slots, capacity=queue_capacity)
        self.draft_k = draft_k
        self.clock = 0                        # unified-step ticks
        self.finish_order: List[int] = []
        self.results: Dict[int, RequestResult] = {}
        self.last_tick_prefill_tokens = 0
        self.last_tick_decode_tokens = 0
        self.last_tick_verify_tokens = 0
        self.prefill_tokens_total = 0         # prompt tokens actually run
        self.decode_steps_total = 0           # batched decode steps run
        self.spec_verify_passes = 0           # one-chunk draft verifications
        self.spec_drafted_total = 0           # draft tokens verified
        self.spec_accepted_total = 0          # draft tokens accepted
        self.spec_draft_streams_dropped = 0   # streams whose first draft
        #                                       disagreed with the prefill
        self._spent_this_tick = 0
        self._verify_this_tick = 0
        self._tick_budget_left = self._budget()

    def clone_fresh(self) -> "ContinuousEngine":
        """A new engine with the same config, params and layout knobs and
        an EMPTY serving state: the reboot path (device KV, slots, queue
        and results do not survive a crash; a host checkpoint does, see
        ``serving.scheduler.PreemptiveScheduler.restore``)."""
        kw = dict(n_slots=self.slots.n_slots, max_seq=self.max_seq,
                  queue_capacity=self.queue.capacity,
                  kv_layout=self.kv_layout,
                  prefill_budget_tokens=self.prefill_budget_tokens,
                  draft_k=self.draft_k)
        if self.kv_layout == "paged":
            kw.update(page_size=self.slots.page_size,
                      pool_pages=self.slots.allocator.n_pages)
        return ContinuousEngine(self.cfg, self.params, **kw)

    def _budget(self):
        b = self.prefill_budget_tokens
        return float("inf") if b is None else b

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, device="cuda", **kw):
        """An engine with random params from a seeded generator on
        ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
        return cls(cfg, T.init_params(cfg, seed=seed, device=device), **kw)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> int:
        if req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: max_new must be >= 1 "
                "(the prefill always emits one token)")
        if len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_seq {self.max_seq}")
        if self.kv_layout == "paged" and not self.slots.fits_pool(req):
            raise ValueError(
                f"request {req.rid}: needs more KV pages than the whole "
                f"pool ({self.slots.allocator.n_pages} x "
                f"{self.slots.page_size}) — raise pool_pages")
        if req.draft_toks is not None:
            d = np.asarray(req.draft_toks)
            if d.ndim != 1:
                raise ValueError(
                    f"request {req.rid}: draft_toks must be 1-D token ids, "
                    f"got shape {d.shape}")
            req.draft_toks = d.astype(np.int32)
        return self.queue.submit(req)

    def _bucket_len(self, S: int) -> int:
        """Prefill bucket of a contiguous admission: next power of two
        (floor 8), clamped to max_seq, as the reference's jit buckets; a
        hybrid prompt runs at its exact length (recurrent state is
        length-exact), so one longer than the SSM chunk that is not a
        multiple of it raises in the scan, as in the reference."""
        if self.cfg.family == "hybrid":
            return S
        b = 8
        while b < S:
            b *= 2
        return min(b, self.max_seq)

    def _run_prefill(self, toks: np.ndarray):
        """Monolithic prefill of one bucketed prompt: (logits (1, S, V),
        its cache with leaves (L, 1, S, Hkv, D))."""
        logits, _, pcache = T.forward(self.params, self.cfg,
                                      {"tokens": self._tensor(toks)},
                                      return_cache=True)
        return logits, pcache

    def _admit(self, req: Request, slot: int) -> None:
        """Place ``req`` into ``slot``.  Paged: open it PREFILLING and
        spend what remains of this tick's prefill budget on its first
        chunk(s).  Contiguous: monolithic prefill and slot graft."""
        if self.kv_layout == "paged":
            self.slots.place_prefilling(slot, req, self.clock)
            self._pump_prefill(slot)
            return
        S = len(req.prompt)
        toks = np.zeros((1, self._bucket_len(S)), np.int32)
        toks[0, :S] = req.prompt
        logits, pcache = self._run_prefill(toks)
        row = logits[0, S - 1]
        first = int(torch.argmax(row))
        st = _SlotState(request=req, pos=S, next_tok=first, emitted=[first],
                        admitted_step=self.clock,
                        first_token_step=self.clock,
                        last_logits=row.cpu().numpy())
        self.slots.place(slot, pcache, st)
        if len(st.emitted) >= req.max_new:    # max_new == 1: done at prefill
            self._finish(slot)

    # -- chunked prefill ----------------------------------------------------
    def _chunk_bucket(self, C: int) -> int:
        """Bucket for a chunk of C real tokens: next power of two (floor
        8), clamped to max_seq — the reference's jit buckets, kept so
        every chunk runs the same pads and positions."""
        b = 8
        while b < C:
            b *= 2
        return min(b, self.max_seq)

    def _run_chunk(self, toks: np.ndarray, n_valid: int, pos_offset: int,
                   bt: np.ndarray) -> torch.Tensor:
        logits, _, self.slots.cache = T.prefill_chunk(
            self.params, self.cfg, self.slots.cache, self._tensor(toks),
            n_valid, pos_offset, self._tensor(bt))
        return logits

    def _pump_prefill(self, slot: int) -> None:
        """Spend the tick's remaining prefill-token budget streaming
        prompt chunks of ``slot``'s PREFILLING sequence into its pages.
        When the last chunk lands the sequence emits its first token and
        flips to DECODING (or finishes when ``max_new == 1``)."""
        st = self.slots.states[slot]
        req = st.request
        S = len(req.prompt)
        while st.phase == PREFILLING and self._tick_budget_left > 0:
            off = req.prefill_pos
            C = int(min(self._tick_budget_left, S - off))
            Cb = self._chunk_bucket(C)
            toks = np.zeros((1, Cb), np.int32)
            toks[0, :C] = req.prompt[off:off + C]
            self.slots.grow_for_chunk(slot, off + C)
            logits = self._run_chunk(toks, C, off,
                                     self.slots.chunk_block_table(slot))
            req.prefill_pos = off + C
            st.pos = off + C
            self._tick_budget_left -= C
            self._spent_this_tick += C
            self.prefill_tokens_total += C
            if req.prefill_pos >= S:
                row = logits[0, C - 1]
                first = int(torch.argmax(row))
                st.phase = DECODING
                st.next_tok = first
                st.emitted = [first]
                st.first_token_step = self.clock
                st.last_logits = row.cpu().numpy()
                if len(st.emitted) >= req.max_new:
                    self._finish(slot)
                elif req.draft_toks is not None and len(req.draft_toks):
                    # a draft stream rides the request: its head must
                    # reproduce the prefill token or the stream is stale
                    if int(req.draft_toks[0]) == first:
                        self.attach_drafts(slot, req.draft_toks[1:])
                    else:
                        self.spec_draft_streams_dropped += 1

    # -- speculative draft verification -------------------------------------
    def attach_drafts(self, slot: int, draft_toks) -> int:
        """Queue draft tokens on a DECODING slot for one-pass
        verification, clamped so drafts that could never be emitted are
        dropped here.  Returns the number queued (0 under the contiguous
        layout, which has no chunk machinery to verify through)."""
        st = self.slots.states[slot]
        if st is None or st.phase != DECODING:
            raise RuntimeError(
                f"slot {slot}: drafts need a DECODING occupant")
        if self.kv_layout != "paged":
            return 0
        rem = st.request.max_new - len(st.emitted)
        take = max(0, min(len(draft_toks), rem - 1 - len(st.drafts)))
        st.drafts.extend(int(t) for t in draft_toks[:take])
        return take

    def _verify_slot(self, slot: int) -> bool:
        """Verify up to ``draft_k`` pending drafts in ONE prefill-chunk
        pass over ``[next_tok, d_1..d_k]``: accept the longest prefix
        agreeing with the per-position argmaxes and emit the first
        disagreeing position's argmax — identical to ``n_ok + 1`` plain
        greedy steps.  KV of rejected positions sits past the new
        ``kv_len`` and stays masked.  Returns False when there is no
        room left to speculate."""
        st = self.slots.states[slot]
        req = st.request
        rem = req.max_new - len(st.emitted)
        k = min(len(st.drafts), self.draft_k, rem - 1)
        if k <= 0:
            st.drafts = []
            return False
        C = k + 1
        Cb = self._chunk_bucket(C)
        toks = np.zeros((1, Cb), np.int32)
        toks[0, 0] = st.next_tok
        toks[0, 1:C] = st.drafts[:k]
        self.slots.grow_for_chunk(slot, st.pos + C)
        logits = self._run_chunk(toks, C, st.pos,
                                 self.slots.chunk_block_table(slot))
        preds = torch.argmax(logits[0, :C], dim=-1).cpu().numpy()
        n_ok = 0
        while n_ok < k and int(preds[n_ok]) == st.drafts[n_ok]:
            n_ok += 1
        out = st.drafts[:n_ok] + [int(preds[n_ok])]
        rest = st.drafts[k:]
        # leftover drafts survive only a full acceptance whose bonus
        # token matches their head
        st.drafts = (rest[1:] if n_ok == k and rest and rest[0] == out[-1]
                     else [])
        st.emitted.extend(out)
        st.pos += n_ok + 1
        st.next_tok = out[-1]
        self.spec_verify_passes += 1
        self.spec_drafted_total += k
        self.spec_accepted_total += n_ok
        self._verify_this_tick += C
        if len(st.emitted) >= req.max_new:
            st.last_logits = logits[0, n_ok].cpu().numpy()
            self._finish(slot)
        return True

    def _verify_pending(self) -> set:
        """Run the verify pass for every DECODING slot holding drafts;
        returns the slots that advanced (they skip this tick's decode)."""
        verified = set()
        if self.kv_layout != "paged":
            return verified
        for slot in self.slots.decoding_slots():
            if self.slots.states[slot].drafts and self._verify_slot(slot):
                verified.add(slot)
        return verified

    def spec_stats(self) -> dict:
        """Speculative-verification counters (cumulative)."""
        return {"draft_k": self.draft_k,
                "verify_passes": self.spec_verify_passes,
                "drafted": self.spec_drafted_total,
                "accepted": self.spec_accepted_total,
                "draft_streams_dropped": self.spec_draft_streams_dropped}

    def _finish(self, slot: int) -> None:
        st = self.slots.states[slot]
        req = st.request
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=np.asarray(st.emitted, np.int32),
            prompt_len=len(req.prompt), admitted_step=st.admitted_step,
            finished_step=self.clock, first_token_step=st.first_token_step,
            n_preemptions=st.n_preemptions, logits_last=st.last_logits)
        self.finish_order.append(req.rid)
        self.slots.evict(slot)

    # -- the serve loop ----------------------------------------------------
    def _admit_arrivals(self) -> None:
        """Admit arrived requests (FIFO) into free slots while the page
        pool can cover the head request's worst-case lifetime."""
        for slot in self.slots.free_slots():
            req = self.queue.peek()
            if req is None or req.arrival_t > self.clock:
                break
            if not self.slots.can_admit(req):
                break                         # page pool exhausted: wait
            self._admit(self.queue.pop(), slot)

    def _prefilling_order(self) -> List[int]:
        """PREFILLING slots in admission order (FIFO, slot id ties)."""
        sl = self.slots
        return sorted(sl.prefilling_slots(),
                      key=lambda s: (sl.states[s].admitted_step, s))

    def _end_tick(self) -> None:
        self.last_tick_prefill_tokens = self._spent_this_tick
        self.last_tick_verify_tokens = self._verify_this_tick
        self.clock += 1
        self._spent_this_tick = 0
        self._verify_this_tick = 0
        self._tick_budget_left = self._budget()

    def _idle_tick(self) -> None:
        self.last_tick_decode_tokens = 0
        self._end_tick()

    def _decode_batch(self, skip=frozenset()) -> None:
        """ONE batched decode step over every DECODING slot (the others
        ride along masked to the scratch page) and evict finished
        sequences."""
        decoding = [s for s in self.slots.decoding_slots() if s not in skip]
        self.last_tick_decode_tokens = len(decoding)
        if not decoding:
            return
        toks, pos = self.slots.decode_inputs(skip)
        bt = None
        if self.kv_layout == "paged":
            self.slots.ensure_write_pages(skip)
            bt = self._tensor(self.slots.block_tables(skip))
        logits, self.slots.cache = T.decode_step(
            self.params, self.cfg, self.slots.cache, self._tensor(toks),
            self._tensor(pos), block_tables=bt)
        self.decode_steps_total += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for slot in decoding:
            st = self.slots.states[slot]
            st.emitted.append(int(nxt[slot]))
            st.next_tok = int(nxt[slot])
            st.pos += 1
            if len(st.emitted) >= st.request.max_new:
                # only finishing rows cross to the host (confidence gate)
                st.last_logits = logits[slot, 0].cpu().numpy()
                self._finish(slot)

    def _unified_step(self) -> None:
        """ONE unified token-budget tick: prefill chunks (FIFO), draft
        verify, then one batched decode over the remaining DECODING
        slots."""
        if not self.slots.any_active():
            self._idle_tick()                 # wait for arrivals
            return
        for slot in self._prefilling_order():
            if self._tick_budget_left <= 0:
                break
            self._pump_prefill(slot)
        verified = self._verify_pending()
        self._decode_batch(skip=verified)
        self._end_tick()

    def step(self) -> List[int]:
        """Admit arrivals, run one unified step; returns the rids
        finished during it."""
        before = len(self.finish_order)
        self._admit_arrivals()
        self._unified_step()
        return self.finish_order[before:]

    def run(self, requests: Optional[List[Request]] = None
            ) -> Dict[int, RequestResult]:
        """Drain: submit ``requests`` (sorted by arrival), then step until
        queue and slots are empty.  Returns rid -> RequestResult."""
        for r in sorted(requests or [], key=lambda r: r.arrival_t):
            self.submit(r)
        while len(self.queue) or self.slots.any_active():
            self.step()
        return self.results

    def kv_cache_stats(self) -> dict:
        """Cache-memory accounting: cache bytes and, for the paged layout,
        the pool's sizing knobs and peak page use."""
        return self.slots.kv_cache_stats()
