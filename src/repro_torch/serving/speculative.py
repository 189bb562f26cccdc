"""Speculative collaborative decoding — the paper's satellite-ground
cascade applied at TOKEN granularity: the twin of the JAX package's
``serving/speculative.py`` (numpy logic copied draw for draw).

The onboard (draft) tier proposes k tokens greedily; the ground (target)
tier verifies all k in ONE paged-attention pass and accepts the longest
matching prefix, emitting its own token at the first disagreement.
Greedy variant: the output is PROVABLY identical to decoding the ground
tier alone — the onboard tier only changes how many expensive ground
passes (and how many uplink round-trips, in the deployment) are needed.

Both tiers run on ``serving.engine.ContinuousEngine``, so every token is
KV-cached: the draft tier decodes k tokens at O(1) model work each, and
the target tier verifies them through the SAME ``prefill_chunk`` path
that admits prompts — one chunk of ``[last_token, d_1..d_k]`` written
straight into the target's paged KV, per-position argmaxes read back.
On CUDA engines every decode step of either tier runs the paged decode
kernel; the engines' device decides, as everywhere in the port.

The link ledger mirrors core/cascade.py: each verify round costs one
satellite->ground round trip carrying the drafted ids
(``core.link.payload_bytes_draft`` — tiny) instead of per-token round
trips, and only drafts that can actually be emitted are ever shipped or
metered (a final round near ``max_new`` drafts fewer tokens instead of
drafting ahead and truncating).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.core.link import payload_bytes_draft
from repro_torch.core.telemetry import Ledger
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import DECODING, ContinuousEngine
from repro_torch.serving.paging import pages_for


@dataclass
class SpecResult:
    tokens: np.ndarray                 # (n_new,) int32 final continuation
    rounds: int
    drafted: int
    accepted: int
    ledger: Ledger = field(default_factory=Ledger)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)


def _one_shot_engine(cfg: ModelConfig, params, S: int, max_new: int, *,
                     draft_k: int = 8) -> ContinuousEngine:
    """A single-slot engine sized exactly for one (S, max_new) request
    (paged families get a pool covering the whole reservation, so
    admission can never block)."""
    max_seq = S + max_new
    return ContinuousEngine(cfg, params, n_slots=1, max_seq=max_seq,
                            page_size=16,
                            pool_pages=pages_for(max_seq, 16) + 1,
                            prefill_budget_tokens=None, draft_k=draft_k)


def _slot_of(eng: ContinuousEngine, rid: int) -> Optional[int]:
    for i in eng.slots.active_slots():
        if eng.slots.states[i].request.rid == rid:
            return i
    return None


def _run_to_decoding(eng: ContinuousEngine, rid: int) -> Optional[int]:
    """Step until ``rid`` occupies a DECODING slot (its prompt is fully
    prefilled); None when it finished outright (tiny ``max_new``)."""
    while rid not in eng.results:
        slot = _slot_of(eng, rid)
        if slot is not None and eng.slots.states[slot].phase == DECODING:
            return slot
        eng.step()
    return None


def _emitted(eng: ContinuousEngine, rid: int, slot) -> List[int]:
    if rid in eng.results:
        return [int(t) for t in eng.results[rid].tokens]
    return [int(t) for t in eng.slots.states[slot].emitted]


class SpeculativeDecoder:
    """Drives a draft engine and a target engine through one greedy
    draft-and-verify generation.

    The draft engine's KV is steered along the TARGET's accepted stream:
    after each verify round the decoder rewinds the draft slot's
    position/input to the last accepted token — the paged layout masks
    everything beyond ``kv_len``, so rejected draft KV needs no cleanup
    — and force-writes (one tiny chunk, logits discarded) any accepted
    position whose KV the draft tier never produced itself (the bonus
    position of a fully accepted round).  Both engines must use the
    paged KV layout (the verify and force-write passes run through the
    chunk machinery).
    """

    def __init__(self, draft_engine: ContinuousEngine,
                 target_engine: ContinuousEngine, *, k: int = 4):
        if k < 1:
            raise ValueError("k must be >= 1 draft tokens per round")
        if k > target_engine.draft_k:
            raise ValueError(
                f"k={k} exceeds the target engine's draft_k="
                f"{target_engine.draft_k} — rounds would need multiple "
                "verify passes and the accounting below assumes one")
        for name, eng in (("draft", draft_engine),
                          ("target", target_engine)):
            if eng.kv_layout != "paged":
                raise NotImplementedError(
                    f"speculative decoding needs the paged KV layout on "
                    f"the {name} engine (family {eng.cfg.family!r} is "
                    "served contiguously)")
        self.draft = draft_engine
        self.target = target_engine
        self.k = k

    # -- draft-side KV steering --------------------------------------------
    def _force_extend(self, slot: int, toks, pos: int) -> None:
        """Write the KV of already-known tokens at positions
        [pos, pos + len(toks)) of the draft slot through the chunk
        path, discarding the logits — the catch-up for accepted tokens
        the draft engine never ran (the bonus token of a fully accepted
        round lands in the target's stream without a draft forward)."""
        eng = self.draft
        st = eng.slots.states[slot]
        n = len(toks)
        Cb = eng._chunk_bucket(n)
        buf = np.zeros((1, Cb), np.int32)
        buf[0, :n] = toks
        st.pos = int(pos)
        eng.slots.grow_for_chunk(slot, pos + n)
        eng._run_chunk(buf, n, pos, eng.slots.chunk_block_table(slot))

    # -- the draft-verify loop ---------------------------------------------
    def generate(self, prompt: np.ndarray, max_new: int = 16) -> SpecResult:
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be a single (S,) token sequence, got shape "
                f"{prompt.shape}")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        prompt = prompt.astype(np.int32)
        S = len(prompt)
        ledger = Ledger()
        rounds = drafted = accepted = 0
        tgt, drf = self.target, self.draft

        t_rid = tgt.submit(Request(prompt=prompt.copy(), max_new=max_new))
        t_slot = _run_to_decoding(tgt, t_rid)
        produced = _emitted(tgt, t_rid, t_slot)

        # the draft request's own continuation is discarded — its budget
        # only needs to keep the slot alive (never auto-finishing) while
        # the decoder steers it along the target's stream
        d_rid = drf.submit(Request(prompt=prompt.copy(),
                                   max_new=max_new + self.k + 2))
        d_slot = _run_to_decoding(drf, d_rid)
        d_synced = S           # draft-KV positions [0, d_synced) hold the
        #                        accepted (true) stream's inputs

        while len(produced) < max_new and t_rid not in tgt.results:
            rem = max_new - len(produced)
            k_eff = min(self.k, rem - 1)
            if k_eff < 1:
                tgt.step()     # the final token: nothing left to draft
                produced = _emitted(tgt, t_rid, t_slot)
                continue

            # steer the draft slot onto the accepted stream
            need = S + len(produced) - 1
            if need > d_synced:
                true_stream = np.concatenate(
                    [prompt, np.asarray(produced, np.int32)])
                self._force_extend(d_slot, true_stream[d_synced:need],
                                   d_synced)
                d_synced = need
            dst = drf.slots.states[d_slot]
            dst.pos = need
            dst.next_tok = int(produced[-1])
            dst.emitted = list(produced)

            # onboard tier drafts k_eff tokens, one KV-cached step each
            for _ in range(k_eff):
                drf.step()
            draft_toks = drf.slots.states[d_slot].emitted[len(produced):]
            drafted += k_eff

            # ground tier verifies all of them in ONE chunk pass
            n_shipped = tgt.attach_drafts(t_slot, draft_toks)
            before = len(produced)
            tgt.step()
            produced = _emitted(tgt, t_rid, t_slot)
            n_ok = len(produced) - before - 1
            accepted += n_ok
            rounds += 1
            ledger.add("verify_rounds", 1)
            ledger.add("uplink_bytes", payload_bytes_draft(n_shipped))
            # drafting wrote true inputs up to the first rejection (or,
            # on full acceptance, up to the last draft's position; the
            # bonus position is force-written next round)
            d_synced = need + min(n_ok + 1, k_eff)

        if _slot_of(drf, d_rid) is not None:
            drf.slots.evict(d_slot)           # return the draft pages
        ledger.add("tokens_produced", len(produced))
        return SpecResult(tokens=np.asarray(produced, np.int32),
                          rounds=rounds, drafted=drafted, accepted=accepted,
                          ledger=ledger)


def speculative_generate(draft_params, draft_cfg: ModelConfig,
                         target_params, target_cfg: ModelConfig,
                         prompt: np.ndarray, *, max_new: int = 16,
                         k: int = 4) -> SpecResult:
    """prompt: (S,) int32 (single sequence).  Greedy draft-and-verify;
    ``tokens`` is provably identical to ``greedy_generate`` on the
    target tier alone."""
    prompt = np.asarray(prompt)
    if prompt.ndim != 1:
        raise ValueError(
            f"prompt must be a single (S,) token sequence, got shape "
            f"{prompt.shape}")
    if k < 1:
        raise ValueError("k must be >= 1 draft tokens per round")
    S = len(prompt)
    drf = _one_shot_engine(draft_cfg, draft_params, S, max_new + k + 2)
    tgt = _one_shot_engine(target_cfg, target_params, S, max_new, draft_k=k)
    return SpeculativeDecoder(drf, tgt, k=k).generate(prompt, max_new)


def greedy_generate(params, cfg: ModelConfig, prompt: np.ndarray,
                    max_new: int = 16) -> np.ndarray:
    """Reference: plain greedy decoding of one sequence (KV-cached
    through the same engine the speculative path runs on)."""
    prompt = np.asarray(prompt)
    if prompt.ndim != 1:
        raise ValueError(
            f"prompt must be a single (S,) token sequence, got shape "
            f"{prompt.shape}")
    eng = _one_shot_engine(cfg, params, len(prompt), max_new)
    res = eng.run([Request(prompt=prompt.astype(np.int32),
                           max_new=max_new)])
    (result,) = res.values()
    return np.asarray(result.tokens, np.int32)
