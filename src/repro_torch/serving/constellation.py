"""Constellation-scale serving: K satellites, M ground stations — the twin
of the JAX package's ``serving/constellation.py``.

The paper's verification flew on the Tiansuan constellation, but
``serving.scheduler.SpaceGroundScheduler`` drives a single
onboard/ground pair on one periodic schedule.  The interesting systems
problems start when several cloud-native satellites contend for scarce
ground-station pass seconds (PAPERS.md: "Space-Based Computing
Networks"):

  * ``ContactPlanner`` — per tick, assigns each ground station to at
    most one satellite downlink lane (a station serves ONE lane per
    tick, and a satellite's single downlink radio serves one station).
    Assignment maximizes a *priority-to-value* objective per pass
    second: expected remaining tokens x the request priority weight
    (``1 + max(Request.priority, 0)`` — the default priority 0 still
    carries value) / pass cost, where a payload's "remaining tokens"
    are the tokens not yet on the ground and the pass cost is the ticks
    its backlog needs at the link rate.  ``policy="static"`` is the
    K-independent-pairs comparator: every satellite only ever talks to
    its home station (``sat % n_stations``), lowest index first on
    conflicts, no coordination.

  * ``ConstellationScheduler`` — drives K ``ContinuousEngine``s (one
    ``PreemptiveScheduler`` each) against per-(satellite, station)
    window sets (``ContactSchedule.step_window_sets``) on one shared
    tick clock, metering per-satellite energy/bytes through
    ``core.energy.FleetEnergy``.

  * **Inter-satellite handover** — when a sequence's owner loses its
    window (its next pass over ANY station starts later than a peer's
    by more than ``handover_margin_ticks``), the scheduler spills the
    sequence (the ``DeltaSpillStore`` record is the wire format — the
    same delta-merged, CRC-checksummed host snapshot every preemption
    produces), serializes it through ``checkpoint/store.py`` exactly as
    ``PreemptiveScheduler.checkpoint`` would, and ships the bytes over
    a framed ``TransmitLane`` (so faults and ARQ apply: corrupt frames
    are NACKed and retransmitted, an exhausted retry budget re-enqueues
    the payload).  The destination grafts it as a spilled swap entry —
    the ``restore`` path — and greedy decode continues **token-exactly**.
    A spill record that fails its checksum at serialization time takes
    the existing corruption->redo lane (``_redo_corrupt``: the source
    requeues the request from prefill; never a garbage graft).
    Finished-but-undelivered answers ride the same ISL as compact
    result payloads toward the satellite with the earliest pass.

Determinism: same traces + same window sets + same fault plan => same
tokens, handovers, assignments and ledgers.  The handover wire format is
the reference's: KV leaves in ``jax.tree_util`` order (``repro_torch.tree``),
bf16 stored as its 16-bit pattern, so a payload either package packs
grafts in the other.  On CUDA engines every decode step of every
satellite runs the paged decode kernel.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.store import load_checkpoint_raw, save_checkpoint
from repro_torch.core.energy import EnergyModel, FleetEnergy
from repro_torch.core.faults import FaultInjector
from repro_torch.core.link import LinkModel, TransmitLane, \
    payload_bytes_result
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import ContinuousEngine, _PagedSlotState
from repro_torch.serving.paging import SpillCorruption
from repro_torch.serving.scheduler import PreemptiveScheduler, SwapEntry
from repro_torch.tree import tree_leaves, tree_unflatten


def priority_weight(priority: int) -> float:
    """Positive value weight for the planner objective — priority 0
    (the default) must still carry value, so the weight floors at 1."""
    return 1.0 + max(int(priority), 0)


# ==========================================================================
# pass-second assignment
# ==========================================================================

@dataclass
class ContactPlanner:
    """Assigns ground-station pass seconds to satellite downlink lanes.

    ``window_sets`` maps (satellite, station) -> tick-quantized
    ``[(lo, hi))`` visibility windows.  Capacity discipline (the
    property suite gates these): per tick, at most one satellite per
    station and one station per satellite — assigned pass seconds per
    tick never exceed ``n_stations * s_per_step``.
    """
    window_sets: Dict[Tuple[int, int], List[Tuple[int, int]]]
    n_satellites: int
    n_stations: int
    policy: str = "value"            # "value" | "static" (home stations)

    def __post_init__(self):
        if self.policy not in ("value", "static"):
            raise ValueError(f"unknown planner policy {self.policy!r}")

    def in_window(self, sat: int, station: int, t: int) -> bool:
        return any(lo <= t < hi
                   for lo, hi in self.window_sets.get((sat, station), []))

    def open_pairs(self, t: int) -> List[Tuple[int, int]]:
        return [(k, m) for k in range(self.n_satellites)
                for m in range(self.n_stations) if self.in_window(k, m, t)]

    def next_open(self, sat: int, t: int) -> Optional[int]:
        """Earliest tick >= t at which ``sat`` sees ANY station (the
        handover trigger compares these across the fleet)."""
        best: Optional[int] = None
        for m in range(self.n_stations):
            for lo, hi in self.window_sets.get((sat, m), []):
                if hi <= t:
                    continue
                cand = max(lo, t)
                if best is None or cand < best:
                    best = cand
        return best

    def assign(self, t: int,
               demands: Dict[int, Tuple[float, float]]) -> Dict[int, int]:
        """station -> satellite for tick ``t``.  ``demands`` maps each
        satellite to (value, cost): the priority-weighted undelivered
        tokens queued on its downlink lane and the ticks its backlog
        needs at the link rate.  Zero-value satellites are never
        assigned — a station tick spent on an empty lane is a pass
        second another lane could have used."""
        out: Dict[int, int] = {}
        if self.policy == "static":
            for k in range(self.n_satellites):
                m = k % self.n_stations
                v, _ = demands.get(k, (0.0, 1.0))
                if v > 0 and m not in out and self.in_window(k, m, t):
                    out[m] = k
            return out
        cands = []
        for k, m in self.open_pairs(t):
            v, c = demands.get(k, (0.0, 1.0))
            if v <= 0:
                continue
            # deterministic total order: score desc, then sat, station
            cands.append((-(v / max(c, 1.0)), k, m))
        busy_sats: set = set()
        for _, k, m in sorted(cands):
            if m in out or k in busy_sats:
                continue
            out[m] = k
            busy_sats.add(k)
        return out


# ==========================================================================
# handover serialization (checkpoint/store wire format)
# ==========================================================================

def pack_sequence(path: str, entry: SwapEntry, kv,
                  preempted_step: int) -> int:
    """Serialize one spilled sequence through ``checkpoint/store.py`` —
    the single-sequence slice of ``PreemptiveScheduler.checkpoint``'s
    schema (kv leaves + prompt + last logits in the tree; request and
    slot-state fields in the meta).  ``kv`` is a host snapshot (CPU
    tensors).  Returns the on-disk byte count, which is what the ISL
    lane meters."""
    st = entry.state
    req = st.request
    tree: Dict[str, object] = {"prompt": np.asarray(req.prompt)}
    n = 0
    if kv is not None:
        leaves = tree_leaves(kv)
        for i, leaf in enumerate(leaves):
            tree[f"kv/{i}"] = leaf
        n = len(leaves)
    if st.last_logits is not None:
        tree["logits"] = np.asarray(st.last_logits)
    meta = {
        "rid": int(req.rid), "max_new": int(req.max_new),
        "arrival_t": float(req.arrival_t), "priority": int(req.priority),
        "prefill_pos": int(req.prefill_pos),
        "pos": int(st.pos), "next_tok": int(st.next_tok),
        "emitted": [int(x) for x in st.emitted],
        "admitted_step": int(st.admitted_step),
        "first_token_step": int(st.first_token_step),
        "phase": st.phase, "n_preemptions": int(st.n_preemptions),
        "preempted_step": int(preempted_step),
        "n_kv_leaves": n,
        "drafts": [int(x) for x in st.drafts],
    }
    return save_checkpoint(path, tree, meta=meta)


def pack_request(path: str, req: Request) -> int:
    """Serialize a not-yet-admitted request (no KV to move — the
    destination prefills it from scratch)."""
    meta = {
        "rid": int(req.rid), "max_new": int(req.max_new),
        "arrival_t": float(req.arrival_t), "priority": int(req.priority),
        "prefill_pos": 0, "n_kv_leaves": -1,   # -1: queued, not a snapshot
    }
    return save_checkpoint(path, {"prompt": np.asarray(req.prompt)},
                           meta=meta)


def graft_sequence(dst: PreemptiveScheduler, path: str) -> int:
    """Rebuild a shipped sequence on the destination satellite — the
    ``PreemptiveScheduler.restore`` graft for ONE sequence: a fresh
    fully-private ``_PagedSlotState`` budgeted for its whole lifetime
    enters the swap ledger as a spilled entry; the next free slot
    resumes it token-exactly from the shipped KV (grafted onto the
    destination pool's device and dtype at resume; the last logits stay
    on the host, as the engine keeps them).  Returns the rid."""
    leaves, meta = load_checkpoint_raw(path)
    rid = int(meta["rid"])
    req = Request(prompt=leaves["prompt"].numpy(),
                  max_new=int(meta["max_new"]), rid=rid,
                  arrival_t=float(meta["arrival_t"]),
                  priority=int(meta["priority"]),
                  prefill_pos=int(meta["prefill_pos"]))
    n = int(meta["n_kv_leaves"])
    if n < 0:                                  # queued: no state to graft
        dst.submit(req)
        return rid
    slots = dst.engine.slots
    kv = None
    if n:
        kv = tree_unflatten(slots.cache,
                            [leaves[f"kv/{i}"] for i in range(n)])
    logits = leaves.get("logits")
    st = _PagedSlotState(
        request=req, pos=int(meta["pos"]), next_tok=int(meta["next_tok"]),
        emitted=[int(x) for x in meta["emitted"]],
        admitted_step=int(meta["admitted_step"]),
        first_token_step=int(meta["first_token_step"]),
        phase=meta["phase"], n_preemptions=int(meta["n_preemptions"]),
        last_logits=None if logits is None else logits.numpy(),
        drafts=[int(x) for x in meta.get("drafts", [])],
        pages=[], budget=slots._lifetime_pages(req),
        synced_pages=0, shared_pages=0)
    dst.swapped[rid] = SwapEntry(state=st, kv=kv,
                                 preempted_step=int(meta["preempted_step"]),
                                 spilled=True)
    return rid


# ==========================================================================
# the constellation scheduler
# ==========================================================================

@dataclass
class ConstellationReport:
    """Final answers plus the fleet ledger of one constellation replay."""
    tokens: Dict[int, np.ndarray]       # rid -> delivered token stream
    delivered_tick: Dict[int, int]      # rid -> tick the answer landed
    goodput: float                      # delivered tokens / drain ticks
    delivered_tokens: int
    final_clock: int
    n_handovers: int                    # live sequences grafted on a peer
    n_result_forwards: int              # finished answers routed via ISL
    n_handover_redos: int               # corrupt spill record -> redo
    undelivered: List[int]
    fleet: List[Dict[str, float]]       # per-satellite ledger summaries
    fleet_totals: Dict[str, float]
    within_energy_budget: bool
    assigned_pass_ticks: int            # station-ticks granted by the planner
    sat_stats: List[dict] = field(default_factory=list)
    lane_stats: List[dict] = field(default_factory=list)
    isl_stats: List[dict] = field(default_factory=list)


class ConstellationScheduler:
    """K satellite engines, M ground stations, one shared tick clock.

    Per tick: (1) the ``ContactPlanner`` grants stations to the
    highest priority-to-value downlink backlogs; (2) granted lanes
    drain one tick of bytes (framed ARQ when ``frame_bytes`` is set —
    completed result payloads are *delivered*); (3) inter-satellite
    lanes drain (completed handover payloads graft on their
    destination, forwarded results join the destination's downlink
    lane); (4) window-poor satellites hand live sequences to
    window-rich peers; (5) every satellite takes one unified engine
    step (decode when it has work, an idle tick otherwise, so the K
    clocks stay in lockstep).  When the fleet is only waiting on a
    future pass, the clock jumps there — drain time is what goodput is
    measured against.
    """

    def __init__(self, engines: List[ContinuousEngine], *,
                 window_sets: Dict[Tuple[int, int], List[Tuple[int, int]]],
                 n_stations: int, s_per_step: float = 1.0,
                 horizon_s: float = 7200.0, policy: str = "value",
                 handover: bool = True, handover_margin_ticks: int = 64,
                 link: LinkModel = LinkModel(), isl_mbps: float = 100.0,
                 frame_bytes: Optional[int] = None,
                 link_max_retries: int = 8,
                 faults: Optional[FaultInjector] = None,
                 energy: Optional[EnergyModel] = None,
                 spill_codec: Optional[str] = None):
        if not engines:
            raise ValueError("a constellation needs at least one satellite")
        for e in engines:
            if not hasattr(e.slots, "allocator"):
                raise ValueError("constellation handover needs the paged "
                                 "KV layout (spill records are pages)")
            if getattr(e.slots, "prefix_index", None) is not None:
                raise ValueError(
                    "constellation engines must run prefix_cache=False: "
                    "spill records are in private-page coordinates, and a "
                    "shared prefix pinned on the source pool cannot ride "
                    "the handover wire")
        self.n_sats = len(engines)
        self.n_stations = n_stations
        self.s_per_step = s_per_step
        self.horizon_steps = int(horizon_s // s_per_step)
        self.handover = handover
        self.margin = int(handover_margin_ticks)
        self.faults = faults
        if faults is not None:
            window_sets = {pair: faults.truncate_step_windows(list(w))
                           for pair, w in sorted(window_sets.items())}
        self.planner = ContactPlanner(dict(window_sets), self.n_sats,
                                      n_stations, policy=policy)
        self.sats = [PreemptiveScheduler(e, delta_spill=True,
                                         spill_codec=spill_codec,
                                         fault_injector=faults)
                     for e in engines]
        lane_inj = faults if frame_bytes is not None else None
        self.lanes = [TransmitLane(frame_bytes=frame_bytes,
                                   max_retries=link_max_retries,
                                   injector=lane_inj)
                      for _ in engines]
        self.isl = [TransmitLane(frame_bytes=frame_bytes,
                                 max_retries=link_max_retries,
                                 injector=lane_inj)
                    for _ in engines]
        self.bytes_per_step = s_per_step / link.downlink_time_s(1.0)
        self.isl_bytes_per_step = isl_mbps * 1e6 / 8.0 * s_per_step
        self.fleet = FleetEnergy(self.n_sats, energy)
        self._tmp = tempfile.TemporaryDirectory(prefix="constellation_")
        self._n_packed = 0
        # bookkeeping
        self.tokens: Dict[int, np.ndarray] = {}      # finished rid -> toks
        self.delivered_tick: Dict[int, int] = {}
        self._payload_value: Dict[int, float] = {}   # undelivered results
        self._priority: Dict[int, int] = {}          # rid -> Request.priority
        self.n_handovers = 0
        self.n_result_forwards = 0
        self.n_handover_redos = 0
        self.assigned_pass_ticks = 0
        self.last_assignment: Dict[int, int] = {}

    # -- clock / work state --------------------------------------------------
    @property
    def clock(self) -> int:
        return self.sats[0].engine.clock

    def _set_clock(self, t: int) -> None:
        for s in self.sats:
            s.engine.clock = t

    def engine_work(self) -> bool:
        return any(s.has_work() for s in self.sats)

    def lanes_pending(self) -> bool:
        return any(len(l) for l in self.lanes) or any(len(l)
                                                      for l in self.isl)

    def has_work(self) -> bool:
        return self.engine_work() or self.lanes_pending()

    def ownership(self) -> Dict[int, List[int]]:
        """rid -> list of satellites that currently hold the sequence
        (queued, swapped or active).  The property suite gates every
        list at length 1 — a handover must never double-own: the source
        forgets the sequence before the wire ships it, and a payload in
        flight is owned by the wire alone."""
        own: Dict[int, List[int]] = {}
        for k, sat in enumerate(self.sats):
            eng = sat.engine
            rids = ([r.rid for r in eng.queue.items()]
                    + list(sat.swapped)
                    + [eng.slots.states[s].request.rid
                       for s in eng.slots.active_slots()])
            for rid in rids:
                own.setdefault(rid, []).append(k)
        return own

    # -- demand / value accounting ------------------------------------------
    def _lane_demand(self, k: int) -> Tuple[float, float]:
        """(priority-weighted undelivered tokens, ticks of backlog) for
        satellite ``k``'s downlink lane — the planner objective's value
        and pass-cost terms."""
        value = sum(self._payload_value.get(item[1], 0.0)
                    for item in self.lanes[k].pending_items())
        cost = -(-self.lanes[k].pending_bytes() // self.bytes_per_step)
        return value, max(float(cost), 1.0)

    @staticmethod
    def _remaining_tokens(st) -> int:
        return max(st.request.max_new - len(st.emitted), 0)

    # -- tick phases ---------------------------------------------------------
    def _downlink_phase(self, t: int) -> None:
        demands = {k: self._lane_demand(k) for k in range(self.n_sats)}
        self.last_assignment = self.planner.assign(t, demands)
        for m, k in sorted(self.last_assignment.items()):
            lane = self.lanes[k]
            sent0 = lane.bytes_sent
            for item in lane.tick(self.bytes_per_step):
                rid = item[1]
                self.delivered_tick[rid] = t + 1
                self._payload_value.pop(rid, None)
            for item, nbytes in lane.take_failed():
                lane.enqueue(item, nbytes)     # answers are never dropped
            self.fleet.charge_downlink(k, self.s_per_step,
                                       lane.bytes_sent - sent0)
            self.assigned_pass_ticks += 1

    def _isl_phase(self, t: int) -> None:
        for src in range(self.n_sats):
            lane = self.isl[src]
            if not len(lane):
                continue
            sent0 = lane.bytes_sent
            for item in lane.tick(self.isl_bytes_per_step):
                kind, rid, dst = item[0], item[1], item[2]
                if kind == "seq":
                    graft_sequence(self.sats[dst], item[3])
                    os.unlink(item[3])
                else:                          # forwarded finished answer
                    self.lanes[dst].enqueue(
                        ("result", rid),
                        payload_bytes_result(len(self.tokens[rid])))
            for item, nbytes in lane.take_failed():
                lane.enqueue(item, nbytes)
            self.fleet.charge_isl(src, self.s_per_step,
                                  lane.bytes_sent - sent0)

    def _handover_candidate(self, k: int):
        """Highest-value unfinished sequence on satellite ``k``:
        ("active", slot) / ("swapped", rid) / ("queued", req), by
        priority-weighted remaining tokens, rid-tie-broken."""
        sat = self.sats[k]
        eng = sat.engine
        cands = []
        for slot in eng.slots.active_slots():
            st = eng.slots.states[slot]
            cands.append((self._remaining_tokens(st)
                          * priority_weight(st.request.priority),
                          -st.request.rid, "active", slot))
        for rid, e in sat.swapped.items():
            if not e.spilled:
                continue   # resident entries pin source-pool pages; the
                #            default preempt mode here is always "spill"
            cands.append((self._remaining_tokens(e.state)
                          * priority_weight(e.priority),
                          -rid, "swapped", rid))
        for r in eng.queue.arrived(eng.clock):
            cands.append((r.max_new * priority_weight(r.priority),
                          -r.rid, "queued", r))
        cands = [c for c in cands if c[0] > 0]
        return max(cands) if cands else None

    def _ship(self, k: int, dst: int, cand) -> None:
        """Spill -> serialize -> enqueue one sequence on the ISL lane.
        A corrupt spill record takes the redo lane instead (the source
        requeues from prefill; the handover is aborted)."""
        sat = self.sats[k]
        _, _, kind, obj = cand
        path = os.path.join(self._tmp.name, f"ho_{self._n_packed}.ckpt")
        self._n_packed += 1
        if kind == "queued":
            sat.engine.queue.take(obj)
            nbytes = pack_request(path, obj)
            rid = obj.rid
        else:
            if kind == "active":
                rid = sat.preempt(obj, "spill")
            else:
                rid = obj
            entry = sat.swapped.pop(rid)
            kv = entry.kv
            if (kv is None and sat.store is not None
                    and rid in sat.store):
                try:
                    kv = sat.store.snapshot(rid)   # the wire-format record
                except SpillCorruption:
                    sat._redo_corrupt(entry)       # existing redo lane —
                    self.n_handover_redos += 1     # never a garbage graft
                    return
            if sat.store is not None:
                sat.store.drop(rid)                # the source forgets it
            nbytes = pack_sequence(path, entry, kv, entry.preempted_step)
        self.isl[k].enqueue(("seq", rid, dst, path), nbytes)
        self.n_handovers += 1

    def _handover_phase(self, t: int) -> None:
        if not self.handover:
            return
        for k in range(self.n_sats):
            if len(self.isl[k]):               # one transfer in flight
                continue
            if not self.sats[k].has_work():
                continue
            mine = self.planner.next_open(k, t)
            best_peer, best_t = None, None
            for j in range(self.n_sats):
                if j == k:
                    continue
                nxt = self.planner.next_open(j, t)
                if nxt is not None and (best_t is None or nxt < best_t):
                    best_peer, best_t = j, nxt
            if best_peer is None:
                continue
            if mine is not None and mine <= best_t + self.margin:
                continue                       # owner keeps its window
            cand = self._handover_candidate(k)
            if cand is not None:
                self._ship(k, best_peer, cand)

    def _route_result(self, k: int, rid: int, t: int) -> None:
        res = self.sats[k].results[rid]
        toks = np.asarray(res.tokens)
        self.tokens[rid] = toks
        self._payload_value[rid] = (
            len(toks) * priority_weight(self._priority.get(rid, 0)))
        nbytes = payload_bytes_result(len(toks))
        dst = k
        if self.handover and self.planner.policy == "value":
            mine = self.planner.next_open(k, t)
            for j in range(self.n_sats):
                if j == k:
                    continue
                nxt = self.planner.next_open(j, t)
                if nxt is not None and (mine is None
                                        or nxt + self.margin < mine):
                    dst, mine = j, nxt
        if dst == k:
            self.lanes[k].enqueue(("result", rid), nbytes)
        else:
            self.isl[k].enqueue(("result", rid, dst), nbytes)
            self.n_result_forwards += 1

    def _decode_phase(self, t: int) -> None:
        for k, sat in enumerate(self.sats):
            if sat.has_work():
                finished = sat.step(decode=True)
                self.fleet.charge_compute(k, 1, self.s_per_step)
                for rid in finished:
                    self._route_result(k, rid, t)
            else:
                sat.step(decode=False)         # lockstep idle tick

    def _maybe_sleep(self) -> None:
        """Nothing to compute, nothing on the ISL, backlog waiting on a
        pass: jump the shared clock to the earliest useful event (next
        window of a backlogged satellite, or the next arrival)."""
        if self.engine_work() or any(len(l) for l in self.isl):
            return
        t = self.clock
        nxts = [self.planner.next_open(k, t)
                for k in range(self.n_sats) if len(self.lanes[k])]
        nxts = [n for n in nxts if n is not None]
        if nxts:
            nxt = min(nxts)
            if nxt > t:
                self._set_clock(min(nxt, self.horizon_steps))
        elif self.lanes_pending():
            # a backlog with no pass left in the horizon can never land:
            # end the replay; the report surfaces it as undelivered
            self._set_clock(self.horizon_steps)

    def tick(self) -> None:
        t = self.clock
        self._downlink_phase(t)
        self._isl_phase(t)
        self._handover_phase(t)
        self._decode_phase(t)
        self._maybe_sleep()

    # -- the replay ----------------------------------------------------------
    def run(self,
            assignments: List[List[Request]]) -> ConstellationReport:
        """Drain ``assignments`` (``assignments[k]`` arrives via
        satellite ``k``'s uplink) against the window sets, then report.
        """
        if len(assignments) != self.n_sats:
            raise ValueError(f"expected {self.n_sats} per-satellite "
                             f"request lists, got {len(assignments)}")
        for k, reqs in enumerate(assignments):
            for r in sorted(reqs, key=lambda r: r.arrival_t):
                self.sats[k].submit(r)
                self._priority[r.rid] = r.priority
        while self.clock < self.horizon_steps and self.has_work():
            self.tick()
        return self.report()

    def report(self) -> ConstellationReport:
        delivered = sorted(self.delivered_tick)
        undone = set(self.tokens) - set(self.delivered_tick)
        undone |= set(self.ownership())          # unfinished sequences
        for lane in self.isl:                    # payloads still on the wire
            undone |= {item[1] for item in lane.pending_items()}
        undelivered = sorted(undone)
        n_tokens = sum(len(self.tokens[rid]) for rid in delivered)
        clock = max(self.clock, 1)
        horizon_s = self.horizon_steps * self.s_per_step
        return ConstellationReport(
            tokens={rid: self.tokens[rid] for rid in delivered},
            delivered_tick=dict(self.delivered_tick),
            goodput=n_tokens / clock,
            delivered_tokens=n_tokens,
            final_clock=self.clock,
            n_handovers=self.n_handovers,
            n_result_forwards=self.n_result_forwards,
            n_handover_redos=self.n_handover_redos,
            undelivered=undelivered,
            fleet=[dict(l.counters) for l in self.fleet.ledgers],
            fleet_totals=self.fleet.totals(),
            within_energy_budget=self.fleet.within_budget(horizon_s),
            assigned_pass_ticks=self.assigned_pass_ticks,
            sat_stats=[s.stats() for s in self.sats],
            lane_stats=[l.state() for l in self.lanes],
            isl_stats=[l.state() for l in self.isl])
