"""Space-ground link model (paper Table 1 + section II): a copy of the
JAX package's ``core/link.py`` (numpy and the standard library only):
``LinkModel``, ``ContactSchedule`` (its ``windows``, ``in_contact``,
``next_window``, ``step_windows``
and a constellation's per-(satellite, station) window sets), the
``TransmitLane`` with its framed ARQ, and the payload sizes.

Baoyun: 500+-50 km orbit, uplink 0.1-1 Mbps, downlink >= 40 Mbps; the
downlink is only available during ground-station contact windows, and
packet loss on the downlink can be severe (one mission lost 80% of
packets [paper ref 12])."""
from __future__ import annotations

import struct
import zlib
from collections import deque
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

SECONDS_PER_DAY = 86_400.0


@dataclass(frozen=True)
class LinkModel:
    uplink_mbps: float = 1.0
    downlink_mbps: float = 40.0
    packet_loss: float = 0.05          # fraction of packets lost (retried)
    packet_bytes: int = 1024
    orbital_altitude_km: float = 500.0

    @property
    def orbital_period_s(self) -> float:
        # Kepler: T = 2*pi*sqrt(a^3/mu), a = R_e + h
        mu = 3.986004418e14
        a = (6371.0 + self.orbital_altitude_km) * 1e3
        return 2.0 * np.pi * np.sqrt(a ** 3 / mu)

    def downlink_time_s(self, nbytes: float) -> float:
        """Expected transfer time incl. loss-retransmit overhead."""
        eff = self.downlink_mbps * 1e6 / 8.0 * (1.0 - self.packet_loss)
        return nbytes / eff

    def uplink_time_s(self, nbytes: float) -> float:
        eff = self.uplink_mbps * 1e6 / 8.0 * (1.0 - self.packet_loss)
        return nbytes / eff

    def deliver(self, nbytes: int, rng: np.random.Generator) -> Tuple[int, int]:
        """Simulate packetized delivery.  Returns (delivered_packets,
        retransmitted_packets)."""
        n_pkts = -(-nbytes // self.packet_bytes)
        retrans = int(rng.binomial(n_pkts, self.packet_loss))
        return n_pkts, retrans


@dataclass(frozen=True)
class ContactSchedule:
    """Ground-station visibility: a LEO satellite sees a given station
    for ~8 minutes, a handful of passes per day."""
    link: LinkModel = LinkModel()
    contact_duration_s: float = 480.0
    contacts_per_day: int = 6
    seed: int = 0

    def windows(self, horizon_s: float) -> List[Tuple[float, float]]:
        """Deterministic pseudo-random contact windows over a horizon.

        Dense schedules (``contact_duration_s`` >= the inter-contact
        period) have no slack to jitter within: the slack term clamps
        to zero and each pass starts no earlier than the previous pass
        ends, so windows never silently overlap.  Sparse schedules draw
        the identical jitter stream they always did.
        """
        rng = np.random.default_rng(self.seed)
        period = SECONDS_PER_DAY / self.contacts_per_day
        slack = max(period - self.contact_duration_s, 0.0)
        out = []
        t, prev_end = 0.0, 0.0
        while t < horizon_s:
            start = max(t + float(rng.uniform(0.2, 0.8)) * slack, prev_end)
            if start >= horizon_s:     # clamped starts can outrun the
                break                  # horizon once passes back up
            out.append((start, min(start + self.contact_duration_s,
                                   horizon_s)))
            prev_end = start + self.contact_duration_s
            t += period
        return out

    def in_contact(self, t: float, horizon_s: float = SECONDS_PER_DAY) -> bool:
        return any(a <= t < b for a, b in self.windows(horizon_s))

    def next_window(self, t: float, horizon_s: float = SECONDS_PER_DAY):
        for a, b in self.windows(horizon_s):
            if b > t:
                return (max(a, t), b)
        return None

    def step_windows(self, s_per_step: float,
                     horizon_s: float) -> List[Tuple[int, int]]:
        """Contact windows quantized to engine decode-step ticks
        [start_step, end_step) — the clock base the preemptive scheduler
        runs on (``serving.scheduler``).  A window shorter than one step
        still claims the tick it lands in: the downlink pass always
        preempts at least one decode step."""
        out = []
        for a, b in self.windows(horizon_s):
            if b <= a:
                continue         # start past the horizon, end clamped to
                #                  it: zero-capacity, not a real pass
            lo = int(a // s_per_step)
            hi = max(int(-(-b // s_per_step)), lo + 1)
            out.append((lo, hi))
        return out

    # -- constellation extension -------------------------------------------
    def for_pair(self, satellite: int, station: int,
                 contacts_per_day: Optional[int] = None,
                 contact_duration_s: Optional[float] = None,
                 ) -> "ContactSchedule":
        """The (satellite, station) member of a constellation's window
        set: same link and pass geometry, an independent deterministic
        jitter stream derived from the base seed.  Different orbital
        planes see a station with different pass rates, so the per-pair
        density/duration may be overridden."""
        return replace(
            self,
            seed=self.seed * 1_000_003 + satellite * 1009 + station,
            contacts_per_day=(self.contacts_per_day if contacts_per_day
                              is None else contacts_per_day),
            contact_duration_s=(self.contact_duration_s if
                                contact_duration_s is None else
                                contact_duration_s))

    def step_window_sets(self, s_per_step: float, horizon_s: float, *,
                         n_satellites: int, n_stations: int,
                         contacts_per_day=None, contact_duration_s=None,
                         ) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
        """Per-(satellite, station) tick-quantized window sets — the
        visibility input of ``serving.constellation``.  The optional
        ``contacts_per_day`` / ``contact_duration_s`` accept either a
        scalar (uniform constellation) or a length-``n_satellites``
        sequence (asymmetric orbits: a plane with a poor station
        geometry gets fewer/shorter passes)."""
        def pick(v, k, default):
            if v is None:
                return default
            if isinstance(v, (list, tuple)):
                return v[k]
            return v

        return {
            (k, m): self.for_pair(
                k, m,
                contacts_per_day=pick(contacts_per_day, k,
                                      self.contacts_per_day),
                contact_duration_s=pick(contact_duration_s, k,
                                        self.contact_duration_s),
            ).step_windows(s_per_step, horizon_s)
            for k in range(n_satellites) for m in range(n_stations)}


_BACKOFF_CAP_TICKS = 8


class _Frame:
    """One fixed-size slice of a payload on the framed lane."""
    __slots__ = ("nbytes", "data", "crc", "attempts", "eligible_tick",
                 "delivered")

    def __init__(self, nbytes: float, data: bytes):
        self.nbytes = float(nbytes)
        self.data = data                      # synthetic on-the-wire bytes
        self.crc = zlib.crc32(data)           # computed at the SENDER
        self.attempts = 0
        self.eligible_tick = 0                # NACK backoff gate
        self.delivered = False


class _FramedPayload:
    __slots__ = ("item", "nbytes", "frames", "n_delivered", "failed")

    def __init__(self, item, nbytes: float, frames: List[_Frame]):
        self.item = item
        self.nbytes = float(nbytes)
        self.frames = frames
        self.n_delivered = 0
        self.failed = False


class TransmitLane:
    """The downlink half of the overlapped contact pipeline.

    A FIFO of queued payloads drained *incrementally* against a per-tick
    byte budget, so a scheduler can interleave one decode step with one
    tick of transmission instead of holding the compute for a whole
    pass.  A payload larger than one tick's budget carries its partial
    progress across ticks (and across windows — an unfinished head
    simply waits for the next pass).

    ``tick(budget)`` returns the items whose transmission *completed*
    this tick, in FIFO order.  Determinism: same enqueues + same budgets
    (+ same fault plan) => same completion ticks and byte ledger.

    Two modes:

    * **Unframed** (default, ``frame_bytes=None``): the original
      byte-granular lane — a perfect link, partial progress carries at
      float precision.
    * **Framed** (``frame_bytes=N``): each payload is split into fixed
      ``N``-byte frames (last one partial).  Every frame carries real
      synthetic header bytes and a CRC32 computed at the sender; the
      receiver recomputes the CRC on what actually arrived, so a
      bit-flipped frame is *detected*, never silently delivered.  Lost
      and corrupt frames are NACKed and retransmitted with exponential
      per-tick backoff under a bounded per-frame retry budget
      (``max_retries`` attempts); a frame that exhausts its budget fails
      the whole payload, which is surfaced via :meth:`take_failed` for
      the caller to re-enqueue.  An optional
      :class:`core.faults.FaultInjector` decides each frame's
      in-transit fate; without one the framed lane is lossless.

    Framed byte ledger (conserved every tick):
    ``frame_bytes_attempted == bytes_sent + bytes_lost + bytes_corrupt``
    where ``bytes_sent`` keeps its unframed meaning — *goodput*, bytes
    that arrived intact — so callers metering delivered bytes read the
    same counter in both modes.
    """

    def __init__(self, *, frame_bytes: Optional[int] = None,
                 max_retries: int = 8, injector=None):
        if frame_bytes is not None and frame_bytes <= 0:
            raise ValueError("frame_bytes must be positive")
        if injector is not None and frame_bytes is None:
            raise ValueError("a FaultInjector needs a framed lane "
                             "(frame_bytes=...) to act on")
        self.frame_bytes = frame_bytes
        self.max_retries = int(max_retries)
        self.injector = injector
        self._q: deque = deque()   # unframed: [item, rem]; framed: payloads
        self._failed: List[_FramedPayload] = []
        self._next_pid = 0
        self._tick_no = 0
        self.bytes_sent = 0.0             # goodput: intact delivered bytes
        self.n_completed = 0
        self.n_partial_ticks = 0          # ticks ending mid-payload
        # framed-mode ledger
        self.frame_bytes_attempted = 0.0  # every transmission attempt
        self.bytes_lost = 0.0
        self.bytes_corrupt = 0.0
        self.bytes_retransmitted = 0.0    # attempts after the first
        self.n_frames_sent = 0
        self.n_frames_lost = 0
        self.n_retransmits = 0
        self.n_corruptions_detected = 0
        self.n_silent_corruptions = 0     # corrupt frame passing CRC: gated 0
        self.n_payload_failures = 0

    @property
    def framed(self) -> bool:
        return self.frame_bytes is not None

    def enqueue(self, item, nbytes: float) -> None:
        if not self.framed:
            self._q.append([item, float(nbytes)])
            return
        pid = self._next_pid
        self._next_pid += 1
        nbytes = float(nbytes)
        n_frames = max(1, int(-(-nbytes // self.frame_bytes)))
        frames = []
        for seq in range(n_frames):
            sz = min(float(self.frame_bytes), nbytes - seq * self.frame_bytes)
            # real header bytes so the CRC protects something concrete;
            # the payload body is synthetic in this replay
            frames.append(_Frame(sz, struct.pack("<QI", pid, seq)))
        self._q.append(_FramedPayload(item, nbytes, frames))

    def __len__(self) -> int:
        return len(self._q)

    def pending_bytes(self) -> float:
        if not self.framed:
            return sum(rem for _, rem in self._q)
        return sum(fr.nbytes for p in self._q for fr in p.frames
                   if not fr.delivered)

    def pending_items(self) -> List:
        if not self.framed:
            return [item for item, _ in self._q]
        return [p.item for p in self._q]

    def pending_payloads(self) -> List[Tuple[object, float]]:
        """(item, total_bytes) per queued payload — what a checkpoint
        must persist to rebuild the backlog after a reboot (partial ARQ
        progress does not survive a crash; the payload restarts)."""
        if not self.framed:
            return [(item, rem) for item, rem in self._q]
        return [(p.item, p.nbytes) for p in self._q]

    def take_failed(self) -> List[Tuple[object, float]]:
        """(item, total_bytes) of payloads that exhausted their frame
        retry budgets; the caller decides whether to re-enqueue."""
        out = [(p.item, p.nbytes) for p in self._failed]
        self._failed.clear()
        return out

    def clear(self) -> List:
        """Drop the backlog (horizon exhausted); returns the items,
        including payloads parked in the failed list."""
        out = self.pending_items() + [p.item for p in self._failed]
        self._q.clear()
        self._failed.clear()
        return out

    def tick(self, budget_bytes: float) -> List:
        """Transmit up to ``budget_bytes`` off the FIFO head; returns
        the items fully delivered this tick."""
        if self.framed:
            return self._tick_framed(budget_bytes)
        done = []
        remaining = float(budget_bytes)
        while self._q and self._q[0][1] <= remaining:
            item, nbytes = self._q.popleft()
            remaining -= nbytes
            self.bytes_sent += nbytes
            self.n_completed += 1
            done.append(item)
        if self._q and remaining > 0.0:
            self._q[0][1] -= remaining
            self.bytes_sent += remaining
            self.n_partial_ticks += 1
        return done

    def _tick_framed(self, budget_bytes: float) -> List:
        self._tick_no += 1
        remaining = float(budget_bytes)
        attempted_any = False
        for p in self._q:
            if remaining <= 0.0:
                break
            if p.failed:
                continue
            for fr in p.frames:
                if fr.delivered or fr.eligible_tick > self._tick_no:
                    continue
                if fr.nbytes > remaining:
                    remaining = -1.0      # budget quantum exhausted: frames
                    break                 # transmit whole or not at all
                remaining -= fr.nbytes
                attempted_any = True
                self._transmit(p, fr)
                if p.failed:
                    break    # retry budget blown: stop burning link on it
            if remaining < 0.0:
                break
        # payloads are RELEASED in FIFO enqueue order even though frame
        # completions can land out of order under retransmission
        done = []
        while self._q and not self._q[0].failed \
                and self._q[0].n_delivered == len(self._q[0].frames):
            p = self._q.popleft()
            self.n_completed += 1
            done.append(p.item)
        if any(p.failed for p in self._q):
            live = deque()
            for p in self._q:
                (self._failed if p.failed else live).append(p)
            self._q = live
        if attempted_any and self._q and self._q[0].n_delivered > 0:
            self.n_partial_ticks += 1
        return done

    def _transmit(self, p: _FramedPayload, fr: _Frame) -> None:
        fr.attempts += 1
        self.n_frames_sent += 1
        self.frame_bytes_attempted += fr.nbytes
        if fr.attempts > 1:
            self.n_retransmits += 1
            self.bytes_retransmitted += fr.nbytes
        fate = self.injector.frame_fate() if self.injector is not None \
            else "ok"
        if fate == "lost":
            self.bytes_lost += fr.nbytes
            self.n_frames_lost += 1
            self._nack(p, fr)
            return
        rx = self.injector.corrupt_bytes(fr.data) if fate == "corrupt" \
            else fr.data
        if zlib.crc32(rx) == fr.crc:
            if fate == "corrupt":
                self.n_silent_corruptions += 1   # unreachable for CRC32 +
                #                                  single-bit flips; gated 0
            fr.delivered = True
            p.n_delivered += 1
            self.bytes_sent += fr.nbytes
        else:
            self.n_corruptions_detected += 1
            self.bytes_corrupt += fr.nbytes
            self._nack(p, fr)

    def _nack(self, p: _FramedPayload, fr: _Frame) -> None:
        if fr.attempts >= self.max_retries:
            p.failed = True
            self.n_payload_failures += 1
        else:
            backoff = min(2 ** (fr.attempts - 1), _BACKOFF_CAP_TICKS)
            fr.eligible_tick = self._tick_no + backoff

    # -- checkpoint bookkeeping ---------------------------------------------
    # A reboot rebuilds the lane from pending_payloads(); the counters
    # roll back with the rest of the serving state so injected-vs-
    # detected stays exact across the rewind (see core.faults).
    _STATE_KEYS = ("bytes_sent", "n_completed", "n_partial_ticks",
                   "frame_bytes_attempted", "bytes_lost", "bytes_corrupt",
                   "bytes_retransmitted", "n_frames_sent", "n_frames_lost",
                   "n_retransmits", "n_corruptions_detected",
                   "n_silent_corruptions", "n_payload_failures")

    def state(self) -> dict:
        return {k: getattr(self, k) for k in self._STATE_KEYS}

    def load_state(self, d: dict) -> None:
        for k in self._STATE_KEYS:
            setattr(self, k, d[k])


def payload_bytes_result(n_items: int, classes: int = 1) -> int:
    """Compact inference result: class id + confidence + bbox-ish tuple
    per item (16 bytes, generous)."""
    return 16 * n_items * max(classes, 1)


def payload_bytes_raw(n_items: int, item_shape, dtype_bytes: int = 1) -> int:
    n = 1
    for d in item_shape:
        n *= d
    return n_items * n * dtype_bytes


def payload_bytes_draft(n_draft: int) -> int:
    """Speculative escalation payload: the satellite tier's draft token
    ids (4 bytes each) plus a small header (request reference + lengths;
    the ground tier already holds the prompt from the uplink relay).
    Compare ``payload_bytes_raw``, which ships the whole prompt payload
    for a from-scratch re-decode."""
    return 4 * n_draft + 16
