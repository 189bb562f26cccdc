"""Space-ground message bus.

Messages between a satellite and the ground are deliverable only during
contact windows and pay the link-rate + loss cost; ground<->ground is
instantaneous.  The bus is a discrete-event queue driven by an explicit
clock (deterministic; tests advance time)."""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.orchestration.registry import Registry

_seq = itertools.count()


@dataclass(order=True)
class Message:
    deliver_t: float
    seq: int = field(compare=True)
    src: str = field(compare=False, default="")
    dst: str = field(compare=False, default="")
    topic: str = field(compare=False, default="")
    payload: Any = field(compare=False, default=None)
    nbytes: int = field(compare=False, default=0)


class MessageBus:
    def __init__(self, registry: Registry):
        self.registry = registry
        self._pending: List[Message] = []
        self._subs: Dict[Tuple[str, str], List[Callable]] = {}
        self.delivered_bytes: float = 0.0
        self.clock: float = 0.0

    def subscribe(self, node: str, topic: str, fn: Callable) -> None:
        self._subs.setdefault((node, topic), []).append(fn)

    def _deliver_time(self, src: str, dst: str, nbytes: int,
                      t: float) -> Optional[float]:
        s, d = self.registry.get(src), self.registry.get(dst)
        sat = s if s.kind == "satellite" else (
            d if d.kind == "satellite" else None)
        if sat is None:
            return t                                   # ground <-> ground
        win = sat.contacts.next_window(t, horizon_s=86_400.0 * 2)
        if win is None:
            return None
        start = max(win[0], t)
        down = s.kind == "satellite"
        link = sat.contacts.link
        tx = (link.downlink_time_s(nbytes) if down
              else link.uplink_time_s(nbytes))
        if start + tx > win[1]:                        # spills past window
            nxt = sat.contacts.next_window(win[1] + 1.0)
            if nxt is None:
                return None
            start = nxt[0]
        return start + tx

    def send(self, src: str, dst: str, topic: str, payload: Any,
             nbytes: int, t: Optional[float] = None) -> Optional[float]:
        """Queue a message; returns its delivery time (None = undeliverable)."""
        t = self.clock if t is None else t
        dt = self._deliver_time(src, dst, nbytes, t)
        if dt is None:
            return None
        heapq.heappush(self._pending,
                       Message(dt, next(_seq), src, dst, topic, payload,
                               nbytes))
        return dt

    def advance(self, until: float) -> int:
        """Advance the clock, delivering due messages.  Returns count."""
        n = 0
        while self._pending and self._pending[0].deliver_t <= until:
            msg = heapq.heappop(self._pending)
            self.delivered_bytes += msg.nbytes
            for fn in self._subs.get((msg.dst, msg.topic), []):
                fn(msg)
            n += 1
        self.clock = max(self.clock, until)
        return n
