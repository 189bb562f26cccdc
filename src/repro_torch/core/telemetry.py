"""Byte / energy / latency accounting for the collaborative system: what
the paper reports as "90% data reduction" and "17% compute energy" comes
out of this ledger.  A copy of the JAX package's ``core/telemetry.py``:
it needs nothing of JAX, but the port imports nothing of that package."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Ledger:
    counters: Dict[str, float] = field(default_factory=dict)

    def add(self, key: str, value: float) -> None:
        self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def get(self, key: str) -> float:
        return self.counters.get(key, 0.0)

    def ratio(self, num: str, den: str) -> float:
        d = self.get(den)
        return self.get(num) / d if d else float("nan")

    def summary(self) -> Dict[str, float]:
        out = dict(self.counters)
        raw = self.get("bytes_bentpipe_baseline")
        if raw:
            out["data_reduction"] = 1.0 - self.get("bytes_downlinked") / raw
        esc = self.get("items_escalated")
        tot = self.get("items_total")
        if "items_total" in self.counters:
            # an empty batch escalates nothing, not NaN of something
            out["escalation_rate"] = esc / tot if tot else 0.0
        return out
