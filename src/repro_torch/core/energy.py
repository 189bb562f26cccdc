"""Onboard energy model, the paper's measured power budget: a copy of
the JAX package's ``core/energy.py`` (``EnergyModel`` and the
constellation's per-satellite ``FleetEnergy``).

Table 2 (Baoyun, W): electrical 1.47, propulsion 7.00, guidance 5.43,
avionics 4.81, comm 5.43, payloads 26.93, total 51.07.
Table 3 (payloads, W): camera 0.09, occultation 6.26, tribology 5.68,
mems 0.95, adsbs 6.12, raspberry pi (compute) 8.78.

The paper's headline: computing (the Pi) is ~17% of total onboard
energy; payloads are ~53%; the Pi is ~33% of payload energy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.telemetry import Ledger

TABLE2_W: Dict[str, float] = {
    "electrical": 1.47,
    "propulsion": 7.00,
    "guidance": 5.43,
    "avionics": 4.81,
    "comm": 5.43,
    "payloads": 26.93,
}

TABLE3_W: Dict[str, float] = {
    "camera": 0.09,
    "occultation": 6.26,
    "tribology": 5.68,
    "mems": 0.95,
    "adsbs": 6.12,
    "raspberry_pi": 8.78,
}


@dataclass(frozen=True)
class EnergyModel:
    subsystem_w: Dict[str, float] = field(default_factory=lambda: dict(TABLE2_W))
    payload_w: Dict[str, float] = field(default_factory=lambda: dict(TABLE3_W))
    compute_key: str = "raspberry_pi"
    comm_key: str = "comm"

    @property
    def total_w(self) -> float:
        return sum(self.subsystem_w.values())

    @property
    def payload_total_w(self) -> float:
        return sum(self.payload_w.values())

    def compute_share_of_total(self) -> float:
        """Paper: ~17%."""
        return self.payload_w[self.compute_key] / self.total_w

    def compute_share_of_payload(self) -> float:
        """Paper: ~33%."""
        return self.payload_w[self.compute_key] / self.payload_total_w

    def payload_share_of_total(self) -> float:
        """Paper: ~53%."""
        return self.subsystem_w["payloads"] / self.total_w

    # ---- activity-based accounting for the cascade simulator ----------
    def inference_energy_j(self, n_items: int, s_per_item: float) -> float:
        return self.payload_w[self.compute_key] * n_items * s_per_item

    def comm_energy_j(self, tx_seconds: float) -> float:
        return self.subsystem_w[self.comm_key] * tx_seconds

    def energy_budget_j(self, horizon_s: float) -> float:
        return self.total_w * horizon_s


class FleetEnergy:
    """Per-satellite energy/byte metering for a constellation replay.

    Every Baoyun-class satellite flies the same bus, so ONE
    ``EnergyModel`` (Tables 2/3) is metered into one telemetry
    ``Ledger`` per spacecraft — "equal energy/byte budget" comparisons
    between replays are then checkable per satellite, not just
    fleet-wide.  Compute charges follow the pair scheduler's
    convention (one inference item per decode tick, whatever the batch
    width); comm charges cover both ground downlink seconds and
    inter-satellite-link seconds, with the byte streams kept in
    separate counters (``bytes_downlinked`` vs ``bytes_isl``)."""

    def __init__(self, n_satellites: int,
                 model: Optional[EnergyModel] = None):
        if n_satellites < 1:
            raise ValueError("FleetEnergy needs at least one satellite")
        self.model = model or EnergyModel()
        self.ledgers: List[Ledger] = [Ledger() for _ in range(n_satellites)]

    def charge_compute(self, sat: int, n_items: int,
                       s_per_item: float) -> None:
        led = self.ledgers[sat]
        led.add("energy_compute_j",
                self.model.inference_energy_j(n_items, s_per_item))
        led.add("decode_ticks", 1)

    def charge_downlink(self, sat: int, tx_seconds: float,
                        nbytes: float) -> None:
        led = self.ledgers[sat]
        led.add("energy_comm_j", self.model.comm_energy_j(tx_seconds))
        led.add("bytes_downlinked", nbytes)
        led.add("downlink_s", tx_seconds)

    def charge_isl(self, sat: int, tx_seconds: float,
                   nbytes: float) -> None:
        led = self.ledgers[sat]
        led.add("energy_comm_j", self.model.comm_energy_j(tx_seconds))
        led.add("bytes_isl", nbytes)
        led.add("isl_s", tx_seconds)

    def satellite(self, sat: int) -> Ledger:
        return self.ledgers[sat]

    def energy_j(self, sat: int) -> float:
        led = self.ledgers[sat]
        return led.get("energy_compute_j") + led.get("energy_comm_j")

    def within_budget(self, horizon_s: float) -> bool:
        """Every satellite within the bus's whole-horizon budget."""
        cap = self.model.energy_budget_j(horizon_s)
        return all(self.energy_j(k) <= cap
                   for k in range(len(self.ledgers)))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for led in self.ledgers:
            for k, v in led.counters.items():
                out[k] = out.get(k, 0.0) + v
        return out
