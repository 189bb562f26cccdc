"""Onboard energy model, the paper's measured power budget: a copy of
the JAX package's ``core/energy.py`` ``EnergyModel`` (``FleetEnergy``
comes with the constellation slice).

Table 2 (Baoyun, W): electrical 1.47, propulsion 7.00, guidance 5.43,
avionics 4.81, comm 5.43, payloads 26.93, total 51.07.
Table 3 (payloads, W): camera 0.09, occultation 6.26, tribology 5.68,
mems 0.95, adsbs 6.12, raspberry pi (compute) 8.78.

The paper's headline: computing (the Pi) is ~17% of total onboard
energy; payloads are ~53%; the Pi is ~33% of payload energy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

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
