"""Space-ground link model (paper Table 1 + section II): a copy of the
JAX package's ``core/link.py`` ``LinkModel`` and payload sizes, numpy
only.  ``ContactSchedule`` and ``TransmitLane`` come with the scheduler.

Baoyun: 500+-50 km orbit, uplink 0.1-1 Mbps, downlink >= 40 Mbps; the
downlink is only available during ground-station contact windows, and
packet loss on the downlink can be severe (one mission lost 80% of
packets [paper ref 12])."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
