"""Constellation deployment: K=3 Baoyun-class satellites, 2 stations (a
copy of the JAX package's ``configs/tiansuan_constellation.py``).

The paper's verification flew on the Tiansuan constellation — several
cloud-native satellites, not one.  Every spacecraft flies the same
ONBOARD payload (identical buses; ``configs/tiansuan_pair``), which is
what makes an inter-satellite handover token-exact: greedy decode from
a grafted KV snapshot continues identically on any peer.

The window geometry is deliberately asymmetric — satellite 0 is on a
plane with poor station visibility (one short pass where its peers get
dozens), which is the regime where contact planning and handover pay:
``serving.constellation.ConstellationScheduler`` moves satellite 0's
backlog to window-rich peers over the ISL instead of parking it until
the lone pass.  The reference's ``benchmarks/serving_throughput.py``
gates the constellation replay against the K-independent-pairs
comparator built from the same numbers, and ``chip_smoke.py`` runs it
on the card.
"""
from repro_torch.configs.tiansuan_pair import ONBOARD

# Every satellite flies the onboard tier (homogeneous constellation).
SATELLITE = ONBOARD

CONSTELLATION = dict(
    n_satellites=3,
    n_stations=2,
    s_per_step=1.0,                   # shared tick (seconds per step)
    horizon_s=7200.0,                 # replay horizon
    # per-(satellite, station) window sets via
    # ContactSchedule.step_window_sets: satellite 0's plane sees a
    # station ~once per horizon; planes 1-2 every few minutes
    contact_duration_s=8.0,
    contacts_per_day=[12, 1200, 1200],
    schedule_seed=3,
    # contact planning + handover (serving.constellation)
    policy="value",                   # priority-to-value pass assignment
    handover_margin_ticks=64,         # peer must be this much sooner
    isl_mbps=100.0,                   # optical inter-satellite link
    # framed ARQ on both the downlink and the ISL (core.link): per-frame
    # CRC + NACK retransmission, bounded retries, failed payloads
    # re-enqueue — the same wire discipline as the pair deployment
    frame_bytes=1024,
    link_max_retries=8,
)

CONFIG = SATELLITE
REDUCED = SATELLITE
