"""The paper's own configuration: the Tiansuan two-tier collaborative pair.

The paper deploys YOLOv3-tiny onboard (Baoyun, Raspberry-Pi-class payload)
and YOLOv3 on the ground.  Our assigned pool is transformer LMs, so the
pair becomes a (reduced, full) pair of the same family (DESIGN.md §2):
the onboard tier is a ~9M-param model sized for a Pi-class power budget,
the ground tier a ~6x larger model.  The cascade parameters mirror the
paper's deployment: confidence threshold gating, tile splitting, cloud
redundancy filtering, and the Baoyun link budget (Table 1).
"""
from repro_torch.config import ModelConfig

# Onboard "satellite" tier — YOLOv3-tiny analogue (Pi-class budget).
ONBOARD = ModelConfig(
    name="tiansuan-onboard",
    family="dense",
    citation="this paper (YOLOv3-tiny analogue)",
    n_layers=4,
    d_model=192,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    head_dim=48,
    tie_embeddings=True,
)

# Ground "cloud" tier — YOLOv3 analogue.
GROUND = ModelConfig(
    name="tiansuan-ground",
    family="dense",
    citation="this paper (YOLOv3 analogue)",
    n_layers=12,
    d_model=384,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=512,
    head_dim=48,
    tie_embeddings=True,
)

# Deployment parameters (paper Table 1 + Section IV).
CASCADE = dict(
    confidence_metric="max_prob",     # posterior max, as in the paper
    confidence_threshold=0.62,        # calibrated in benchmarks/fig7_accuracy.py
    tile=64,                          # onboard tile splitting (DOTA frames)
    cloud_filter=True,                # redundancy (cloud-cover) filter
    uplink_mbps=1.0,                  # Table 1: 0.1~1 Mbps
    downlink_mbps=40.0,               # Table 1: >=40 Mbps
    orbital_altitude_km=500.0,        # Table 1
)

# Space-ground scheduling parameters (serving.scheduler): the onboard
# tier decodes through ground-station passes (overlap=True splits each
# pass into a transmit lane and a compute lane; the Pi's comm stack
# only claims comm_reserve_pages of KV for downlink staging, spilling
# just the sequences whose pages must cover it).  s_per_step is a
# Pi-class per-token decode latency for the ONBOARD tier; the ground
# tier is assumed always-on.  overlap=False restores the stop-the-world
# schedule (every pass preempts all decode).
# prefill_budget_tokens bounds EVERY onboard tick (the engine's unified
# token-budget step chunks arriving prompts), so a long uplinked prompt
# can never freeze a pass's transmit lane for its whole length.
SCHEDULER = dict(
    s_per_step=0.35,                  # onboard decode seconds per token
    contact_duration_s=480.0,         # ~8 min LEO pass (ContactSchedule)
    contacts_per_day=6,
    escalate_threshold=0.62,          # cascade gate (CASCADE) reuse
    overlap=True,                     # transmit/compute lanes share a pass
    comm_reserve_pages=2,             # KV pages held for downlink staging
    delta_spill=True,                 # re-spills ship only dirtied pages
    prefill_budget_tokens=16,         # ContinuousEngine chunked-prefill
    #                                   budget: per-tick prompt tokens
    # fault tolerance (core.faults / framed TransmitLane): the downlink
    # is framed with per-frame CRC + NACK retransmission, and the
    # onboard scheduler checkpoints its full serving state so a
    # radiation-induced reboot resumes token-exactly from the last
    # checkpoint instead of recomputing the day's backlog.
    frame_bytes=1024,                 # downlink ARQ frame size
    link_max_retries=8,               # per-frame retry budget
    checkpoint_every=64,              # onboard ticks between checkpoints
    # speculative escalation (serving.speculative / engine draft-verify):
    # an escalated sequence downlinks only the ONBOARD tier's draft
    # token ids (payload_bytes_draft) and the GROUND tier verifies up to
    # draft_k of them per slot per tick in one chunked pass — greedy
    # token-exact with a raw re-decode at a fraction of the bytes.
    speculative=True,
    draft_k=8,                        # max drafts verified per pass
)

CONFIG = GROUND            # default arch when loaded via get_config
REDUCED = ONBOARD
