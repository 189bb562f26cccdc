"""The paper's contribution: satellite-ground collaborative inference.

Pipeline (paper section IV, Figure 5):
    EO frames -> tiling.split -> filtering.cloud_filter -> onboard tier
    -> confidence gate -> {downlink results | escalate raw payload}
    -> ground tier -> merged results
with byte-accurate link accounting (Table 1) and the energy model
(Tables 2-3).  The JAX package's ``core`` also exports
``ContactSchedule``, which comes with the port's scheduler slice."""
from repro_torch.core.cascade import CollaborativeEngine, CascadeConfig  # noqa
from repro_torch.core.confidence import confidence_metrics               # noqa
from repro_torch.core.gating import ConfidenceGate                       # noqa
from repro_torch.core.link import LinkModel                              # noqa
from repro_torch.core.energy import EnergyModel                          # noqa
