"""Cloud-native orchestration layer (KubeEdge/Sedna analogue, DESIGN.md
§2): node registry, application deployer, lossy space-ground message
bus, offline-autonomy metadata store.  Copies of the JAX package's
``orchestration/*`` (plain Python), with the registry on the port's
``core.link``."""
from repro_torch.orchestration.registry import NodeSpec, Registry      # noqa
from repro_torch.orchestration.bus import MessageBus, Message          # noqa
from repro_torch.orchestration.deployer import AppManifest, Deployer   # noqa
from repro_torch.orchestration.autonomy import MetadataStore           # noqa
