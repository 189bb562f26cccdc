"""Node registry — CloudCore/EdgeCore analogue.

Nodes are satellites (edge) or ground stations / cloud (core).  The
registry tracks liveness based on contact windows: a satellite is
"reachable" only during a ground-station pass; it keeps running
autonomously while unreachable (the paper's "offline autonomous")."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.link import ContactSchedule, LinkModel


@dataclass
class NodeSpec:
    name: str
    kind: str                      # "satellite" | "ground"
    compute_w: float = 8.78        # Table 3: Pi-class payload power
    memory_gb: float = 4.0
    link: Optional[LinkModel] = None
    contacts: Optional[ContactSchedule] = None
    labels: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ("satellite", "ground"):
            raise ValueError(self.kind)
        if self.kind == "satellite" and self.contacts is None:
            self.contacts = ContactSchedule(link=self.link or LinkModel())


class Registry:
    def __init__(self):
        self._nodes: Dict[str, NodeSpec] = {}

    def register(self, node: NodeSpec) -> None:
        if node.name in self._nodes:
            raise KeyError(f"duplicate node {node.name!r}")
        self._nodes[node.name] = node

    def get(self, name: str) -> NodeSpec:
        return self._nodes[name]

    def nodes(self, kind: Optional[str] = None):
        return [n for n in self._nodes.values()
                if kind is None or n.kind == kind]

    def reachable(self, name: str, t: float) -> bool:
        n = self._nodes[name]
        if n.kind == "ground":
            return True
        return n.contacts.in_contact(t)
