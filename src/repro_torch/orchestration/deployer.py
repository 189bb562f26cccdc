"""Application deployer — the Sedna GlobalManager analogue.

An AppManifest names a model config + tier placement; the Deployer
instantiates workers (serving engines or classifier tiers) on registered
nodes and keeps desired state in the MetadataStore so satellites can
restore workloads after an offline period (paper: "offline autonomous").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.orchestration.autonomy import MetadataStore
from repro_torch.orchestration.registry import Registry


@dataclass(frozen=True)
class AppManifest:
    name: str
    node: str
    factory: Callable[[], Any]          # builds the worker (engine/tier)
    labels: Dict[str, str] = field(default_factory=dict)


class Deployer:
    def __init__(self, registry: Registry,
                 store: Optional[MetadataStore] = None):
        self.registry = registry
        self.store = store or MetadataStore()
        self._workers: Dict[str, Any] = {}

    def apply(self, manifest: AppManifest) -> Any:
        """Deploy (or redeploy) an app; records desired state first, so a
        crash between record and start is recoverable."""
        self.registry.get(manifest.node)        # must exist
        self.store.record_desired(manifest.name, {
            "node": manifest.node, "labels": dict(manifest.labels)})
        worker = manifest.factory()
        self._workers[manifest.name] = worker
        self.store.record_actual(manifest.name, "running")
        return worker

    def delete(self, name: str) -> None:
        self._workers.pop(name, None)
        self.store.record_actual(name, "deleted")
        self.store.remove_desired(name)

    def worker(self, name: str) -> Any:
        return self._workers[name]

    def restore(self, factories: Dict[str, Callable[[], Any]]) -> int:
        """Offline-autonomy restart: rebuild every desired app that is not
        running (MetaManager restore path).  Returns number restored."""
        n = 0
        for name, spec in self.store.desired().items():
            if self.store.actual(name) != "running":
                self._workers[name] = factories[name]()
                self.store.record_actual(name, "running")
                n += 1
        return n
