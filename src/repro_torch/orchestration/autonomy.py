"""Offline-autonomy metadata store (KubeEdge MetaManager analogue):
desired/actual state survives node restarts; satellites manage and
restore applications from local metadata while disconnected."""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional


class MetadataStore:
    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._desired: Dict[str, dict] = {}
        self._actual: Dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                obj = json.load(f)
            self._desired = obj.get("desired", {})
            self._actual = obj.get("actual", {})

    def _flush(self) -> None:
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"desired": self._desired, "actual": self._actual},
                          f)
            os.replace(tmp, self._path)

    def record_desired(self, name: str, spec: dict) -> None:
        self._desired[name] = copy.deepcopy(spec)
        self._flush()

    def remove_desired(self, name: str) -> None:
        self._desired.pop(name, None)
        self._flush()

    def record_actual(self, name: str, state: str) -> None:
        self._actual[name] = state
        self._flush()

    def desired(self) -> Dict[str, dict]:
        return copy.deepcopy(self._desired)

    def actual(self, name: str) -> Optional[str]:
        return self._actual.get(name)
