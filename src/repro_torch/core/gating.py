"""Confidence-threshold gating (paper section IV): high confidence ->
downlink the compact result; low confidence -> escalate to the ground
tier.  The twin of the JAX package's ``core/gating.py``."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import confidence as C


@dataclass(frozen=True)
class ConfidenceGate:
    metric: str = "max_prob"
    threshold: float = 0.62

    def decide(self, logits, vocab: int | None = None) -> dict:
        """logits: (..., V) tensor (a numpy array is taken as a CPU
        tensor).  Returns {"escalate": bool (...,), "confidence": f32,
        "argmax": int32} on the logits' device."""
        if isinstance(logits, np.ndarray):
            logits = torch.from_numpy(logits)
        vocab = vocab or logits.shape[-1]
        m = C.confidence_metrics(logits)
        conf = C.score(m, self.metric, vocab)
        return {"escalate": conf < self.threshold,
                "confidence": conf,
                "argmax": m["argmax"]}
