"""Confidence-threshold gating (paper section IV): high confidence ->
downlink the compact result; low confidence -> escalate to the ground
tier.  The twin of the JAX package's ``core/gating.py``; its threshold
calibration and gated accuracy are numpy, copied."""
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


def calibrate_threshold(confidences: np.ndarray, correct: np.ndarray,
                        budget_fraction: float) -> float:
    """Pick the threshold that escalates at most ``budget_fraction`` of
    items, preferring to escalate the least-confident ones (matches how
    the paper tunes its deployment to the downlink budget)."""
    order = np.sort(confidences)
    k = int(np.floor(budget_fraction * len(order)))
    if k <= 0:
        return float(order[0]) - 1e-6          # escalate nothing
    if k >= len(order):
        return float(order[-1]) + 1e-6         # escalate everything
    return float(0.5 * (order[k - 1] + order[k]))


def accuracy_with_gate(onboard_correct: np.ndarray, ground_correct: np.ndarray,
                       escalate: np.ndarray) -> float:
    """System accuracy: ground tier answers escalated items, onboard
    answers the rest."""
    return float(np.mean(np.where(escalate, ground_correct, onboard_correct)))
