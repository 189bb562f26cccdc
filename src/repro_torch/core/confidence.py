"""Confidence metrics over posterior logits: the twin of the JAX
package's ``core/confidence.py``.

The gate consumes (..., V) logits.  ``confidence_metrics`` goes through
``kernels.ops.confidence_gate``: the hand-written one-pass kernel for
CUDA logits, the plain softmax version for CPU logits.  (The JAX gate
computes the same function through its jnp reference.)"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

def confidence_metrics(logits: torch.Tensor) -> dict:
    """logits: (..., V) -> dict of (...,)-shaped metrics + argmax."""
    flat = logits.reshape(-1, logits.shape[-1])
    out = ops.confidence_gate(flat)
    return {k: v.reshape(logits.shape[:-1]) for k, v in out.items()}


def normalized_entropy_confidence(entropy: torch.Tensor,
                                  vocab: int) -> torch.Tensor:
    """Map entropy to a [0,1] confidence (1 = fully confident)."""
    return 1.0 - entropy / math.log(vocab)


def score(metrics: dict, metric: str, vocab: int) -> torch.Tensor:
    """A single scalar confidence in [0, 1] per item."""
    if metric == "max_prob":
        return metrics["max_prob"]
    if metric == "margin":
        return metrics["margin"]
    if metric == "entropy":
        return normalized_entropy_confidence(metrics["entropy"], vocab)
    raise ValueError(metric)
