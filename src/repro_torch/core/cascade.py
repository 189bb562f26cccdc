"""The satellite-ground collaborative inference engine (paper section IV):
the twin of the JAX package's ``core/cascade.py``.

Generic over tiers: an onboard (cheap) model and a ground (accurate)
model, each a callable ``batch -> logits``.  Per item:

    1. the onboard tier runs; the confidence gate scores its posterior
       (on the engine's device: the conf-gate kernel on the card);
    2. confident items downlink ONLY the compact result (16 B/item);
    3. low-confidence items downlink the raw payload and are re-answered
       by the ground tier.  With ``quantize_payload`` the port builds
       that payload for real: the escalated items, flattened to
       (n_esc, prod(item_shape)), go through ``ops.int8_quantize`` (the
       int8 kernel on the card), and the ledger charges the bytes of the
       int8 rows and fp32 scales it built, which equal the reference's
       arithmetic (``raw_item // item_dtype_bytes + 4`` per item).  A
       dict batch has no single raw item to build: it is charged that
       arithmetic alone, as the reference charges every batch, and
       launches no kernel.  The ground tier still reads the raw items,
       as in the reference;
    4. the ledger accounts bytes vs the bent-pipe baseline (downlink
       everything raw), energy (Tables 2-3) and link time (Table 1).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.energy import EnergyModel
from repro_torch.core.gating import ConfidenceGate
from repro_torch.core.link import (LinkModel, payload_bytes_raw,
                                   payload_bytes_result)
from repro_torch.core.telemetry import Ledger
from repro_torch.kernels import ops

_QUANT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclass(frozen=True)
class CascadeConfig:
    gate: ConfidenceGate = ConfidenceGate()
    link: LinkModel = LinkModel()
    energy: EnergyModel = EnergyModel()
    onboard_s_per_item: float = 0.35      # YOLOv3-tiny on a Pi-class board
    quantize_payload: bool = False        # int8 payload compression
    item_dtype_bytes: int = 1             # raw EO tile bytes per element


@dataclass
class CascadeResult:
    predictions: np.ndarray               # final per-item predictions
    escalated: np.ndarray                 # bool mask
    confidence: np.ndarray
    ledger: Ledger = field(default_factory=Ledger)
    # the built escalation payload under quantize_payload: (q int8
    # (n_esc, prod(item_shape)), scale fp32 (n_esc,)) on the device;
    # None when nothing was quantized
    payload: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class CollaborativeEngine:
    def __init__(self, onboard_fn: Callable, ground_fn: Callable,
                 cfg: CascadeConfig = CascadeConfig(), device="cuda"):
        self.onboard_fn = onboard_fn
        self.ground_fn = ground_fn
        self.cfg = cfg
        self.device = resolve_device(device)

    def run(self, batch, item_shape, *,
            ground_available: bool = True) -> CascadeResult:
        """batch: whatever the tier callables consume (a numpy array, a
        tensor, or a dict of them); item_shape: shape of ONE raw item
        (for byte accounting)."""
        cfg = self.cfg
        ledger = Ledger()

        onboard_logits = torch.as_tensor(self.onboard_fn(batch)).to(
            self.device, torch.float32)
        n = onboard_logits.shape[0]
        decision = cfg.gate.decide(onboard_logits)
        escalate = decision["escalate"]
        if not ground_available:
            escalate = torch.zeros_like(escalate)
        idx = torch.nonzero(escalate).flatten()
        n_esc = int(idx.numel())
        escalate = escalate.cpu().numpy()
        conf = decision["confidence"].cpu().numpy()
        preds = decision["argmax"].cpu().numpy().astype(np.int64)

        # ---- byte accounting -------------------------------------------
        payload = None
        raw_item = payload_bytes_raw(1, item_shape, cfg.item_dtype_bytes)
        if cfg.quantize_payload and isinstance(batch, dict):
            bytes_raw = n_esc * (raw_item // cfg.item_dtype_bytes + 4)
        elif cfg.quantize_payload:
            bytes_raw = 0
            if n_esc:
                payload = self._quantize(batch, idx, item_shape)
                bytes_raw = sum(t.numel() * t.element_size()
                                for t in payload)
        else:
            bytes_raw = n_esc * raw_item
        bytes_results = payload_bytes_result(n - n_esc)
        bytes_baseline = n * raw_item
        ledger.add("items_total", n)
        ledger.add("items_escalated", n_esc)
        ledger.add("bytes_downlinked", bytes_results + bytes_raw)
        ledger.add("bytes_results", bytes_results)
        ledger.add("bytes_raw_escalated", bytes_raw)
        ledger.add("bytes_bentpipe_baseline", bytes_baseline)
        ledger.add("downlink_s",
                   cfg.link.downlink_time_s(bytes_results + bytes_raw))
        ledger.add("downlink_s_bentpipe",
                   cfg.link.downlink_time_s(bytes_baseline))

        # ---- energy accounting -----------------------------------------
        ledger.add("energy_compute_j",
                   cfg.energy.inference_energy_j(n, cfg.onboard_s_per_item))
        ledger.add("energy_comm_j", cfg.energy.comm_energy_j(
            cfg.link.downlink_time_s(bytes_results + bytes_raw)))

        # ---- ground tier on escalated items ----------------------------
        if n_esc and ground_available:
            sub = self._subset_batch(batch, idx)
            ground_logits = torch.as_tensor(self.ground_fn(sub)).to(
                torch.float32)
            preds[idx.cpu().numpy()] = \
                ground_logits.argmax(-1).cpu().numpy()

        return CascadeResult(predictions=preds, escalated=escalate,
                             confidence=conf, ledger=ledger, payload=payload)

    def _quantize(self, batch, idx, item_shape):
        """The escalated items as (n_esc, prod(item_shape)) rows on the
        device, quantized to int8 rows plus their fp32 scales."""
        x = torch.as_tensor(self._subset_batch(batch, idx)).to(self.device)
        size = math.prod(item_shape)
        if x[0].numel() != size:
            raise ValueError(f"quantize_payload: an item holds "
                             f"{x[0].numel()} elements, item_shape "
                             f"{tuple(item_shape)} says {size}")
        x = x.reshape(idx.numel(), size)
        if x.dtype not in _QUANT_DTYPES:
            x = x.to(torch.float32)
        return ops.int8_quantize(x)

    @staticmethod
    def _subset_batch(batch, idx):
        """The items at ``idx`` (a tensor of indices), indexed where the
        batch lives: a numpy batch on the host, a tensor on its device."""
        if isinstance(batch, dict):
            return {k: CollaborativeEngine._subset_batch(v, idx)
                    for k, v in batch.items()}
        if isinstance(batch, torch.Tensor):
            return batch[idx.to(batch.device)]
        return batch[idx.cpu().numpy()]
