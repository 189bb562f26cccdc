"""Tile classifiers for the case study: the YOLOv3-tiny / YOLOv3 analogue
pair, an onboard (small) and a ground (large) classifier over EO tiles,
trained with the port's own AdamW.  The twin of the JAX package's
``core/classifier.py``.

Patch-embedding + mean-pooled MLP trunk; capacity (width/depth) is the
only difference between tiers, mirroring the paper's tiny-vs-full
detector split.  Random init comes from a seeded ``torch.Generator``
(not the JAX package's numbers: parity tests bridge those in with
``bridge.classifier_params_from_numpy``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.training import optim

F32 = torch.float32


@dataclass(frozen=True)
class ClassifierConfig:
    tile: int = 32
    patch: int = 8
    d_model: int = 48
    n_layers: int = 2
    n_classes: int = 8
    seed: int = 0


ONBOARD = ClassifierConfig(d_model=24, n_layers=1)     # Pi-class budget
GROUND = ClassifierConfig(d_model=96, n_layers=4)      # ground cluster


def init_classifier(cfg: ClassifierConfig, device="cuda") -> dict:
    """Params from ``torch.Generator().manual_seed(cfg.seed)`` on
    ``device``, in the reference's tree layout."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    pdim = cfg.patch * cfg.patch * 3
    p = {"embed": L.dense_init((pdim, cfg.d_model), F32, gen, dev)}
    for i in range(cfg.n_layers):
        p[f"mlp{i}"] = L.init_swiglu(gen, cfg.d_model, cfg.d_model * 4, F32,
                                     dev)
        p[f"ln{i}"] = L.init_rmsnorm(cfg.d_model, F32, dev)
    p["head"] = L.dense_init((cfg.d_model, cfg.n_classes), F32, gen, dev)
    return p


def _device_of(params: dict) -> torch.device:
    return params["embed"].device


def apply_classifier(params: dict, cfg: ClassifierConfig, tiles):
    """tiles: (B, t, t, 3) tensor (a numpy array is copied to the params'
    device) -> logits (B, n_classes) fp32."""
    tiles = torch.as_tensor(tiles, device=_device_of(params))
    B, t, _, C = tiles.shape
    pp = cfg.patch
    n = t // pp
    x = tiles.reshape(B, n, pp, n, pp, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, n * n, pp * pp * C).to(F32)
    h = x @ params["embed"]                     # (B, P, d)
    for i in range(cfg.n_layers):
        h = h + L.swiglu(params[f"mlp{i}"], L.rmsnorm(params[f"ln{i}"], h))
    pooled = h.mean(dim=1)
    return pooled @ params["head"]


def _loss(params, cfg, xb, yb) -> torch.Tensor:
    lp = F.log_softmax(apply_classifier(params, cfg, xb), dim=-1)
    return -torch.mean(torch.gather(lp, 1, yb[:, None]))


def train_classifier(cfg: ClassifierConfig, tiles, labels, *,
                     steps: int = 300, batch: int = 64, lr: float = 3e-3,
                     seed: int = 0, params: dict | None = None,
                     device="cuda"):
    """Train on labeled (non-cloudy) tiles, from ``params`` if given (on
    their device) or else from ``init_classifier(cfg, device)``.  Batch
    indices come from ``np.random.default_rng(seed)`` as in the
    reference.  Returns (trained params, final loss)."""
    if params is None:
        params = init_classifier(cfg, device)
    dev = _device_of(params)
    keep = labels >= 0
    X = torch.as_tensor(tiles[keep], device=dev)
    Y = torch.as_tensor(labels[keep], device=dev)
    ocfg = optim.OptimConfig(lr=lr, warmup_steps=20, total_steps=steps,
                             weight_decay=0.01)
    state = optim.adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    loss = None
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=min(batch, n))).to(dev)
        p = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = _loss(p, cfg, X[idx], Y[idx])
        loss.backward()
        grads = optim.tree_map(lambda t: t.grad, p)
        params, state, _ = optim.adamw_update(p, grads, state, ocfg)
    return params, float(loss.detach())


def accuracy(params: dict, cfg: ClassifierConfig, tiles, labels) -> float:
    keep = labels >= 0
    logits = apply_classifier(params, cfg, tiles[keep])
    want = torch.as_tensor(labels[keep], device=logits.device)
    return float(torch.mean((torch.argmax(logits, -1) == want).to(F32)))
