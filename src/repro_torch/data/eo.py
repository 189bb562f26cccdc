"""Synthetic Earth-Observation data — the DOTA stand-in for the case
study (no real satellite imagery ships with this repo; the generator is
calibrated so the filter/accuracy benchmarks reproduce the paper's
Figure 6/7 regimes).  A copy of the JAX package's ``data/eo.py``: the
same seed gives byte-identical tiles.

Frames are (H, W, 3) float32 in [0, 1]:
  * terrain: band-limited noise (sums of random sinusoids);
  * objects: one of ``n_classes`` oriented bright patterns placed per
    tile with class-dependent geometry; difficulty controls contrast;
  * clouds: bright low-texture blobs covering a configurable fraction of
    tiles (southwest-China regime: 80–90% [paper §II]).

Two dataset "versions" mirror DOTA-v1/v2 in the paper's Figure 6: v1 has
heavy cloud cover (~90% redundant) and v2 moderate (~40%).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class EOConfig:
    tile: int = 32
    n_classes: int = 8
    cloud_fraction: float = 0.85     # fraction of CLOUDY tiles (v1-like)
    dup_fraction: float = 0.05       # near-duplicate clear tiles
    contrast: float = 0.9            # object contrast (difficulty)
    noise: float = 0.22              # sensor noise (difficulty)
    seed: int = 0


def _terrain(rng, t):
    yy, xx = np.mgrid[0:t, 0:t].astype(np.float32) / t
    img = np.zeros((t, t), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(1, 6, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        img += rng.uniform(0.05, 0.15) * np.sin(
            2 * np.pi * (fx * xx + ph[0])) * np.sin(
            2 * np.pi * (fy * yy + ph[1]))
    return 0.35 + img


def _object(rng, t, cls, n_classes, contrast):
    """Class-dependent bright pattern: cls encodes (orientation, shape)."""
    yy, xx = np.mgrid[0:t, 0:t].astype(np.float32)
    cy, cx = rng.uniform(0.3 * t, 0.7 * t, 2)
    ang = np.pi * cls / n_classes
    u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
    v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
    if cls % 2 == 0:                        # bar
        m = (np.abs(u) < t * 0.30) & (np.abs(v) < t * (0.04 + 0.012 * (cls // 2)))
    else:                                   # twin dots
        s = t * (0.05 + 0.015 * (cls // 2))
        d1 = (u - t * 0.12) ** 2 + v ** 2 < s ** 2
        d2 = (u + t * 0.12) ** 2 + v ** 2 < s ** 2
        m = d1 | d2
    return contrast * m.astype(np.float32)


def _cloud(rng, t):
    yy, xx = np.mgrid[0:t, 0:t].astype(np.float32)
    img = np.zeros((t, t), np.float32)
    for _ in range(3):
        cy, cx = rng.uniform(0, t, 2)
        r = rng.uniform(0.4 * t, 0.9 * t)
        img += np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (r ** 2)))
    return np.clip(0.75 + 0.2 * img, 0, 1.0)


def make_tiles(n: int, cfg: EOConfig = EOConfig()):
    """Returns (tiles (n, t, t, 3) f32, labels (n,) int64 [-1 = cloudy],
    cloudy (n,) bool)."""
    rng = np.random.default_rng(cfg.seed)
    t = cfg.tile
    tiles = np.empty((n, t, t, 3), np.float32)
    labels = np.full((n,), -1, np.int64)
    cloudy = np.zeros((n,), bool)
    dup_pool = []
    for i in range(n):
        r = rng.random()
        if r < cfg.cloud_fraction:
            base = _cloud(rng, t)
            cloudy[i] = True
        else:
            base = _terrain(rng, t)
            cls = int(rng.integers(0, cfg.n_classes))
            base = base + _object(rng, t, cls, cfg.n_classes, cfg.contrast)
            labels[i] = cls
            if rng.random() < cfg.dup_fraction and dup_pool:
                j = dup_pool[int(rng.integers(0, len(dup_pool)))]
                tiles[i] = tiles[j] + rng.normal(
                    0, 0.004, tiles[j].shape).astype(np.float32)
                labels[i] = labels[j]
                continue
            dup_pool.append(i)
        img = np.stack([base] * 3, -1)
        img += rng.normal(0, cfg.noise, img.shape).astype(np.float32) * \
            np.array([1.0, 0.9, 1.1], np.float32)
        tiles[i] = np.clip(img, 0, 1)
    return tiles, labels, cloudy


# dataset "versions" for Figure 6 (DOTA-v1-like vs DOTA-v2-like regimes)
V1 = EOConfig(cloud_fraction=0.86, dup_fraction=0.30, seed=1)
V2 = EOConfig(cloud_fraction=0.33, dup_fraction=0.10, seed=2)
