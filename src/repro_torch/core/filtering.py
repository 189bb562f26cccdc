"""Onboard redundancy filtering (paper sections II and IV): 80-90% of raw
EO data over southwest China is invalid due to cloud cover; discarding
cloudy / low-information tiles BEFORE inference and downlink is where
the bulk of the paper's 90% data reduction comes from (Figure 6).  The
twin of the JAX package's ``core/filtering.py``, on tensors.

Two filters, composable:
  * cloud filter: clouds are bright and low-texture: mean brightness
    above ``bright_thresh`` AND variance below ``texture_thresh``.
  * redundancy filter: near-duplicate tiles (60% of remote-sensing
    images are highly similar [paper section II]): tiles whose
    downsampled signature matches an earlier tile's are dropped.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

F32 = torch.float32
# signature differences held at once by redundancy_mask: a row block of
# (rows, N, sig_grid**2) fp32 (64 MB), not the whole (N, N, G) tensor
_BLOCK_ELEMS = 1 << 24


@dataclass(frozen=True)
class CloudFilterConfig:
    bright_thresh: float = 0.72
    texture_thresh: float = 0.012
    sig_grid: int = 4            # signature resolution for dedup
    sig_tol: float = 0.035       # L-inf tolerance for "duplicate"


def cloud_mask(tiles: torch.Tensor,
               cfg: CloudFilterConfig = CloudFilterConfig()) -> torch.Tensor:
    """tiles: (N, t, t, C) in [0,1].  True = cloudy (drop)."""
    lum = tiles.to(F32).mean(dim=-1)                         # (N, t, t)
    mean_b = lum.mean(dim=(1, 2))
    # the population variance, as jnp.var: torch's default correction=1
    # would flip tiles near texture_thresh
    var_t = torch.var(lum, dim=(1, 2), correction=0)
    return (mean_b > cfg.bright_thresh) & (var_t < cfg.texture_thresh)


def tile_signature(tiles: torch.Tensor, grid: int) -> torch.Tensor:
    """Downsampled luminance signature (N, grid*grid)."""
    N, t = tiles.shape[:2]
    lum = tiles.to(F32).mean(dim=-1)
    s = t // grid
    sig = lum[:, :grid * s, :grid * s].reshape(N, grid, s, grid, s)
    return sig.mean(dim=(2, 4)).reshape(N, -1)


def redundancy_mask(tiles: torch.Tensor,
                    cfg: CloudFilterConfig = CloudFilterConfig()):
    """True = near-duplicate of an EARLIER tile in the batch (drop).
    O(N^2) signature comparison, N being the per-pass tile count, taken
    in row blocks: row i needs only the columns before it, and the L-inf
    distance and "any earlier" give the same answer in any order."""
    sig = tile_signature(tiles, cfg.sig_grid)                # (N, G)
    N, G = sig.shape
    rows = max(1, _BLOCK_ELEMS // max(N * G, 1))
    out = torch.zeros(N, dtype=torch.bool, device=sig.device)
    col = torch.arange(N, device=sig.device)
    for r0 in range(0, N, rows):
        r1 = min(r0 + rows, N)
        d = (sig[r0:r1, None, :] - sig[None, :r1, :]).abs().amax(dim=-1)
        earlier = col[None, :r1] < col[r0:r1, None]
        out[r0:r1] = ((d < cfg.sig_tol) & earlier).any(dim=1)
    return out


def filter_tiles(tiles: torch.Tensor,
                 cfg: CloudFilterConfig = CloudFilterConfig()):
    """Returns (keep_mask (N,), stats dict).  keep = not cloudy and not
    redundant.  The rates are 0-dim fp32 tensors on the tiles' device."""
    cloudy = cloud_mask(tiles, cfg)
    dup = redundancy_mask(tiles, cfg)
    keep = ~(cloudy | dup)
    stats = {
        "n_tiles": tiles.shape[0],
        "cloud_rate": cloudy.to(F32).mean(),
        "dup_rate": dup.to(F32).mean(),
        "filter_rate": 1.0 - keep.to(F32).mean(),
    }
    return keep, stats
