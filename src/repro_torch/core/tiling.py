"""Onboard image splitting (paper section IV): high-resolution EO frames
exceed the satellite's compute budget, so frames are split into
fixed-size tiles before in-orbit inference.  The twin of the JAX
package's ``core/tiling.py``, on tensors of (H, W, C) frames and
batches of them."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def tile_grid(H: int, W: int, tile: int) -> Tuple[int, int]:
    return -(-H // tile), -(-W // tile)


def split_batch(frames: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * n_tiles, tile, tile, C), frame by frame in
    row-major tile order; H, W padded up to a multiple of ``tile`` with
    zeros."""
    B, H, W, C = frames.shape
    nh, nw = tile_grid(H, W, tile)
    f = F.pad(frames, (0, 0, 0, nw * tile - W, 0, nh * tile - H))
    f = f.reshape(B, nh, tile, nw, tile, C).permute(0, 1, 3, 2, 4, 5)
    return f.reshape(-1, tile, tile, C)


def split_frame(frame: torch.Tensor, tile: int) -> torch.Tensor:
    """(H, W, C) -> (n_tiles, tile, tile, C); H, W padded up to tile."""
    return split_batch(frame[None], tile)


def merge_tiles(tiles: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of split_frame (drops padding)."""
    n, t, _, C = tiles.shape
    nh, nw = tile_grid(H, W, t)
    f = tiles.reshape(nh, nw, t, t, C).permute(0, 2, 1, 3, 4)
    return f.reshape(nh * t, nw * t, C)[:H, :W]
