"""Overlap-tile blending.

Counterpart of video_enhancer_tpu/ops/blend.py: each tile is weighted by a
separable linspace ramp and added into a canvas with its weight map; the
canvas is divided by the summed weights.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tile_weights", "overlap_add_blend"]


def _ramp(size: int, overlap: int) -> np.ndarray:
    w = np.ones(size, dtype=np.float32)
    if overlap > 0:
        r = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1]
        w[:overlap] = r
        w[-overlap:] = r[::-1]
    return w


def tile_weights(tile_hw: tuple[int, int], overlap: int) -> np.ndarray:
    """Separable blending weight map ``(H, W, 1)`` of a tile."""
    h, w = tile_hw
    return (_ramp(h, overlap)[:, None] * _ramp(w, overlap)[None, :])[..., None]


def overlap_add_blend(tiles: torch.Tensor, origins, out_hw: tuple[int, int],
                      overlap: int) -> torch.Tensor:
    """Blend ``tiles (N, ..., th, tw, C)`` placed at ``origins`` (N pairs of
    (y, x)) into ``(..., H, W, C)``. The leading ``...`` (e.g. the frames of
    a clip) is blended alike, where the JAX package maps over it."""
    n = tiles.shape[0]
    *lead, th, tw, c = tiles.shape[1:]
    h, w = out_hw
    wmap = torch.from_numpy(tile_weights((th, tw), overlap)).to(tiles.device)
    canvas = torch.zeros((*lead, h, w, c), dtype=torch.float32,
                         device=tiles.device)
    weight = torch.zeros((h, w, 1), dtype=torch.float32, device=tiles.device)
    for i in range(n):
        y, x = (int(v) for v in origins[i])
        canvas[..., y:y + th, x:x + tw, :] += tiles[i].float() * wmap
        weight[y:y + th, x:x + tw, :] += wmap
    return (canvas / torch.clamp(weight, min=1e-8)).to(tiles.dtype)
