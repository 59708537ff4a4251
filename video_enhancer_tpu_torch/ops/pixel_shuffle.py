"""Depth-to-space for sub-pixel upsampling and its inverse, channels-last.

Counterpart of video_enhancer_tpu/ops/pixel_shuffle.py: ``pixel_shuffle``
``(..., H, W, C*s*s) -> (..., H*s, W*s, C)`` with the channels blocked as
(c_out, s, s), torch PixelShuffle's order; ``pixel_unshuffle`` the inverse.
"""

from __future__ import annotations

import torch

__all__ = ["pixel_shuffle", "pixel_unshuffle"]


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    *lead, h, w, c = x.shape
    if c % (scale * scale):
        raise ValueError(f"channels {c} not divisible by scale^2={scale * scale}")
    c_out = c // (scale * scale)
    x = x.reshape(*lead, h, w, c_out, scale, scale)
    nd = x.ndim
    # (..., H, s_h, W, s_w, c_out)
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 2, nd - 4, nd - 1, nd - 3)
    return x.permute(perm).reshape(*lead, h * scale, w * scale, c_out)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``(..., H*s, W*s, C) -> (..., H, W, C*s*s)`` (space to depth)."""
    *lead, hs, ws, c = x.shape
    if hs % scale or ws % scale:
        raise ValueError(f"spatial dims ({hs},{ws}) not divisible by {scale}")
    h, w = hs // scale, ws // scale
    x = x.reshape(*lead, h, scale, w, scale, c)
    nd = x.ndim
    # (..., h, w, c, s_h, s_w)
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 3, nd - 1, nd - 4, nd - 2)
    return x.permute(perm).reshape(*lead, h, w, c * scale * scale)
