"""Sub-pixel backward warp as a 3x3 shift-and-blend.

Counterpart of video_enhancer_tpu/ops/warp.py ``flow_warp_local``: for
|flow| < 1 the bilinear corners lie in the 3x3 neighbourhood, so
out = sum over s in {-1,0,1}^2 of hat(dy - sy) hat(dx - sx) shift(img, sy,
sx), hat(u) = max(0, 1 - |u|), with edge clamp. Flow is stored as (dy, dx),
not in ``grid_sample``'s (x, y) order.
"""

from __future__ import annotations

import torch

__all__ = ["flow_warp_local"]


def _shift(a: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """out[i] = a[clamp(i + s)] along ``dim``."""
    if s == 0:
        return a
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + s, 0, n - 1)
    return a.index_select(dim, idx)


def flow_warp_local(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img ``(..., H, W, C)``; flow ``(..., H, W, 2)`` as (dy, dx)."""
    ff = flow.to(img.dtype)
    dy, dx = ff[..., 0:1], ff[..., 1:2]
    h_ax, w_ax = img.ndim - 3, img.ndim - 2
    out = torch.zeros_like(img)
    for sy in (-1, 0, 1):
        wy = torch.clamp(1.0 - torch.abs(dy - sy), min=0.0)
        row = _shift(img, sy, h_ax)
        for sx in (-1, 0, 1):
            wx = torch.clamp(1.0 - torch.abs(dx - sx), min=0.0)
            out = out + wy * wx * _shift(row, sx, w_ax)
    return out
