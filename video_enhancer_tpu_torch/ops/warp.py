"""Backward warping by a flow: the gather form and the sub-pixel form.

Counterpart of video_enhancer_tpu/ops/warp.py. Flow is stored as (dy, dx),
not in ``grid_sample``'s (x, y) order; the border is clamped (replicate) and
pixel centres lie on integer coordinates (align_corners=True).

- ``grid_sample`` and ``flow_warp``: bilinear gathers at any distance
  (:18-110). The weights ``wy``, ``wx`` are cast to the image's dtype and
  the blend runs in it, as in the JAX package, whose packed gathers fetch
  the same four corners.
- ``flow_warp_local``: for |flow| < 1 the bilinear corners lie in the 3x3
  neighbourhood, so out = sum over s in {-1,0,1}^2 of hat(dy - sy) hat(dx -
  sx) shift(img, sy, sx), hat(u) = max(0, 1 - |u|) (:113-155).
"""

from __future__ import annotations

import torch

__all__ = ["flow_warp", "flow_warp_local", "grid_sample"]


def _bilinear(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
              wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Blend the four corners of ``img (B, H, W, C)`` at the clamped
    integer corners ``y0``, ``x0`` (``(B, ...)``) with weights in the
    image's dtype."""
    B, H, W, C = img.shape
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    flat = img.reshape(B, H * W, C)

    def take(yi, xi):
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yi.shape, C)

    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img (H, W, C)`` at absolute pixel coordinates
    ``coords (..., 2)`` as (y, x)."""
    h, w = img.shape[0], img.shape[1]
    y = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    x = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    wy = (y - y0.to(img.dtype))[..., None]
    wx = (x - x0.to(img.dtype))[..., None]
    return _bilinear(img[None], y0[None], x0[None], wy[None], wx[None])[0]


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``out[y, x] = img[y + dy, x + dx]``: img ``(..., H, W, C)``, flow
    ``(..., H, W, 2)``; the coordinates in fp32."""
    lead = img.shape[:-3]
    H, W, C = img.shape[-3:]
    img = img.reshape(-1, H, W, C)
    ff = flow.reshape(-1, H, W, 2).float()
    rows = torch.arange(H, dtype=torch.float32, device=img.device)
    cols = torch.arange(W, dtype=torch.float32, device=img.device)
    y = torch.clamp(rows[None, :, None] + ff[..., 0], 0.0, H - 1.0)
    x = torch.clamp(cols[None, None, :] + ff[..., 1], 0.0, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    wy = (y - y0)[..., None].to(img.dtype)
    wx = (x - x0)[..., None].to(img.dtype)
    return _bilinear(img, y0, x0, wy, wx).reshape(*lead, H, W, C)


def _shift(a: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """out[i] = a[clamp(i + s)] along ``dim``."""
    if s == 0:
        return a
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + s, 0, n - 1)
    return a.index_select(dim, idx)


def flow_warp_local(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img ``(..., H, W, C)``; flow ``(..., H, W, 2)`` as (dy, dx). Where
    autograd records it, the tent weights ``max(0, 1 - |d - s|)`` take the
    JAX package's gradients at an integer flow (vsrm's offsets at init are
    exactly 0): ``|u|``'s is +1 at u = 0 (``lax.abs``), and
    ``torch.maximum`` passes half at the tie with 0 (``lax.max``);
    ``torch.abs`` and ``clamp`` would give 0 and 1. Else the tents are
    ``clamp(1 - |d - s|, min=0)``, the same values in fewer ops."""
    ff = flow.to(img.dtype)
    dy, dx = ff[..., 0:1], ff[..., 1:2]
    h_ax, w_ax = img.ndim - 3, img.ndim - 2
    out = torch.zeros_like(img)
    if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
        zero = torch.zeros((), dtype=img.dtype, device=img.device)

        def tent(u):
            return torch.maximum(zero, 1.0 - torch.where(u >= 0, u, -u))
    else:
        def tent(u):
            return torch.clamp(1.0 - torch.abs(u), min=0.0)

    for sy in (-1, 0, 1):
        wy = tent(dy - sy)
        row = _shift(img, sy, h_ax)
        for sx in (-1, 0, 1):
            wx = tent(dx - sx)
            out = out + wy * wx * _shift(row, sx, w_ax)
    return out
