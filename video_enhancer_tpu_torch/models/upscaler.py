"""CNN 2x upscaler and the bicubic fallback: the basic enhancement path.

Counterpart of video_enhancer_tpu/models/upscaler.py: an ESPCN-style
residual net whose convs run at 1/s2d resolution (space to depth by
``s2d``), a sub-pixel head, and a bicubic skip; the head starts at zero, so
an untrained model returns exact bicubic. Frames ``(B, H, W, 3)`` in [0, 1]
-> ``(B, scale*H, scale*W, 3)``; H and W must be divisible by ``s2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from ..ops.resize import resize

__all__ = ["init", "apply", "bicubic_upscale"]


def init(gen: torch.Generator, features: int = 128, scale: int = 2,
         depth: int = 3, s2d: int = 4) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts."""
    cin = 3 * s2d * s2d
    return {
        "embed": nn.conv2d_init(gen, 3, 3, cin, features),
        "blocks": [nn.conv2d_init(gen, 3, 3, features, features)
                   for _ in range(depth)],
        "head": nn.conv2d_init(gen, 3, 3, features, 3 * (scale * s2d) ** 2,
                               zero=True),
    }


def apply(params: dict, x: torch.Tensor, scale: int = 2,
          s2d: int = 4) -> torch.Tensor:
    z = pixel_unshuffle(x, s2d)
    h = F.relu(nn.conv2d_apply(params["embed"], z))
    for blk in params["blocks"]:
        h = h + F.relu(nn.conv2d_apply(blk, h))
    res = pixel_shuffle(nn.conv2d_apply(params["head"], h), scale * s2d)
    base = resize(x, (x.shape[-3] * scale, x.shape[-2] * scale),
                  antialias=False)
    return nn.clip(base + res, 0.0, 1.0)


def bicubic_upscale(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Pure bicubic upscale, clipped to [0, 1]."""
    return torch.clamp(resize(x, (x.shape[-3] * scale, x.shape[-2] * scale),
                              antialias=False), 0.0, 1.0)
