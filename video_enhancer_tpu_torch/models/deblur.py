"""Deblurring experts: BSSTNet-style and VDDiff-style residual conv nets.

Counterpart of video_enhancer_tpu/models/deblur.py: three convs each
(3x3 or a 5x5 first for vddiff), ReLU or SiLU between them (vddiff's second
conv residual), the last conv zero-initialised so an untrained net returns
its input; the residual added to the frames and clipped to [0, 1]. No
route of either package reaches them. Frames ``(B, H, W, 3)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn

__all__ = ["bsstnet_init", "bsstnet_apply", "vddiff_init", "vddiff_apply"]


def bsstnet_init(gen: torch.Generator, dim: int = 32) -> dict:
    return {"c1": nn.conv2d_init(gen, 3, 3, 3, dim),
            "c2": nn.conv2d_init(gen, 3, 3, dim, dim),
            "c3": nn.conv2d_init(gen, 3, 3, dim, 3, zero=True)}


def bsstnet_apply(params: dict, frames: torch.Tensor) -> torch.Tensor:
    h = F.relu(nn.conv2d_apply(params["c1"], frames))
    h = F.relu(nn.conv2d_apply(params["c2"], h))
    return nn.clip(frames + nn.conv2d_apply(params["c3"], h), 0.0, 1.0)


def vddiff_init(gen: torch.Generator, dim: int = 32) -> dict:
    return {"c1": nn.conv2d_init(gen, 5, 5, 3, dim),
            "c2": nn.conv2d_init(gen, 3, 3, dim, dim),
            "c3": nn.conv2d_init(gen, 3, 3, dim, 3, zero=True)}


def vddiff_apply(params: dict, frames: torch.Tensor) -> torch.Tensor:
    h = F.silu(nn.conv2d_apply(params["c1"], frames))
    h = F.silu(nn.conv2d_apply(params["c2"], h)) + h
    return nn.clip(frames + nn.conv2d_apply(params["c3"], h), 0.0, 1.0)
