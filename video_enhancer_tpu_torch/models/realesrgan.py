"""Real-ESRGAN-style RRDB single-frame x4 super-resolution.

Counterpart of video_enhancer_tpu/models/realesrgan.py: a stem conv, a trunk
of residual-in-residual dense blocks (three RDBs each, 0.2-scaled
residuals), a trunk conv, nearest upsampling to the output size, an ``up``
conv with leaky ReLU and a zero-initialised ``head``, added to the cubic
upscale (no antialias) and clipped to [0, 1]. Per frame: ``(B, H, W, 3) ->
(B, sH, sW, 3)``; the registry wraps it into a clip function over the B*T
frames of a window. Layout channels-last, weights in Conv2d's layout.

Each RDB runs in the dense form (each conv over the concatenation of the
block's input and the outputs before it), the official graph's and
PyTorch's idiom, where cuDNN takes the channels-last concatenation as it
stands. The JAX package's ``_rdb_apply`` computes the same function in a
"scatter" form chosen for the MXU's 128 lanes (each source's outgoing
weight slices fused into one wide conv, the outputs summed into each
destination): an exact reassociation, so the two meet in fp32 up to
rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.resize import resize

__all__ = ["init", "apply", "rdb_apply", "default_config"]


def default_config() -> dict:
    return {"features": 64, "num_blocks": 6, "growth": 32, "scale": 4}


def _rdb_init(gen: torch.Generator, feat: int, growth: int) -> list:
    return [nn.conv2d_init(gen, 3, 3, feat + i * growth,
                           growth if i < 4 else feat) for i in range(5)]


def rdb_apply(convs: list, x: torch.Tensor) -> torch.Tensor:
    """One residual dense block: ``x + 0.2 conv5([x, y1..y4])`` with ``y_i =
    lrelu(conv_i([x, y1..y_{i-1}]), 0.2)``."""
    feats = [x]
    for conv in convs[:-1]:
        feats.append(F.leaky_relu(nn.conv2d_apply(conv, torch.cat(feats, -1)),
                                  0.2))
    return x + 0.2 * nn.conv2d_apply(convs[-1], torch.cat(feats, -1))


def init(gen: torch.Generator, features: int = 64, num_blocks: int = 6,
         growth: int = 32, scale: int = 4) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, keyed as the JAX
    package's (``rrdb.<block>.<rdb>.<conv>``)."""
    return {
        "stem": nn.conv2d_init(gen, 3, 3, 3, features),
        "rrdb": [[_rdb_init(gen, features, growth) for _ in range(3)]
                 for _ in range(num_blocks)],
        "trunk": nn.conv2d_init(gen, 3, 3, features, features),
        "up": nn.conv2d_init(gen, 3, 3, features, features),
        "head": nn.conv2d_init(gen, 3, 3, features, 3, zero=True),
    }


def apply(params: dict, frames: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """``(B, H, W, 3)`` in [0, 1] -> ``(B, scale*H, scale*W, 3)``."""
    h0 = nn.conv2d_apply(params["stem"], frames)
    h = h0
    for rrdb in params["rrdb"]:
        inner = h
        for rdb in rrdb:
            inner = rdb_apply(rdb, inner)
        h = h + 0.2 * inner
    h = h0 + nn.conv2d_apply(params["trunk"], h)

    out_hw = (frames.shape[-3] * scale, frames.shape[-2] * scale)
    h = resize(h, out_hw, method="nearest")
    h = F.leaky_relu(nn.conv2d_apply(params["up"], h), 0.2)
    res = nn.conv2d_apply(params["head"], h)
    base = resize(frames, out_hw, antialias=False)
    return nn.clip(base + res, 0.0, 1.0)
