"""RIFE-style frame interpolation: a coarse-to-fine IFNet and a refinement
conv pair.

Counterpart of video_enhancer_tpu/models/rife.py (init :45-57,
``interpolate_pair`` :60-109, ``apply`` :112-123): three IFBlocks (three
conv + leaky ReLU, a zero-initialised head of four flow channels and a mask
logit) at 1/4, 1/2 and 1/1 of the frame, with dims 128, 64 and 32. Each
level resizes the frames (linear, antialiased on the way down, replicated
borders: ops/resize.py), upsamples the flow (times 2) and the mask, and
feeds the frames warped by the flow (``flow_warp``, (dy, dx) pairs). The
finest level warps its guidance frames at half resolution and upsamples
them (:74-90). The output warps both frames at full resolution, blends them
by the sigmoid of the mask and adds the refinement convs' residual, clipped
to [0, 1]. Layout ``(B, H, W, 3)``, weights in Conv2d's layout.

In bf16 every op rounds as the JAX package's does, where PyTorch's would
leave a share of an op's outputs an ulp apart and the flows carry that to
the midframes: each conv sums and adds its bias in fp32 and rounds once
(``nn.conv2d_apply(round_once=True)``; cuDNN's bf16 conv rounds before its
bias), the leaky ReLU's slope multiplies in x's dtype as
``jax.nn.leaky_relu``'s weakly typed 0.2 does (bf16(0.2) = 0.2002), and
the sigmoid is ``1 / (1 + exp(-x))`` rounded after each step, as XLA
expands ``jax.nn.sigmoid``. In fp32 all three are the usual ops.
"""

from __future__ import annotations

import torch

from .. import nn
from ..ops.resize import resize
from ..ops.warp import flow_warp

__all__ = ["init", "interpolate_pair", "apply", "default_config"]


def default_config() -> dict:
    return {"dim": 32, "levels": 3}


def _conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.conv2d_apply(p, x, round_once=True)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * torch.tensor(0.2, dtype=x.dtype))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def _ifblock_init(gen: torch.Generator, cin: int, dim: int) -> dict:
    return {"c1": nn.conv2d_init(gen, 3, 3, cin, dim),
            "c2": nn.conv2d_init(gen, 3, 3, dim, dim),
            "c3": nn.conv2d_init(gen, 3, 3, dim, dim),
            "head": nn.conv2d_init(gen, 3, 3, dim, 5, zero=True)}


def _ifblock_apply(p: dict, x: torch.Tensor):
    h = x
    for name in ("c1", "c2", "c3"):
        h = _lrelu(_conv(p[name], h))
    out = _conv(p["head"], h)
    return out[..., :4], out[..., 4:5]


def init(gen: torch.Generator, dim: int = 32, levels: int = 3) -> dict:
    """Random parameters (fp32, CPU) from ``gen``: level 0 takes the two
    frames (6 channels), the others the warped frames, flow and mask (11)."""
    return {
        "blocks": [_ifblock_init(gen, 6 if i == 0 else 11,
                                 dim * 2 ** (levels - 1 - i))
                   for i in range(levels)],
        "refine1": nn.conv2d_init(gen, 3, 3, 13, dim),
        "refine2": nn.conv2d_init(gen, 3, 3, dim, 3, zero=True),
    }


def _linear(x: torch.Tensor, hw) -> torch.Tensor:
    return resize(x, hw, method="linear")


def interpolate_pair(params: dict, f0: torch.Tensor,
                     f1: torch.Tensor) -> torch.Tensor:
    """The midpoint frame between ``(B, H, W, 3)`` frames in [0, 1]."""
    _, h, w, _ = f0.shape
    levels = len(params["blocks"])
    flow = mask = None
    for lvl, blk in enumerate(params["blocks"]):
        s = 2 ** (levels - 1 - lvl)
        hw = (h // s, w // s)
        a = _linear(f0, hw) if s > 1 else f0
        c = _linear(f1, hw) if s > 1 else f1
        if flow is None:
            inp = torch.cat([a, c], dim=-1)
        else:
            if s == 1:
                # the guidance frames are warped at half resolution, where
                # the incoming flow lies, and upsampled
                hw2 = (h // 2, w // 2)
                wa = _linear(flow_warp(_linear(a, hw2), flow[..., 0:2]), hw)
                wc = _linear(flow_warp(_linear(c, hw2), flow[..., 2:4]), hw)
                flow = _linear(flow, hw) * 2.0
                mask = _linear(mask, hw)
            else:
                flow = _linear(flow, hw) * 2.0
                mask = _linear(mask, hw)
                wa = flow_warp(a, flow[..., 0:2])
                wc = flow_warp(c, flow[..., 2:4])
            inp = torch.cat([wa, wc, flow, mask], dim=-1)
        d_flow, d_mask = _ifblock_apply(blk, inp)
        flow = d_flow if flow is None else flow + d_flow
        mask = d_mask if mask is None else mask + d_mask

    w0 = flow_warp(f0, flow[..., 0:2])
    w1 = flow_warp(f1, flow[..., 2:4])
    m = _sigmoid(mask)
    mid = m * w0 + (1 - m) * w1
    r = _lrelu(_conv(params["refine1"],
                     torch.cat([mid, w0, w1, flow], dim=-1)))
    mid = mid + _conv(params["refine2"], r)
    return torch.clamp(mid, 0.0, 1.0)


def apply(params: dict, clip: torch.Tensor) -> torch.Tensor:
    """2x temporal upsampling of ``(B, T, H, W, 3)``: T -> 2T - 1, the
    midpoints between the input frames."""
    b, t, h, w, c = clip.shape
    if t < 2:
        return clip
    mids = interpolate_pair(params, clip[:, :-1].reshape(-1, h, w, c),
                            clip[:, 1:].reshape(-1, h, w, c))
    out = clip.new_empty((b, 2 * t - 1, h, w, c))
    out[:, 0::2] = clip
    out[:, 1::2] = mids.reshape(b, t - 1, h, w, c)
    return out
