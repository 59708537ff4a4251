"""The released architectures whose checkpoints the port serves: RRDBNet
(Real-ESRGAN's ``RealESRGAN_x4plus.pth``) and IFNet (RIFE's ``flownet.pkl``,
IFNet_HDv3).

Counterpart of video_enhancer_tpu/models/official_arch.py (RRDBNet :46-103,
IFNet :112-216). The parameter trees are keyed like the official state
dicts, so a ``.pth`` loads through runtime/weights.py (``try_load_params``)
key for key. Weights are in PyTorch's layouts: Conv2d ``(out, in, kh,
kw)``, the IFBlocks' ``lastconv`` in ConvTranspose2d's ``(in, out, kh,
kw)`` (the checkpoint's own tensor: runtime/weights.py permutes a ``.pth``'s
4-D weights one way and back), PReLU's 1-D ``weight`` under ``w``.

- RRDBNet: 23 residual-in-residual dense blocks, two nearest-x2 upsampling
  convs, ``conv_hr``, ``conv_last``; no bicubic base and no clamp.
- IFNet: three IFBlocks at 1/4, 1/2 and 1/1 of the frame (each a pair of
  stride-2 conv + PReLU with torch's (1, 1) padding, eight conv + PReLU, a
  stride-2 ConvTranspose2d), bilinear resizes without antialias on the way
  down, flows in torch's (dx, dy) order swapped to ``flow_warp``'s (dy,
  dx) at each warp, and a sigmoid mask blending the two warped frames.
  Its convs round once, as the JAX package's and the port's RIFE do
  (models/rife.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.resize import resize
from ..ops.warp import flow_warp
from .realesrgan import rdb_apply

__all__ = ["rrdb_official_init", "rrdb_official_apply",
           "ifnet_official_init", "ifnet_official_apply"]


# --- Real-ESRGAN RRDBNet -----------------------------------------------------


def _rdb_official_init(gen, feat: int, growth: int) -> dict:
    return {f"conv{i + 1}": nn.conv2d_init(gen, 3, 3, feat + i * growth,
                                           growth if i < 4 else feat)
            for i in range(5)}


def rrdb_official_init(gen: torch.Generator, features: int = 64,
                       num_blocks: int = 23, growth: int = 32) -> dict:
    """Parameters keyed exactly like ``RealESRGAN_x4plus.pth``."""
    return {
        "conv_first": nn.conv2d_init(gen, 3, 3, 3, features),
        "body": [{f"rdb{j + 1}": _rdb_official_init(gen, features, growth)
                  for j in range(3)} for _ in range(num_blocks)],
        **{name: nn.conv2d_init(gen, 3, 3, features, features)
           for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr")},
        "conv_last": nn.conv2d_init(gen, 3, 3, features, 3),
    }


def rrdb_official_apply(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Official RRDBNet x4: ``(B, H, W, 3) -> (B, 4H, 4W, 3)``."""
    feat = nn.conv2d_apply(params["conv_first"], frames)
    h = feat
    for block in params["body"]:
        inner = h
        for j in range(3):
            rdb = block[f"rdb{j + 1}"]
            inner = rdb_apply([rdb[f"conv{i + 1}"] for i in range(5)], inner)
        h = h + 0.2 * inner
    feat = feat + nn.conv2d_apply(params["conv_body"], h)
    hh, ww = feat.shape[-3:-1]
    for i, f in ((1, 2), (2, 4)):
        feat = resize(feat, (hh * f, ww * f), method="nearest")
        feat = F.leaky_relu(nn.conv2d_apply(params[f"conv_up{i}"], feat), 0.2)
    feat = F.leaky_relu(nn.conv2d_apply(params["conv_hr"], feat), 0.2)
    return nn.conv2d_apply(params["conv_last"], feat)


# --- RIFE IFNet (IFNet_HDv3) -------------------------------------------------


def _conv_prelu_init(gen, cin: int, cout: int) -> list:
    return [nn.conv2d_init(gen, 3, 3, cin, cout),
            {"w": torch.full((cout,), 0.25)}]


def _conv_prelu_apply(p: list, x: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    pad = "SAME" if stride == 1 else ((1, 1), (1, 1))
    h = nn.conv2d_apply(p[0], x, stride=stride, padding=pad,
                        round_once=True)
    return torch.where(h >= 0, h, p[1]["w"].to(h.dtype) * h)


def _ifblock_official_init(gen, in_planes: int, c: int) -> dict:
    return {
        "conv0": [_conv_prelu_init(gen, in_planes, c // 2),
                  _conv_prelu_init(gen, c // 2, c)],
        "convblock": [_conv_prelu_init(gen, c, c) for _ in range(8)],
        # ConvTranspose2d(c, 5, 4, 2, 1): (in, out, kh, kw)
        "lastconv": {"w": torch.randn((c, 5, 4, 4), generator=gen) * 0.01,
                     "b": torch.zeros(5)},
    }


def ifnet_official_init(gen: torch.Generator, c: int = 90) -> dict:
    """Parameters keyed like the released ``flownet.pkl`` (HDv3): three
    IFBlocks of 11 input channels (two frames, the mask, four flow)."""
    return {f"block{i}": _ifblock_official_init(gen, 11, c) for i in range(3)}


def _ifblock_official_apply(p: dict, x: torch.Tensor, flow: torch.Tensor,
                            scale: int):
    hw = x.shape[-3:-1]
    if scale != 1:
        low = (hw[0] // scale, hw[1] // scale)
        x = resize(x, low, antialias=False, method="linear")
        flow = resize(flow, low, antialias=False, method="linear") * (
            1.0 / scale)
    h = torch.cat([x, flow], dim=-1)
    h = _conv_prelu_apply(p["conv0"][0], h, stride=2)
    h = _conv_prelu_apply(p["conv0"][1], h, stride=2)
    g = h
    for cp in p["convblock"]:
        g = _conv_prelu_apply(cp, g)
    tmp = nn.conv_transpose2d_apply(p["lastconv"], g + h)
    tmp = resize(tmp, hw, method="linear")
    return tmp[..., :4] * (scale * 2.0), tmp[..., 4:5]


def ifnet_official_apply(params: dict, img0: torch.Tensor, img1: torch.Tensor,
                         scale_list=(4, 2, 1)) -> torch.Tensor:
    """The midpoint frame of ``(B, H, W, 3)`` frames, coarse to fine."""
    b, h, w, _ = img0.shape
    flow = img0.new_zeros((b, h, w, 4))
    mask = img0.new_zeros((b, h, w, 1))
    warped0, warped1 = img0, img1
    for i, s in enumerate(scale_list):
        x = torch.cat([warped0, warped1, mask], dim=-1)
        f, m = _ifblock_official_apply(params[f"block{i}"], x, flow, s)
        flow = flow + f
        mask = mask + m
        warped0 = flow_warp(img0, flow[..., [1, 0]])
        warped1 = flow_warp(img1, flow[..., [3, 2]])
    m = torch.sigmoid(mask)
    return warped0 * m + warped1 * (1.0 - m)
