"""The bundled neural face detector: a small anchor-free center-heatmap net
over a 128x128 input.

Counterpart of video_enhancer_tpu/analysis/face_net.py. Input
``(B, 128, 128, 3)`` in [0, 1], space-to-depth by 2, a 3x3 stem, two
stride-2 3x3 convs with XLA's SAME padding ((0, 1) at these even sizes, not
torch's symmetric 1), two residual 3x3 convs and a 1x1 head: per cell of
the 16x16 grid (stride 8), one heatmap logit, two log-sizes (grid units)
and two center offsets (cell fractions). SiLU between. fp32, as the JAX
package runs it (TF32 off within ``detect``: ``device.full_fp32``); the
weights are ``weights/face_detector.npz``
(runtime/weights.py converts its layouts).

``decode`` stays on the host in numpy, as in the JAX package: a 3x3
local-max suppression of the sigmoid heatmap with a 1e-9 slack, then the
best ``max_faces`` above ``threshold``. ``detect`` resizes a uint8 frame of
any size to 128x128 as cv2's ``INTER_AREA`` does (ops/resize.py
``resize_area``), on ``device``, runs the net there and decodes on the
host: one device-to-host copy a frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..device import full_fp32, resolve_device
from ..ops.pixel_shuffle import pixel_unshuffle
from ..ops.resize import resize_area

__all__ = ["init", "apply", "decode", "net_input", "detect", "INPUT_SIZE",
           "STRIDE"]

INPUT_SIZE = 128
STRIDE = 8  # space-to-depth 2, then two stride-2 convs
GRID = INPUT_SIZE // STRIDE


def init(gen: torch.Generator, dim: int = 32) -> dict:
    return {
        "stem": nn.conv2d_init(gen, 3, 3, 12, dim),              # 64x64
        "down1": nn.conv2d_init(gen, 3, 3, dim, dim * 2),        # 32x32
        "down2": nn.conv2d_init(gen, 3, 3, dim * 2, dim * 4),    # 16x16
        "body1": nn.conv2d_init(gen, 3, 3, dim * 4, dim * 4),
        "body2": nn.conv2d_init(gen, 3, 3, dim * 4, dim * 4),
        "head": nn.conv2d_init(gen, 1, 1, dim * 4, 5),
    }


def apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, 128, 128, 3)`` in [0, 1] -> ``(B, 16, 16, 5)`` raw head
    outputs."""
    h = pixel_unshuffle(x, 2)
    h = F.silu(nn.conv2d_apply(p["stem"], h))
    h = F.silu(nn.conv2d_apply(p["down1"], h, stride=2))
    h = F.silu(nn.conv2d_apply(p["down2"], h, stride=2))
    h = F.silu(nn.conv2d_apply(p["body1"], h)) + h
    h = F.silu(nn.conv2d_apply(p["body2"], h)) + h
    return nn.conv2d_apply(p["head"], h)


def decode(out: np.ndarray, threshold: float = 0.45,
           max_faces: int = 8) -> list[tuple[float, float, float, float,
                                             float]]:
    """One head output ``(16, 16, 5)`` -> ``[(x, y, w, h, score)]`` in
    128-space."""
    logits = out[..., 0]
    heat = 1.0 / (1.0 + np.exp(-logits))
    padded = np.pad(heat, 1, constant_values=-1.0)
    windows = np.lib.stride_tricks.sliding_window_view(padded, (3, 3))
    keep = (heat >= windows.max(axis=(2, 3)) - 1e-9) & (heat >= threshold)
    ys, xs = np.nonzero(keep)
    order = np.argsort(heat[ys, xs])[::-1][:max_faces]
    boxes = []
    for i in order:
        gy, gx = int(ys[i]), int(xs[i])
        off = out[gy, gx, 3:5]
        cx = (gx + float(np.clip(off[0], 0.0, 1.0))) * STRIDE
        cy = (gy + float(np.clip(off[1], 0.0, 1.0))) * STRIDE
        bw = float(np.exp(np.clip(out[gy, gx, 1], -4.0, 4.0))) * STRIDE
        bh = float(np.exp(np.clip(out[gy, gx, 2], -4.0, 4.0))) * STRIDE
        boxes.append((cx - bw / 2, cy - bh / 2, bw, bh, float(heat[gy, gx])))
    return boxes


def net_input(frame_u8, device: torch.device) -> torch.Tensor:
    """A uint8 ``(H, W, 3)`` frame (numpy or a tensor) -> the net's
    ``(1, 128, 128, 3)`` fp32 input on ``device``."""
    t = torch.as_tensor(frame_u8).to(device)
    return resize_area(t, (INPUT_SIZE, INPUT_SIZE))[None].float() / 255.0


def detect(params: dict, frame, threshold: float = 0.45,
           device: str | torch.device | None = None
           ) -> list[tuple[int, int, int, int]]:
    """A uint8 RGB ``(H, W, 3)`` frame of any size (numpy or a tensor) ->
    ``[(x, y, w, h)]`` int boxes; ``params`` on ``device``."""
    dev = resolve_device(device)
    h, w = frame.shape[:2]
    with torch.inference_mode(), full_fp32():
        out = apply(params, net_input(frame, dev))[0].cpu().numpy()
    sx, sy = w / INPUT_SIZE, h / INPUT_SIZE
    boxes = []
    for bx, by, bw, bh, _ in decode(out, threshold=threshold):
        x0 = int(max(bx * sx, 0))
        y0 = int(max(by * sy, 0))
        boxes.append((x0, y0,
                      int(min(bw * sx, w - x0)), int(min(bh * sy, h - y0))))
    return [b for b in boxes if b[2] > 1 and b[3] > 1]
