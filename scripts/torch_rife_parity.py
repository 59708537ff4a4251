#!/usr/bin/env python3
"""RIFE's bf16 ops on the card against the CPU, one at a time.

    python3 scripts/torch_rife_parity.py [--height 64] [--width 96]
        [--device cuda]

The port's RIFE (models/rife.py, bundled weights, bf16) computes each op in
bf16 and rounds after it, as the JAX package does. Where two devices round
an op differently, the flows carry the difference to the midframe. This
script feeds the same bf16 inputs to each op on ``--device`` and on the
CPU and prints the share of outputs that differ and the largest
difference: a conv of the first IFBlock with and without its bias, the
same conv as an fp32 conv of the bf16 values with the bias added in fp32
and one rounding, the linear resizes, a warp, the leaky ReLU and the
sigmoid; then the whole midframe of one pair (over 255, rounded: max and
mean LSB) as served (its convs rounded once, ``round_once``) and with the
convs as plain bf16 ``F.conv2d`` with the bias. Prints one JSON line of
the figures.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_enhancer_tpu_torch import nn  # noqa: E402
from video_enhancer_tpu_torch.models import rife  # noqa: E402
from video_enhancer_tpu_torch.ops.conv import conv2d  # noqa: E402
from video_enhancer_tpu_torch.ops.resize import resize  # noqa: E402
from video_enhancer_tpu_torch.ops.warp import flow_warp  # noqa: E402
from video_enhancer_tpu_torch.runtime.rife_handler import \
    RIFEHandler  # noqa: E402


def _frames(h: int, w: int, seed: int = 0) -> torch.Tensor:
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = g.uniform(0, 2 * np.pi, 3)
    clip = np.stack([np.stack(
        [0.5 + 0.3 * np.sin(0.15 * (xx - 2.5 * i) + 0.1 * (yy + 1.5 * i)
                            + ph[c]) for c in range(3)], -1)
        for i in range(2)]) + g.normal(0, 0.02, (2, h, w, 3))
    return torch.from_numpy(np.clip(clip, 0, 1).astype(np.float32))


def _conv_once(p: dict, x: torch.Tensor) -> torch.Tensor:
    """fp32 conv of the bf16 values, fp32 bias, one rounding."""
    return conv2d(x.float(), p["w"].float(), p["b"].float()).to(x.dtype)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_h = RIFEHandler(device="cpu")
    dev_h = RIFEHandler(device=dev)
    clip = _frames(args.height, args.width)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((1, args.height // 2, args.width // 2, 11),
                   generator=g).bfloat16()
    flow = (torch.randn((1, args.height, args.width, 2), generator=g)
            * 3).bfloat16()
    h = (torch.randn((1, args.height, args.width, 32), generator=g)
         * 2).bfloat16()
    blk = cpu_h.params["blocks"][1]
    ops = {
        "conv+bias": lambda p, t: nn.conv2d_apply(p, t),
        "conv": lambda p, t: nn.conv2d_apply({"w": p["w"]}, t),
        "conv once": _conv_once,
        "resize down": lambda p, t: resize(t, (t.shape[1] // 2,
                                               t.shape[2] // 2),
                                           method="linear"),
        "resize up": lambda p, t: resize(t, (t.shape[1] * 2,
                                             t.shape[2] * 2),
                                         method="linear"),
    }
    out = {}
    for name, fn in ops.items():
        a = fn(blk["c1"], x)
        b = fn({k: v.to(dev) for k, v in blk["c1"].items()}, x.to(dev)).cpu()
        out[name] = [float((a != b).float().mean()),
                     float((a.float() - b.float()).abs().max())]
    img = clip[:1].bfloat16()
    for name, a, b in (
            ("warp", flow_warp(img, flow),
             flow_warp(img.to(dev), flow.to(dev)).cpu()),
            ("lrelu", rife._lrelu(h), rife._lrelu(h.to(dev)).cpu()),
            ("sigmoid", rife._sigmoid(h), rife._sigmoid(h.to(dev)).cpu())):
        out[name] = [float((a != b).float().mean()),
                     float((a.float() - b.float()).abs().max())]

    def mid(handler, d):
        return handler._mid(clip[:1].to(d), clip[1:].to(d)).cpu()

    def lsb(a, b):
        d = (torch.round(a * 255) - torch.round(b * 255)).abs()
        return [float(d.max()), float(d.mean())]

    out["midframe LSB"] = lsb(mid(cpu_h, "cpu"), mid(dev_h, dev))
    real = rife._conv
    rife._conv = nn.conv2d_apply
    try:
        out["midframe LSB, bf16 conv + bias"] = lsb(mid(cpu_h, "cpu"),
                                                    mid(dev_h, dev))
    finally:
        rife._conv = real
    for k, v in out.items():
        print(f"{k:34s} {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
