"""Convolutions in the JAX package's channels-last layouts.

Counterpart of the plain parts of video_enhancer_tpu/ops/conv.py. Layouts
at the public functions stay those of the JAX package: frames ``(B, H, W,
C)``, clips ``(B, T, H, W, C)``, sequences ``(B, L, C)``. Weights are in
PyTorch's layout (runtime/weights.py converts the bundled checkpoints).
Padding is XLA's SAME: ``lo = (k - 1) // 2``, ``hi = k - 1 - lo``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv3d", "depthwise_conv1d"]


def _same(k: int) -> tuple[int, int]:
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """``x (B, H, W, Cin)``, ``w (Cout, Cin, kh, kw)`` -> ``(B, H, W,
    Cout)``, SAME padding, stride 1."""
    return conv3d(x[:, None], w[:, :, None], b)[:, 0]


def conv3d(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """``x (B, T, H, W, Cin)``, ``w (Cout, Cin, 1, kh, kw)`` -> ``(B, T, H,
    W, Cout)``. Only a temporal kernel of 1 (every conv of the served models
    on this path), which makes it a 2-D conv over the B*T frames. The
    channels-last input is handed to cuDNN as an NCHW view with
    channels-last strides, so no transpose is materialised."""
    if w.shape[2] != 1:
        raise ValueError(f"conv3d takes a temporal kernel of 1, got {w.shape[2]}")
    B, T, H, W, C = x.shape
    kh, kw = w.shape[3], w.shape[4]
    xi = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = _same(kh), _same(kw)
    if ph0 == ph1 and pw0 == pw1:
        pad = (ph0, pw0)
    else:
        xi = F.pad(xi, (pw0, pw1, ph0, ph1))
        pad = (0, 0)
    out = F.conv2d(xi, w[:, :, 0].to(x.dtype),
                   None if b is None else b.to(x.dtype), padding=pad)
    return out.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """SAME depthwise conv over a sequence: ``x (B, L, C)``, ``w (C, 1, k)``.
    Computed in fp32 and cast back to ``x``'s dtype, as the JAX package's
    conv accumulates in fp32 (ops/conv.py:126-149)."""
    C, k = w.shape[0], w.shape[2]
    lo, hi = _same(k)
    xi = F.pad(x.float().transpose(1, 2), (lo, hi))
    out = F.conv1d(xi, w.float(), None if b is None else b.float(), groups=C)
    return out.transpose(1, 2).to(x.dtype,
                                  memory_format=torch.contiguous_format)
