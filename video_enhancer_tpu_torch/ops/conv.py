"""Convolutions in the JAX package's channels-last layouts.

Counterpart of the plain parts of video_enhancer_tpu/ops/conv.py. Layouts
at the public functions stay those of the JAX package: frames ``(B, H, W,
C)``, clips ``(B, T, H, W, C)``, sequences ``(B, L, C)``. Weights are in
PyTorch's layout (runtime/weights.py converts the bundled checkpoints).
Padding is XLA's SAME: ``lo = (k - 1) // 2``, ``hi = k - 1 - lo``
(``depthwise_conv1d`` also takes explicit padding).
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


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           groups: int = 1) -> torch.Tensor:
    """``x (B, T, H, W, Cin)``, ``w (Cout, Cin / groups, kt, kh, kw)`` ->
    ``(B, T, H, W, Cout)``. A temporal kernel of 1 makes it a 2-D conv over
    the B*T frames: the channels-last input is handed to cuDNN as an NCHW
    view with channels-last strides, so no transpose is materialised. The
    one conv of the served models with kt > 1 is fast_mamba_vsr's (3, 1, 1)
    temporal residual on 3 channels: ``_temporal_conv``."""
    if w.shape[2] != 1:
        if w.shape[3] != 1 or w.shape[4] != 1 or groups != 1:
            raise ValueError(f"conv3d takes kt > 1 only with a 1x1 spatial "
                             f"kernel and no groups, got {tuple(w.shape)}")
        return _temporal_conv(x, w, b)
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
                   None if b is None else b.to(x.dtype), padding=pad,
                   groups=groups)
    return out.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


def _temporal_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """A ``(kt, 1, 1)`` conv over the frames, SAME (zero) padding: per tap,
    a channel product of the shifted clip, summed in fp32 and cast back, as
    the JAX package's ``_tiny_temporal_conv3d`` (ops/conv.py:80-113)."""
    kt, t = w.shape[2], x.shape[1]
    lo, hi = _same(kt)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, 0, lo, hi))
    wf = w[:, :, :, 0, 0].float()                        # (Cout, Cin, kt)
    acc = 0.0 if b is None else b.float()
    for k in range(kt):
        acc = acc + torch.einsum("bthwc,dc->bthwd", xf[:, k:k + t], wf[..., k])
    return acc.to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None,
                     padding="SAME") -> torch.Tensor:
    """Depthwise conv over a sequence: ``x (B, L, C)``, ``w (C, 1, k)``.
    ``padding`` is ``"SAME"`` or the JAX package's explicit ``((lo, hi),)``
    (ssm's causal ``((k - 1, 0),)`` and anti-causal ``((0, k - 1),)``).
    Computed in fp32 and cast back to ``x``'s dtype, as the JAX package's
    conv accumulates in fp32 (ops/conv.py:126-149)."""
    C, k = w.shape[0], w.shape[2]
    (lo, hi), = [_same(k)] if padding == "SAME" else padding
    xi = F.pad(x.float().transpose(1, 2), (lo, hi))
    out = F.conv1d(xi, w.float(), None if b is None else b.float(), groups=C)
    return out.transpose(1, 2).to(x.dtype,
                                  memory_format=torch.contiguous_format)
