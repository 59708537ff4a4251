"""Pre- and post-processing experts, as torch ops on the clip's device.

Counterpart of video_enhancer_tpu/runtime/experts.py: each expert is a
function of a clip ``(T, H, W, 3)`` float32 in [0, 1].

- ``preprocess_clip`` (:21-69) runs compression cleanup, then denoising,
  then the low-light boost, as asked. The 3x3 binomial blur is a depthwise
  SAME stencil with zero padding, written as a sum of shifted slices (exact
  fp32 on any device).
- ``temporal_smooth`` (:85-96), the temporal-consistency post stage: each
  frame after the first is blended 0.7 / 0.3 with the previous *output*
  warped onto it by Farneback optical flow (ops/optflow.py, OpenCV's
  algorithm in torch), so the stage is sequential and causal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.optflow import estimate_flow_farneback
from ..ops.warp import flow_warp

__all__ = ["preprocess_clip", "denoise", "low_light_boost",
           "compression_cleanup", "temporal_smooth"]

_G3 = ((1 / 16, 2 / 16, 1 / 16), (2 / 16, 4 / 16, 2 / 16),
       (1 / 16, 2 / 16, 1 / 16))


def _gauss3(clip: torch.Tensor) -> torch.Tensor:
    h, w = clip.shape[1], clip.shape[2]
    xp = F.pad(clip, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(clip)
    for i in range(3):
        for j in range(3):
            out = out + _G3[i][j] * xp[:, i:i + h, j:j + w, :]
    return out


def denoise(clip: torch.Tensor, strength: float = 0.5) -> torch.Tensor:
    """Edge-preserving smoothing: blend toward the blur where gradients
    are low."""
    smooth = _gauss3(clip)
    edge = torch.clamp((clip - smooth).abs() * 8.0, 0.0, 1.0)
    alpha = strength * (1.0 - edge)
    return clip * (1 - alpha) + smooth * alpha


def low_light_boost(clip: torch.Tensor, gamma: float = 0.6) -> torch.Tensor:
    """Gamma lift and a mild contrast stretch about each frame's mean."""
    lifted = torch.pow(torch.clamp(clip, 1e-6, 1.0), gamma)
    mean = lifted.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(mean + (lifted - mean) * 1.05, 0.0, 1.0)


def compression_cleanup(clip: torch.Tensor) -> torch.Tensor:
    """Deblocking: a light blur, then an unsharp mask to recover edges."""
    deblocked = 0.6 * clip + 0.4 * _gauss3(clip)
    sharp = deblocked + 0.3 * (deblocked - _gauss3(deblocked))
    return torch.clamp(sharp, 0.0, 1.0)


def preprocess_clip(clip: torch.Tensor, do_denoise: bool = False,
                    do_lowlight: bool = False,
                    do_compression: bool = False) -> torch.Tensor:
    if do_compression:
        clip = compression_cleanup(clip)
    if do_denoise:
        clip = denoise(clip)
    if do_lowlight:
        clip = low_light_boost(clip)
    return clip


def temporal_smooth(clip: torch.Tensor, blend: float = 0.3) -> torch.Tensor:
    """``out[0] = clip[0]``; ``out[i] = (1 - blend) clip[i] + blend
    flow_warp(out[i-1], flow)``, the flow from ``clip[i]`` to ``out[i-1]``;
    fp32 ``(T, H, W, 3)`` on any device."""
    out = [clip[0]]
    for frame in clip[1:]:
        flow = estimate_flow_farneback(out[-1], frame)
        out.append((1 - blend) * frame + blend * flow_warp(out[-1], flow))
    return torch.stack(out)
