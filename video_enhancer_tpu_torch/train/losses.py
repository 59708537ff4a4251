"""Restoration losses: the counterpart of video_enhancer_tpu/train/
losses.py. Clips are ``(B, T, H, W, C)``; frames ``(B, H, W, C)``."""

from __future__ import annotations

import torch

__all__ = ["charbonnier_loss", "temporal_loss", "vsr_loss"]


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """Robust L1 (the standard VSR objective), in fp32."""
    diff = pred.float() - target.float()
    return torch.mean(torch.sqrt(diff * diff + eps * eps))


def temporal_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Match the temporal differences over the T axis of (B, T, H, W, C)."""
    dp = pred[:, 1:] - pred[:, :-1]
    dt = target[:, 1:] - target[:, :-1]
    return charbonnier_loss(dp, dt)


def vsr_loss(pred: torch.Tensor, target: torch.Tensor,
             temporal_weight: float = 0.25) -> torch.Tensor:
    """Charbonnier, plus ``temporal_weight`` times the temporal loss for a
    clip of more than one frame."""
    loss = charbonnier_loss(pred, target)
    if pred.ndim == 5 and pred.shape[1] > 1:
        loss = loss + temporal_weight * temporal_loss(pred, target)
    return loss
