"""Degradation scoring: the router's analysis of a clip, on the frames'
device.

Counterpart of video_enhancer_tpu/ops/degradation.py: five degradation
scores and four content statistics of a ``(T, H, W, 3)`` float32 RGB clip
in [0, 1], each a 0-d float32 tensor. The stencils (the VALID Laplacian,
the SAME 5x5 Gaussian with zero padding) are written as sums of shifted
slices, so they are exact fp32 on any device (no TF32 convolution); every
variance and standard deviation is the population form (ddof 0), as in
``jnp.var`` and ``jnp.std``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["degradation_scores", "compression_score", "blur_score",
           "low_light_score", "noise_score", "temporal_score"]


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma, (T, H, W)."""
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


@functools.lru_cache(maxsize=1)
def _dct8_matrix() -> np.ndarray:
    k = np.arange(8)
    n = np.arange(8)
    d = np.cos(np.pi * (2 * n[None, :] + 1) * k[:, None] / 16.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * 0.5).astype(np.float32)


def _block_dct8(y: torch.Tensor) -> torch.Tensor:
    """(T, H, W) -> (T, H/8, W/8, 8, 8) DCT coefficients per 8x8 block."""
    t, h, w = y.shape
    h8, w8 = h // 8, w // 8
    y = y[:, :h8 * 8, :w8 * 8]
    blocks = y.reshape(t, h8, 8, w8, 8).permute(0, 1, 3, 2, 4)
    d = torch.from_numpy(_dct8_matrix()).to(y.device)
    return torch.einsum("ij,thwjk,lk->thwil", d, blocks, d)


def compression_score(frames: torch.Tensor) -> torch.Tensor:
    """Deficit of high-frequency DCT energy in 8x8 blocks."""
    coef = _block_dct8(_luma(frames))
    i = torch.arange(8, device=frames.device)
    hf_mask = ((i[:, None] + i[None, :]) >= 8).float()
    energy = coef * coef
    hf = (energy * hf_mask).sum(dim=(-1, -2))
    tot = energy.sum(dim=(-1, -2)) + 1e-8
    return torch.clamp(1.0 - (hf / tot).mean() / 0.08, 0.0, 1.0)


def blur_score(frames: torch.Tensor) -> torch.Tensor:
    """Motion blur from the variance of the (VALID) Laplacian: low variance
    means blurry."""
    y = _luma(frames)
    lap = (y[:, :-2, 1:-1] + y[:, 2:, 1:-1] + y[:, 1:-1, :-2]
           + y[:, 1:-1, 2:] - 4.0 * y[:, 1:-1, 1:-1])
    var = (lap * 255.0).var(dim=(1, 2), correction=0)
    return torch.clamp(1.0 - var.mean() / 500.0, 0.0, 1.0)


def low_light_score(frames: torch.Tensor) -> torch.Tensor:
    """Brightness and the share of dark pixels."""
    y = _luma(frames)
    brightness = y.mean()
    dark_ratio = (y < 0.2).float().mean()
    s = (0.6 * torch.clamp(1.0 - brightness / 0.45, 0.0, 1.0)
         + 0.4 * dark_ratio)
    return torch.clamp(s, 0.0, 1.0)


def _gauss5(y: torch.Tensor) -> torch.Tensor:
    """SAME 5x5 binomial blur of (T, H, W) with zero padding, as one sum
    over the 25 taps of the outer-product kernel."""
    g = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    k = np.outer(g, g)
    h, w = y.shape[1], y.shape[2]
    yp = F.pad(y, (2, 2, 2, 2))
    out = torch.zeros_like(y)
    for i in range(5):
        for j in range(5):
            out = out + float(k[i, j]) * yp[:, i:i + h, j:j + w]
    return out


def noise_score(frames: torch.Tensor) -> torch.Tensor:
    """Standard deviation of the residual against a Gaussian blur."""
    y = _luma(frames)
    sigma = ((y - _gauss5(y)) * 255.0).std(correction=0)
    return torch.clamp(sigma / 12.0, 0.0, 1.0)


def temporal_score(frames: torch.Tensor) -> torch.Tensor:
    """Temporal inconsistency: mean absolute frame difference."""
    if frames.shape[0] < 2:
        return frames.new_zeros(())
    diff = (frames[1:] - frames[:-1]).abs().mean()
    return torch.clamp(diff / 0.12, 0.0, 1.0)


def _scene_change_ratio(frames: torch.Tensor) -> torch.Tensor:
    """Share of consecutive frames whose 32-bin luma histograms correlate
    below 0.7. Bins are [lo, hi), so 1.0 falls in none, as in the JAX
    package."""
    if frames.shape[0] < 2:
        return frames.new_zeros(())
    y = _luma(frames)
    edges = torch.linspace(0.0, 1.0, 33, device=frames.device)
    lo, hi = edges[:-1], edges[1:]
    flat = y.reshape(y.shape[0], -1, 1)
    hist = ((flat >= lo) & (flat < hi)).float().mean(dim=1)    # (T, 32)
    hist = hist - hist.mean(dim=-1, keepdim=True)
    num = (hist[1:] * hist[:-1]).sum(-1)
    den = torch.sqrt((hist[1:] ** 2).sum(-1)
                     * (hist[:-1] ** 2).sum(-1)) + 1e-8
    return ((num / den) < 0.7).float().mean()


def degradation_scores(frames: torch.Tensor) -> dict[str, torch.Tensor]:
    """All degradation and content scores of a (T, H, W, 3) clip."""
    y = _luma(frames)
    temporal = temporal_score(frames)
    return {
        "compression": compression_score(frames),
        "motion_blur": blur_score(frames),
        "low_light": low_light_score(frames),
        "noise": noise_score(frames),
        "temporal_inconsistency": temporal,
        "scene_change_ratio": _scene_change_ratio(frames),
        "motion_complexity": torch.clamp(temporal * 1.4, 0.0, 1.0),
        "brightness": y.mean(),
        "contrast": y.std(correction=0),
    }
