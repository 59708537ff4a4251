"""Quality metrics on the caller's device: PSNR, SSIM and temporal
consistency.

Counterpart of video_enhancer_tpu/utils/metrics.py, in torch ops on the
inputs' device. SSIM takes the Wang et al. settings (an 11-tap Gaussian of
sigma 1.5 applied separably over H, then W, 'valid'; K1 = 0.01, K2 = 0.03)
over an image ``(H, W, C)`` or a clip ``(T, H, W, C)`` (the mean of the
frames' SSIMs). Inputs are taken in fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "temporal_consistency", "evaluate_pair"]


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB over every element."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


@functools.lru_cache(maxsize=8)
def _gauss_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' Gaussian over (H, W) of ``(N, C, H, W)``."""
    c = img.shape[1]
    out = F.conv2d(img, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(out, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an image ``(H, W, C)`` or a clip ``(T, H, W, C)``."""
    x = a.float().reshape(-1, *a.shape[-3:]).permute(0, 3, 1, 2)
    y = b.float().reshape(-1, *b.shape[-3:]).permute(0, 3, 1, 2)
    k = torch.from_numpy(_gauss_kernel()).to(x.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = _filter2(x, k), _filter2(y, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _filter2(x * x, k) - mu_aa
    var_b = _filter2(y * y, k) - mu_bb
    cov = _filter2(x * y, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return torch.mean((num / den).flatten(1).mean(1))


def temporal_consistency(clip: torch.Tensor) -> torch.Tensor:
    """1 - the mean absolute difference of consecutive frames."""
    clip = clip.float()
    return 1.0 - torch.mean(torch.abs(clip[1:] - clip[:-1]))


@torch.inference_mode()
def evaluate_pair(out_clip: torch.Tensor, ref_clip: torch.Tensor) -> dict:
    """PSNR and SSIM of ``out_clip`` against ``ref_clip`` and the temporal
    consistency of ``out_clip``: 0-d tensors on the clips' device."""
    return {"psnr": psnr(out_clip, ref_clip),
            "ssim": ssim(out_clip, ref_clip),
            "temporal_consistency": temporal_consistency(out_clip)}
