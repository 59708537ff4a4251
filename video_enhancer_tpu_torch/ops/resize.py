"""Separable resize as two matrix products.

Counterpart of video_enhancer_tpu/ops/resize.py with ``method="cubic"`` (the
VSR models' base) and ``method="linear"`` (fast_mamba_vsr's multi-scale
branch): the same explicit ``(out, in)`` interpolation matrices (Keys
cubic, a = -0.75, or the triangle; half-pixel centers, replicated borders,
OpenCV's INTER_CUBIC and INTER_LINEAR), so the borders match the JAX
package and not ``F.interpolate``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp_matrix", "resize"]


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# method -> (kernel, support)
_KERNELS = {"cubic": (_cubic_kernel, 2), "linear": (_linear_kernel, 1)}


@functools.lru_cache(maxsize=64)
def interp_matrix(in_size: int, out_size: int, antialias: bool = True,
                  method: str = "cubic") -> np.ndarray:
    """The ``(out_size, in_size)`` cubic or linear operator (float32). When
    downscaling with ``antialias`` the support widens by the scale."""
    kernel, support = _KERNELS[method]
    scale = in_size / out_size
    widen = max(scale, 1.0) if antialias else 1.0
    eff_support = support * widen
    i = np.arange(out_size, dtype=np.float64)
    x = (i + 0.5) * scale - 0.5
    j0 = np.floor(x - eff_support).astype(np.int64) + 1
    ntaps = int(np.ceil(2 * eff_support)) + 1
    taps = j0[:, None] + np.arange(ntaps)[None, :]
    wts = kernel((x[:, None] - taps) / widen) / widen
    w = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(w, (np.repeat(i.astype(np.int64), ntaps),
                  np.clip(taps, 0, in_size - 1).ravel()), wts.ravel())
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize(img: torch.Tensor, out_hw: tuple[int, int],
           antialias: bool = True, method: str = "cubic") -> torch.Tensor:
    """Resize ``(..., H, W, C)`` to ``out_hw`` (``method`` cubic or linear);
    output dtype follows the input. As in the JAX package, bf16 input meets
    bf16-rounded matrices and both products accumulate in fp32."""
    h_in, w_in = img.shape[-3], img.shape[-2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    wh = torch.from_numpy(interp_matrix(h_in, h_out, antialias, method))
    ww = torch.from_numpy(interp_matrix(w_in, w_out, antialias, method))
    wh, ww = wh.to(img.device), ww.to(img.device)
    if img.dtype == torch.bfloat16:
        wh, ww = wh.bfloat16().float(), ww.bfloat16().float()
    x = torch.einsum("oh,...hwc->...owc", wh, img.float())
    x = torch.einsum("ow,...hwc->...hoc", ww, x)
    return x.to(img.dtype)
