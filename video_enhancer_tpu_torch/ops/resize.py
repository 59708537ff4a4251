"""Separable resize as two matrix products, and the nearest gather.

Counterpart of video_enhancer_tpu/ops/resize.py with ``method="cubic"`` (the
VSR models' base), ``method="linear"`` (fast_mamba_vsr's multi-scale
branch, RIFE's pyramid) and ``method="nearest"`` (RRDBNet's upsampling):
the same explicit ``(out, in)`` interpolation matrices (Keys cubic, a =
-0.75, or the triangle; half-pixel centers, replicated borders, OpenCV's
INTER_CUBIC and INTER_LINEAR), so the borders match the JAX package and not
``F.interpolate``; nearest gathers source ``floor((i + 0.5) in / out)``,
clipped (:129-136).

``image_resize`` is ``jax.image.resize(..., "linear")``, which the JAX
package's RIFE handler calls directly: its taps that fall outside the image
are dropped and the rest renormalised (no replicated border), and a
downsample widens the triangle by the scale (antialias, its default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp_matrix", "resize", "image_resize"]


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


def _nearest_index(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    idx = ((np.arange(out_size) + 0.5) * in_size / out_size).astype(np.int64)
    return torch.from_numpy(np.clip(idx, 0, in_size - 1)).to(device)


@functools.lru_cache(maxsize=128)
def _on_device(build, *key, device: torch.device,
               bf16: bool) -> torch.Tensor:
    """``build(*key)`` as an fp32 tensor on ``device`` (its values rounded to
    bf16 when ``bf16``), made once: a host-to-device copy a call cost ~0.1
    ms each (24 a RIFE pair at 720x1280, 2.8 ms of its 8.4 device ms)."""
    m = torch.from_numpy(build(*key)).to(device)
    return m.bfloat16().float() if bf16 else m


def _separable(img: torch.Tensor, build, hkey: tuple,
               wkey: tuple) -> torch.Tensor:
    """``wh (out, H) @ img @ ww^T`` with ``wh = build(*hkey)``, ``ww =
    build(*wkey)``; bf16 input meets bf16-rounded matrices, both products
    accumulate in fp32, the output takes the input's dtype."""
    bf16 = img.dtype == torch.bfloat16
    wh = _on_device(build, *hkey, device=img.device, bf16=bf16)
    ww = _on_device(build, *wkey, device=img.device, bf16=bf16)
    x = torch.einsum("oh,...hwc->...owc", wh, img.float())
    x = torch.einsum("ow,...hwc->...hoc", ww, x)
    return x.to(img.dtype)


def resize(img: torch.Tensor, out_hw: tuple[int, int],
           antialias: bool = True, method: str = "cubic") -> torch.Tensor:
    """Resize ``(..., H, W, C)`` to ``out_hw`` (``method`` cubic, linear or
    nearest); output dtype follows the input. As in the JAX package, bf16
    input meets bf16-rounded matrices and both products accumulate in
    fp32."""
    h_in, w_in = img.shape[-3], img.shape[-2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    if method == "nearest":
        rows = _nearest_index(h_in, h_out, img.device)
        cols = _nearest_index(w_in, w_out, img.device)
        return img.index_select(-3, rows).index_select(-2, cols)
    return _separable(img, interp_matrix, (h_in, h_out, antialias, method),
                      (w_in, w_out, antialias, method))


@functools.lru_cache(maxsize=64)
def _jax_linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The ``(out, in)`` weights of ``jax.image.resize``'s linear method
    (jax/_src/image/scale.py ``compute_weight_mat``): the triangle over
    half-pixel centres, widened by the scale on a downsample, taps outside
    the image dropped and each row renormalised."""
    inv_scale = in_size / out_size
    widen = max(inv_scale, 1.0)
    x = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _linear_kernel((x[:, None] - np.arange(in_size)[None, :]) / widen)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def image_resize(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, (..., *out_hw, C), "linear")`` of ``(..., H,
    W, C)`` in fp32, whatever the input's dtype."""
    h_in, w_in = img.shape[-3], img.shape[-2]
    return _separable(img.float(), _jax_linear_matrix, (h_in, out_hw[0]),
                      (w_in, out_hw[1]))
