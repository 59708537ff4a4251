"""Separable resize as two matrix products, and the nearest gather.

Counterpart of video_enhancer_tpu/ops/resize.py: ``method="cubic"`` (the
VSR models' base), ``"linear"`` (fast_mamba_vsr's multi-scale branch,
RIFE's pyramid), ``"lanczos"`` (the windowed sinc of 4 taps a side),
``"area"`` (the box over each output pixel's source span) and
``"nearest"`` (RRDBNet's upsampling): the same explicit ``(out, in)``
interpolation matrices (Keys cubic, a = -0.75, the triangle or Lanczos4;
half-pixel centers, replicated borders), so the borders match the JAX
package and not ``F.interpolate``; nearest gathers source ``floor((i +
0.5) in / out)``, clipped (:129-136). As there, bf16 input meets
bf16-rounded matrices with fp32 sums, other input is resized in fp32, and
integer input is rounded and clipped to its range (:140-158).
``resize_video`` is ``resize`` of a ``(T, H, W, C)`` or ``(B, T, H, W,
C)`` clip.

``image_resize`` is ``jax.image.resize(..., "linear")``, which the JAX
package's RIFE handler calls directly: its taps that fall outside the image
are dropped and the rest renormalised (no replicated border), and a
downsample widens the triangle by the scale (antialias, its default).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["interp_matrix", "resize", "resize_video", "image_resize",
           "resize_area"]


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


def _lanczos_kernel(x: np.ndarray, taps: int = 4) -> np.ndarray:
    """The windowed sinc ``sinc(x) sinc(x / taps)`` on ``|x| < taps``."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.abs(x) < taps, np.sinc(x) * np.sinc(x / taps), 0.0)


# method -> (kernel, support)
_KERNELS = {"cubic": (_cubic_kernel, 2), "linear": (_linear_kernel, 1),
            "lanczos": (_lanczos_kernel, 4)}


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Each output the mean of the source pixels its span covers, each
    weighted by the length it covers."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), in_size)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                w[i, j] = cover
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def interp_matrix(in_size: int, out_size: int, antialias: bool = True,
                  method: str = "cubic") -> np.ndarray:
    """The ``(out_size, in_size)`` operator of ``method`` (cubic, linear,
    lanczos or area; float32). When downscaling with ``antialias`` the
    kernel's support widens by the scale (area ignores it)."""
    if method == "area":
        return _area_matrix(in_size, out_size)
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
    ms each (24 a RIFE pair at 720x1280, 2.8 ms of its 8.4 device ms).
    Made outside inference mode, so that a train step can save the matrix
    that a served call cached for its backward."""
    with torch.inference_mode(False):
        m = torch.from_numpy(build(*key)).to(device)
        return m.bfloat16().float() if bf16 else m


def _separable(img: torch.Tensor, build, hkey: tuple,
               wkey: tuple) -> torch.Tensor:
    """``wh (out, H) @ img @ ww^T`` with ``wh = build(*hkey)``, ``ww =
    build(*wkey)``; bf16 input meets bf16-rounded matrices, both products
    accumulate in fp32, the output takes the input's dtype (integer input
    rounded and clipped to its range)."""
    bf16 = img.dtype == torch.bfloat16
    wh = _on_device(build, *hkey, device=img.device, bf16=bf16)
    ww = _on_device(build, *wkey, device=img.device, bf16=bf16)
    x = torch.einsum("oh,...hwc->...owc", wh, img.float())
    x = torch.einsum("ow,...hwc->...hoc", ww, x)
    if not (img.is_floating_point() or img.is_complex()):
        info = torch.iinfo(img.dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(img.dtype)


def resize(img: torch.Tensor, out_hw: tuple[int, int],
           antialias: bool = True, method: str = "cubic") -> torch.Tensor:
    """Resize ``(..., H, W, C)`` to ``out_hw`` (``method`` cubic, linear,
    lanczos, area or nearest); output dtype follows the input. As in the
    JAX package, bf16 input meets bf16-rounded matrices and both products
    accumulate in fp32."""
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


def resize_video(video: torch.Tensor, out_hw: tuple[int, int],
                 method: str = "cubic", antialias: bool = True
                 ) -> torch.Tensor:
    """Resize a ``(T, H, W, C)`` or ``(B, T, H, W, C)`` clip (the JAX
    package's ``resize_video``, ops/resize.py:161-168)."""
    return resize(video, out_hw, antialias=antialias, method=method)


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


@functools.lru_cache(maxsize=64)
def _area_taps(n_in: int, n_out: int, scale: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` along one axis: for each output,
    its source indices and fp32 weights in cv2's order, padded with weight
    0 to the longest list; ``(n_out, taps)`` int64 and float32."""
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(r) for r in taps)
    idx = np.zeros((n_out, width), np.int64)
    wts = np.zeros((n_out, width), np.float32)
    for d, row in enumerate(taps):
        for t, (s, a) in enumerate(row):
            idx[d, t], wts[d, t] = s, np.float32(a)
    return idx, wts


@functools.lru_cache(maxsize=64)
def _area_linear_coeffs(n_in: int, n_out: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The area coefficients of cv2's linear route along one axis: source
    ``floor(d * scale)`` and its fixed-point weights ``(1 - f, f)`` times
    2048, rounded; the neighbour clamped to the last index."""
    inv = n_out / n_in
    scale = 1.0 / inv
    src = np.zeros(n_out, np.int64)
    wts = np.zeros((n_out, 2), np.int64)
    for d in range(n_out):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
        if s >= n_in - 1:
            f, s = np.float32(0.0), n_in - 1
        src[d] = s
        wts[d] = np.rint(np.float32([np.float32(1.0) - f, f])
                         * np.float32(2048))
    return src, wts


@functools.lru_cache(maxsize=64)
def _area_tables(kind: str, n_in: int, n_out: int, scale: float,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """One axis's tables on ``device``, made once (a copy to the card a
    call would cost a sync each): "area" -> source indices ``(taps,
    n_out)`` and fp32 weights ``(taps, n_out)``; "linear" -> sources, their
    clamped neighbours and int64 weights ``(2, n_out)``."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if kind == "area":
        idx, wts = _area_taps(n_in, n_out, scale)
        return put(idx.T), put(wts.T)
    src, wts = _area_linear_coeffs(n_in, n_out)
    return put(src), put(np.minimum(src + 1, n_in - 1)), put(wts.T)


def _area_sum(x: torch.Tensor, dim: int, idx: torch.Tensor,
              wts: torch.Tensor) -> torch.Tensor:
    """fp32 sum over the taps in order along ``dim`` of ``x`` (fp32)."""
    shape = [1] * x.ndim
    shape[dim] = -1
    out = None
    for i, w in zip(idx, wts):
        term = x.index_select(dim, i) * w.view(shape)
        out = term if out is None else out + term
    return out


def resize_area(frame_u8: torch.Tensor, out_hw: tuple[int, int]
                ) -> torch.Tensor:
    """``cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)`` of a
    uint8 ``(H, W, C)`` frame on its device, bit for bit."""
    h_in, w_in = frame_u8.shape[:2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return frame_u8.clone()
    dev = frame_u8.device
    sx, sy = 1.0 / (w_out / w_in), 1.0 / (h_out / h_in)
    if sx >= 1 and sy >= 1:
        ix, iy = round(sx), round(sy)
        if abs(sx - ix) < 2.220446049250313e-16 and \
                abs(sy - iy) < 2.220446049250313e-16:
            x = frame_u8.int().reshape(h_out, iy, w_out, ix, -1)
            s = x.sum((1, 3))
            if ix == iy == 2:
                return ((s + 2) >> 2).to(torch.uint8)
            y = s.float() * float(np.float32(1.0) / np.float32(ix * iy))
            return torch.round(y).clamp(0, 255).to(torch.uint8)
        x = _area_sum(frame_u8.float(), 1,
                      *_area_tables("area", w_in, w_out, sx, dev))
        y = _area_sum(x, 0, *_area_tables("area", h_in, h_out, sy, dev))
        return torch.round(y).clamp(0, 255).to(torch.uint8)
    c0, c1, a = _area_tables("linear", w_in, w_out, sx, dev)
    r0, r1, b = _area_tables("linear", h_in, h_out, sy, dev)
    x = frame_u8.int()
    hz = (x.index_select(1, c0) * a[0, :, None]
          + x.index_select(1, c1) * a[1, :, None])      # (H, w_out, C)
    b = b[:, :, None, None]
    t = (((hz.index_select(0, r0) >> 4) * b[0]) >> 16) \
        + (((hz.index_select(0, r1) >> 4) * b[1]) >> 16)
    return ((t + 2) >> 2).clamp(0, 255).to(torch.uint8)
