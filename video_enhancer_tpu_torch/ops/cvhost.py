"""OpenCV's image ops on host float32 arrays, in numpy.

The eval data of the JAX package (train/data.py, train/evalgen.py,
train/lpips.py) is made on the host with cv2; these are its counterparts
for a machine without OpenCV. Each follows what cv2 5 (x86-64, AVX-512
dispatch) computes, down to its rounding where that was found:

- ``gaussian_kernel``: ``cv2.getGaussianKernel(n, sigma, CV_32F)`` for
  sigma > 0, the taps in double, normalised in double, then rounded to
  float32.
- ``gaussian_blur`` / ``filter2d``: ``cv2.GaussianBlur(f, (k, k), sigma)``
  and ``cv2.filter2D(f, -1, k)`` with ``BORDER_REFLECT_101``. OpenCV's
  filter engine runs 16 float lanes with fused multiply-adds over each
  row's ``W * C`` values and plain float arithmetic on the tail past the
  last whole vector; both are reproduced (a fused multiply-add as a
  double product and sum rounded once). filter2D sums the non-zero taps in
  row-major order; the separable blur's row pass runs taps in order, its
  column pass (and a 5-tap row pass) the symmetric pairs outward from the
  centre. Equal to cv2 at 7 and 9 taps and for filter2D; at 5 taps (a row
  form not identified) within three float32 ulps.
- ``line``: ``cv2.line(img, p0, p1, value, 1)``, OpenCV's 8-connected
  ``LineIterator`` walked left to right. Exact.
- ``resize``: ``cv2.resize`` of float32 images. A size equal to the
  input's is a copy. ``INTER_NEAREST`` takes ``floor(x * sw / dw)``;
  ``INTER_AREA`` at integer factors sums each block in groups of four
  (halving 1 or 4 channels: two pairs) and scales by ``1 / area`` in
  float32 (exact), at other factors (downscale
  only) weighs the covered cells; ``INTER_LINEAR`` (the default) and
  ``INTER_CUBIC`` (A = -0.75, indices clamped) place each output at
  ``(d + 0.5) * sw / dw - 0.5`` in double, with the weights in float32.
  Linear within one ulp, cubic and area within three.
- ``rotation_matrix_2d``, ``warp_affine`` and ``remap`` with
  ``INTER_LINEAR`` and ``BORDER_REFLECT``: cv2 5's warp kernels invert the
  affine matrix in double, take it in float32, place each output pixel at
  ``fma(M0, x, M1 * y + M2)`` and blend by fused lerps
  ``fma(a, v1 - v0, v0)`` across, then down; remap reads its float maps
  the same way. Exact, at widths a multiple of 16 for warp_affine (the
  last ``w mod 16`` columns of a row take another path in cv2, within
  5e-6 here).
"""

from __future__ import annotations

import numpy as np

__all__ = ["INTER_NEAREST", "INTER_LINEAR", "INTER_CUBIC", "INTER_AREA",
           "gaussian_kernel", "gaussian_blur", "filter2d", "line", "resize",
           "rotation_matrix_2d", "warp_affine", "remap"]

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA = 0, 1, 2, 3

_LANES = 16          # float32 lanes of OpenCV's AVX-512 filter loops
_f32, _f64 = np.float32, np.float64


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in double)."""
    return (np.asarray(a, _f64) * np.asarray(b, _f64)
            + np.asarray(c, _f64)).astype(_f32)


def _reflect101(n: int, idx: np.ndarray) -> np.ndarray:
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def _reflect(n: int, idx: np.ndarray) -> np.ndarray:
    """BORDER_REFLECT: ``fedcba|abcdef|fedcba``."""
    idx = np.mod(idx, 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def _as3(img: np.ndarray) -> tuple[np.ndarray, bool]:
    img = np.asarray(img, _f32)
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _tail_merge(vec: np.ndarray, plain: np.ndarray) -> np.ndarray:
    """Rows of ``W * C`` values: the vector loop's result up to the last
    whole 16-lane vector, the scalar loop's after it."""
    h, w, c = vec.shape
    v = (w * c) // _LANES * _LANES
    out = vec.reshape(h, w * c).copy()
    out[:, v:] = plain.reshape(h, w * c)[:, v:]
    return out.reshape(h, w, c)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t / t.sum()).astype(_f32)


def _row_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    n = len(k)
    r = n // 2
    pad = img[:, _reflect101(w, np.arange(-r, w + r))]
    taps = [pad[:, j:j + w] for j in range(n)]
    if n <= 5:                        # the symmetric small-kernel form
        vec = taps[r] * k[r]
        plain = k[r] * taps[r]
        for j in range(1, r + 1):
            pair = taps[r + j] + taps[r - j]
            vec = _fma(pair, k[r + j], vec)
            plain = plain + k[r + j] * pair
        return _tail_merge(vec, plain)
    vec = np.zeros_like(img)
    plain = np.zeros_like(img)
    for j in range(n):
        vec = _fma(taps[j], k[j], vec)
        plain = plain + taps[j] * k[j]
    return _tail_merge(vec, plain)


def _col_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    h = img.shape[0]
    r = len(k) // 2
    pad = img[_reflect101(h, np.arange(-r, h + r))]

    def row(j):
        return pad[r + j:r + j + h]

    vec = row(0) * k[r]
    plain = k[r] * row(0)
    for j in range(1, r + 1):
        pair = row(j) + row(-j)
        vec = _fma(pair, k[r + j], vec)
        plain = plain + k[r + j] * pair
    return _tail_merge(vec, plain)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    x, flat = _as3(img)
    k = gaussian_kernel(ksize, sigma)
    out = _col_pass(_row_pass(x, k), k)
    return out[..., 0] if flat else out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Correlation with ``kernel`` (odd sizes), anchor at its centre."""
    x, flat = _as3(img)
    k = np.asarray(kernel, _f32)
    kh, kw = k.shape
    h, w, _ = x.shape
    ry, rx = kh // 2, kw // 2
    pad = x[_reflect101(h, np.arange(-ry, h + ry))][
        :, _reflect101(w, np.arange(-rx, w + rx))]
    vec = np.zeros_like(x)
    plain = np.zeros_like(x)
    for (i, j) in zip(*np.nonzero(k)):
        tap = pad[i:i + h, j:j + w]
        vec = _fma(tap, k[i, j], vec)
        plain = plain + k[i, j] * tap
    out = _tail_merge(vec, plain)
    return out[..., 0] if flat else out


def line(img: np.ndarray, p0: tuple[int, int], p1: tuple[int, int],
         value) -> np.ndarray:
    """Draws an 8-connected one-pixel line from ``p0`` to ``p1`` ((x, y),
    both inside the image) in place, and returns the image."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (p0, p1))
    if not all(0 <= x < w and 0 <= y < h for x, y in ((x0, y0), (x1, y1))):
        raise ValueError("line: both end points must lie inside the image")
    if x1 < x0:                       # walked left to right
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = value
        if err < 0:                   # a diagonal step
            err += 2 * dx - 2 * dy
            x, y = x + 1, y + sy
        else:                         # a step along the major axis
            err -= 2 * dy
            if steep:
                y += sy
            else:
                x += 1
    return img


def _cubic_weights(fx: np.ndarray) -> np.ndarray:
    a = -0.75
    c0 = ((a * (fx + 1) - 5 * a) * (fx + 1) + 8 * a) * (fx + 1) - 4 * a
    c1 = ((a + 2) * fx - (a + 3)) * fx * fx + 1
    c2 = ((a + 2) * (1 - fx) - (a + 3)) * (1 - fx) * (1 - fx) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(_f32)


def _interp_taps(n_in: int, n_out: int, cubic: bool):
    """Source indices ``(n_out, taps)`` and float32 weights."""
    fxd = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fxd).astype(np.int64)
    fx = fxd - sx
    if cubic:
        idx = np.clip(sx[:, None] + np.arange(-1, 3), 0, n_in - 1)
        return idx, _cubic_weights(fx)
    fx = fx.astype(_f32)
    lo, hi = sx < 0, sx >= n_in - 1
    fx[lo | hi] = 0
    sx = np.clip(sx, 0, n_in - 1)
    idx = np.stack([sx, np.minimum(sx + 1, n_in - 1)], -1)
    return idx, np.stack([_f32(1) - fx, fx], -1)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` cell coverage of OpenCV's area downscale."""
    scale = n_in / n_out
    wt = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        s1 = int(np.ceil(f1))
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(s1, s2)
        cell = min(scale, n_in - f1)
        if s1 - f1 > 1e-3:
            wt[d, s1 - 1] = (s1 - f1) / cell
        wt[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            wt[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return wt


def _separable(x: np.ndarray, taps_x, taps_y) -> np.ndarray:
    def one(src, idx, wts, axis):
        acc = 0.0
        shape = [1] * src.ndim
        shape[axis] = -1
        for k in range(idx.shape[1]):
            acc = acc + (np.take(src, idx[:, k], axis=axis).astype(_f64)
                         * wts[:, k].reshape(shape).astype(_f64))
        return acc.astype(_f32)

    return one(one(x, *taps_x, 1), *taps_y, 0)


def resize(img: np.ndarray, dsize: tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize=(w, h), interpolation=...)`` of a float32
    ``(H, W)`` or ``(H, W, C)`` image."""
    x, flat = _as3(img)
    h, w = x.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    if (oh, ow) == (h, w):
        out = x.copy()
    elif interpolation == INTER_NEAREST:
        xi = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
        yi = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
        out = x[yi.astype(np.int64)][:, xi.astype(np.int64)]
    elif interpolation == INTER_AREA:
        if ow > w or oh > h:
            raise NotImplementedError("resize: INTER_AREA upscaling")
        if w % ow == 0 and h % oh == 0:
            sx, sy = w // ow, h // oh
            blocks = x.reshape(oh, sy, ow, sx, -1)
            cells = [blocks[:, i, :, j] for i in range(sy) for j in range(sx)]
            acc = np.zeros_like(cells[0])
            k = 0
            if (sx, sy) == (2, 2) and x.shape[2] in (1, 4):
                # the vector form of 1- and 4-channel halving
                acc = (cells[0] + cells[1]) + (cells[2] + cells[3])
                k = 4
            while k + 4 <= len(cells):
                acc = acc + (((cells[k] + cells[k + 1]) + cells[k + 2])
                             + cells[k + 3])
                k += 4
            for c in cells[k:]:
                acc = acc + c
            out = acc * _f32(1.0 / (sx * sy))
        else:
            wx, wy = _area_weights(w, ow), _area_weights(h, oh)
            out = np.einsum("yh,hxc->yxc", wy,
                            np.einsum("xw,hwc->hxc", wx,
                                      x.astype(_f64))).astype(_f32)
    elif interpolation in (INTER_LINEAR, INTER_CUBIC):
        cubic = interpolation == INTER_CUBIC
        out = _separable(x, _interp_taps(w, ow, cubic),
                         _interp_taps(h, oh, cubic))
    else:
        raise ValueError(f"resize: unsupported interpolation {interpolation}")
    return out[..., 0] if flat else out


def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in double."""
    m = np.asarray(m, _f64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _bilinear_reflect(x: np.ndarray, sx: np.ndarray,
                      sy: np.ndarray) -> np.ndarray:
    """cv2 5's linear warp kernel at float32 source coordinates."""
    h, w = x.shape[:2]
    ix = np.floor(sx).astype(np.int64)
    iy = np.floor(sy).astype(np.int64)
    a = (sx - ix.astype(_f32)).astype(_f32)[..., None]
    b = (sy - iy.astype(_f32)).astype(_f32)[..., None]
    x0, x1 = _reflect(w, ix), _reflect(w, ix + 1)
    y0, y1 = _reflect(h, iy), _reflect(h, iy + 1)
    v00, v01 = x[y0, x0], x[y0, x1]
    v10, v11 = x[y1, x0], x[y1, x1]
    top = _fma(a, v01 - v00, v00)
    bot = _fma(a, v11 - v10, v10)
    return _fma(b, bot - top, top)


def warp_affine(img: np.ndarray, m: np.ndarray,
                dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT)``."""
    x, flat = _as3(img)
    mi = _invert_affine(m).astype(_f32)
    ow, oh = int(dsize[0]), int(dsize[1])
    ys, xs = np.mgrid[0:oh, 0:ow].astype(_f32)
    sx = _fma(mi[0, 0], xs, mi[0, 1] * ys + mi[0, 2])
    sy = _fma(mi[1, 0], xs, mi[1, 1] * ys + mi[1, 2])
    out = _bilinear_reflect(x, sx, sy)
    return out[..., 0] if flat else out


def remap(img: np.ndarray, map_x: np.ndarray,
          map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR,
    borderMode=BORDER_REFLECT)`` with float32 maps."""
    x, flat = _as3(img)
    out = _bilinear_reflect(x, np.asarray(map_x, _f32),
                            np.asarray(map_y, _f32))
    return out[..., 0] if flat else out
