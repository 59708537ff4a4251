"""Farneback dense optical flow with the parameters the temporal stage
serves, as torch ops on the images' device, without OpenCV.

Counterpart of ``cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15,
3, 5, 1.2, 0)`` (OpenCV's optflowgf.cpp), which
video_enhancer_tpu/runtime/experts.py:72-82 calls:

- the pyramid keeps the levels k < 3 at which both sides of the image
  times 0.5 ** (k + 1) are at least 32, coarsest first. At level k (scale
  s = 0.5 ** k) each image is the full-size gray in fp32, blurred by a
  Gaussian of sigma (1/s - 1)/2 and ``max(cvRound(5 sigma) | 1, 3)`` taps
  with reflect-101 borders (at level 0, sigma 0: cv2's fixed [1/4, 1/2,
  1/4]), then resized bilinearly (cv2's ``INTER_LINEAR``: source (d + 0.5)
  in/out - 0.5, clamped) to ``cvRound`` of its sides times s; the flow of
  the coarser level is resized to the finer one and doubled;
- each image's polynomial expansion (``poly_n`` 5, sigma 1.2): an 11-tap
  vertical pass and an 11-tap horizontal pass of the weights g, x g and
  x^2 g with replicate borders, giving the y, x, yy, xx and xy
  coefficients, scaled by the inverse of the 6x6 moment matrix;
- the matrices M from the flow (``_update_matrices``: the second image's
  coefficients sampled at x + flow where that lies inside, the border
  weights on the 5 outer rows and columns), and 3 times a 15x15 box mean
  of M with replicate borders and the 2x2 solve for the flow, M updated
  after every solve but the last.

Each 1-D linear pass (the pyramid's blur and resize as one product, both
passes of the expansion, the resize of the flow) is a product with a banded
matrix that holds the taps and the border rule, built in numpy for each
size and kept per device; the products run in fp64, their results are
stored in fp32 as OpenCV stores them. OpenCV 5.0 resizes one-channel
images with fp64 source coordinates and the flow's two channels with fp32
ones; both are followed. The update of the matrices is fp32 elementwise in
OpenCV's order of operations; the box mean (running sums) and the solve
are fp64, as in OpenCV. The flow agrees with cv2 5.0.0's within 1.4e-5 px
up to 720x1280 (tests/test_torch_optflow.py holds it to 1e-4 px), and on
the card with the CPU's (chip_smoke.py phase 12, 1e-4 px).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .color import rgb_to_gray

__all__ = ["farneback_flow", "estimate_flow_farneback", "gaussian_kernel",
           "gaussian_blur", "resize_linear", "poly_expansion",
           "pyramid_levels"]

PYR_SCALE = 0.5
LEVELS = 3
WINSIZE = 15
ITERATIONS = 3
POLY_N = 5
POLY_SIGMA = 1.2
MIN_SIZE = 32
# weights of the 5 outer rows and columns in the update of the matrices
_BORDER = np.float32([0.14, 0.14, 0.4472, 0.4472, 0.4472])
# the coefficients' weights where x + flow lies inside (the yy, xx, xy
# terms averaged with the first image's) and outside (linear terms zero)
_INSIDE = (0.5, 0.5, 0.25)
_OUTSIDE = (0.0, 0.0, 1.0, 1.0, 0.5)
# planes of (r2, r3, r4, r5, r6) whose products make M: M0, M2, M3, M4 =
# r4 r4 + r6 r6, r5 r5 + r6 r6, r4 r2 + r6 r3, r6 r2 + r5 r3
_M_TERMS = ((2, 3, 2, 4), (2, 3, 0, 0), (4, 4, 4, 3), (4, 4, 1, 1))
_CACHE = 64


def _cv_round(x: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(round(x))


def pyramid_levels(rows: int, cols: int) -> list[tuple[float, int, int, int]]:
    """``(sigma, ksize, rows, cols)`` of each level, coarsest first."""
    levels, scale = 0, 1.0
    while levels < LEVELS:
        scale *= PYR_SCALE
        if cols * scale < MIN_SIZE or rows * scale < MIN_SIZE:
            break
        levels += 1
    out = []
    for k in range(levels, -1, -1):
        scale = PYR_SCALE ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(_cv_round(sigma * 5) | 1, 3)
        out.append((sigma, ksize, _cv_round(rows * scale),
                    _cv_round(cols * scale)))
    return out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2's ``getGaussianKernel(ksize, sigma, CV_32F)``: the fixed
    [1/4, 1/2, 1/4] for 3 taps at sigma 0, else exp(-x^2 / 2 sigma^2)
    normalised in fp64, then stored in fp32."""
    if sigma <= 0 and ksize == 3:
        return np.float32([0.25, 0.5, 0.25])
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(1 - ksize, ksize, 2, dtype=np.float64)
    t = np.exp(x * x * (-0.125 / (sigma * sigma)))
    return (t * (1.0 / t.sum())).astype(np.float32)


def _blur_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """(n, n): a 1-D correlation with ``kernel``, reflect-101 borders."""
    r = len(kernel) // 2
    a = np.zeros((n, n))
    i = np.arange(n)
    for j, w in enumerate(kernel.astype(np.float64)):
        src = i + j - r
        if n > 1:
            period = 2 * (n - 1)
            src = np.abs(np.mod(src, period))
            src = np.where(src >= n, period - src, src)
        else:
            src = np.zeros_like(src)
        np.add.at(a, (i, src), w)
    return a


def _resize_matrix(n_in: int, n_out: int, fp32_coords: bool) -> np.ndarray:
    """(n_out, n_in): cv2's ``INTER_LINEAR`` along one axis: the source
    coordinate (in fp32 or fp64), clamped at both ends, and its two
    weights in fp32."""
    if n_in == n_out:
        return np.eye(n_in)
    fx = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if fp32_coords:
        fx = fx.astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(fx.dtype)
    fx[sx < 0], sx[sx < 0] = 0, 0
    high = sx >= n_in - 1
    fx[high], sx[high] = 0, n_in - 1
    a = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    np.add.at(a, (rows, sx), (1 - fx).astype(np.float32))
    np.add.at(a, (rows, np.minimum(sx + 1, n_in - 1)), fx.astype(np.float32))
    return a


@functools.lru_cache(maxsize=None)
def _poly_constants() -> tuple[np.ndarray, tuple[float, float, float, float]]:
    """The expansion's 1-D weights g, x g, x^2 g over x = -5..5 in fp32,
    and ig11, ig03, ig33, ig55 of the inverse moment matrix (fp64; its
    entries summed in fp64 from fp32 products, as OpenCV sums them)."""
    n, sigma = POLY_N, POLY_SIGMA
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    g = g.astype(np.float64)
    g = (g * (1.0 / g.sum())).astype(np.float32)
    xf = x.astype(np.float32)
    xg, xxg = xf * g, xf * xf * g
    gg = g[:, None] * g[None, :]                   # [y, x], fp32 products
    xx = np.broadcast_to(xf[None, :], gg.shape)
    yy = np.broadcast_to(xf[:, None], gg.shape)
    G = np.zeros((6, 6))
    G[0, 0] = gg.astype(np.float64).sum()
    G[1, 1] = (gg * xx * xx).astype(np.float64).sum()
    G[3, 3] = (gg * xx * xx * xx * xx).astype(np.float64).sum()
    G[5, 5] = (gg * xx * xx * yy * yy).astype(np.float64).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return (np.stack([g, xg, xxg]),
            (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]))


def _poly_matrix(n: int) -> np.ndarray:
    """(3n, n): the g, x g and x^2 g correlations, replicate borders."""
    w = _poly_constants()[0].astype(np.float64)
    a = np.zeros((3, n, n))
    i = np.arange(n)
    for j in range(2 * POLY_N + 1):
        src = np.clip(i + j - POLY_N, 0, n - 1)
        for c in range(3):
            np.add.at(a[c], (i, src), w[c, j])
    return a.reshape(3 * n, n)


@functools.lru_cache(maxsize=_CACHE)
def _matrix(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    if kind == "pyramid":                 # resize after blur, (n_out, n)
        n, n_out, ksize, sigma = args
        a = _resize_matrix(n, n_out, False) @ _blur_matrix(
            n, gaussian_kernel(ksize, sigma))
    elif kind == "blur":
        a = _blur_matrix(args[0], gaussian_kernel(args[1], args[2]))
    elif kind == "resize":
        a = _resize_matrix(*args)
    elif kind == "poly":
        a = _poly_matrix(*args)
    else:
        raise ValueError(kind)
    return torch.from_numpy(a).to(device)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> tuple:
    """``_INSIDE`` and ``_OUTSIDE`` as ``(C, 1, 1)`` fp32 and the index
    tensors of ``_M_TERMS``, on ``device``."""
    col = lambda v: torch.tensor(v, dtype=torch.float32,
                                 device=device).view(-1, 1, 1)
    return (col(_INSIDE), col(_OUTSIDE),
            [torch.tensor(t, device=device) for t in _M_TERMS])


@functools.lru_cache(maxsize=_CACHE)
def _level_constants(h: int, w: int, device: torch.device) -> tuple:
    """Per level size: the pixel coordinates ``(2, H, W)`` fp32 as (x, y),
    the bounds (W - 1, H - 1) that a bilinear cell's corner must lie below
    and the last corner a cell may take, the offsets of its four corners
    in a flat plane, and OpenCV's product of the border weights of the
    column and the row ``(H, W)`` fp32 (1 inside)."""
    def side(n):
        lo, hi = np.ones(n, np.float32), np.ones(n, np.float32)
        k = min(len(_BORDER), n)
        lo[:k] = _BORDER[:k]
        hi[n - k:] = _BORDER[:k][::-1]
        return lo, hi
    xl, xh = side(w)
    yl, yh = side(h)
    border = (xl * xh)[None, :] * yl[:, None] * yh[:, None]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ex, ey = int(w > 1), w * int(h > 1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(np.stack([xs, ys])),
            put(np.float32([w - 1, h - 1]).reshape(2, 1, 1)),
            put(np.float32([max(w - 2, 0), max(h - 2, 0)]).reshape(2, 1, 1)),
            put(np.int64([0, ex, ey, ey + ex]).reshape(4, 1, 1)),
            put(border))


def _separable(x: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """``rows @ x @ cols.T`` over the last two dims of ``x`` in fp64."""
    return rows @ x.double() @ cols.T


def gaussian_blur(img: torch.Tensor, ksize: int,
                  sigma: float) -> torch.Tensor:
    """cv2's ``GaussianBlur(img, (ksize, ksize), sigma)`` of ``(..., H, W)``
    fp32, reflect-101 borders."""
    h, w = img.shape[-2:]
    return _separable(img, _matrix("blur", (h, ksize, sigma), img.device),
                      _matrix("blur", (w, ksize, sigma), img.device)).float()


def resize_linear(img: torch.Tensor, size: tuple[int, int],
                  fp32_coords: bool = False) -> torch.Tensor:
    """cv2's ``resize(img, (w, h), INTER_LINEAR)`` of ``(..., H, W)`` fp32
    to ``size = (h, w)``. OpenCV 5.0's own resize, which takes the flow's
    two channels, computes the source coordinates in fp32
    (``fp32_coords``); the path its build takes for one-channel images
    computes them in fp64."""
    h, w = img.shape[-2:]
    dev = img.device
    return _separable(img, _matrix("resize", (h, size[0], fp32_coords), dev),
                      _matrix("resize", (w, size[1], fp32_coords), dev)
                      ).float()


def poly_expansion(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackPolyExp`` of ``(B, H, W)`` fp32: ``(B, 5, H, W)``
    fp32, the coefficients of y, x, yy, xx and xy in OpenCV's order."""
    b, h, w = img.shape
    ig11, ig03, ig33, ig55 = _poly_constants()[1]
    rows = (_matrix("poly", (h,), img.device) @ img.double()
            ).view(b, 3, h, w)                     # vertical g, x g, x^2 g
    t = (rows @ _matrix("poly", (w,), img.device).T).view(b, 3, h, 3, w)
    b1, b2, b4 = t[:, 0, :, 0], t[:, 0, :, 1], t[:, 0, :, 2]
    b3, b6, b5 = t[:, 1, :, 0], t[:, 1, :, 1], t[:, 2, :, 0]
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], 1).float()


def _update_matrices(r0: torch.Tensor, r1: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateMatrices`` in fp32, in its order of
    operations: ``r0``, ``r1`` ``(5, H, W)``, ``flow (2, H, W)`` as (dx,
    dy); returns M ``(5, H, W)``."""
    _, h, w = r0.shape
    grid, hi, last, corners, border = _level_constants(h, w, r0.device)
    f = grid + flow                                  # (x + dx, y + dy)
    f1 = torch.floor(f)
    frac = f - f1
    inside = ((f1 >= 0) & (f1 < hi)).all(0)
    cell = torch.minimum(f1.clamp_min(0), last).long()
    idx = (cell[1] * w + cell[0]) + corners          # (4, H, W)
    p = r1.reshape(5, -1)[:, idx.reshape(-1)].view(5, 4, h, w)
    g = 1 - frac
    wts = torch.stack([g[0], frac[0], g[0], frac[0]]) \
        * torch.stack([g[1], g[1], frac[1], frac[1]])
    t = p * wts                                      # a00 p00, a01 p01, ...
    r = t[:, 0] + t[:, 1] + t[:, 2] + t[:, 3]
    w_in, w_out, terms = _constants(r0.device)
    mixed = torch.cat([r[:2], (r0[2:] + r[2:]) * w_in])
    rr = torch.where(inside, mixed, r0 * w_out)
    lin = (r0[:2] - rr[:2]) * 0.5                    # r2, r3
    lin = lin + (torch.stack([rr[2], rr[4]]) * flow[1]
                 + torch.stack([rr[4], rr[3]]) * flow[0])
    r = torch.cat([lin, rr[2:]]) * border            # r2, r3, r4, r5, r6
    a, b, c, d = (r.index_select(0, planes) for planes in terms)
    sq = a * b + c * d
    m1 = (r[2] + r[3]) * r[4]
    return torch.stack([sq[0], m1, sq[1], sq[2], sq[3]])


def _box_sum(x: torch.Tensor, m: int) -> torch.Tensor:
    """Sums over windows of (2m + 1) x (2m + 1) of ``(C, H, W)``, replicate
    borders, as running sums."""
    _, h, w = x.shape
    p = F.pad(x[None], (m, m, m, m), mode="replicate")[0]
    s = F.pad(torch.cumsum(p, 1), (0, 0, 1, 0))
    s = s[:, 2 * m + 1:] - s[:, :h]
    s = F.pad(torch.cumsum(s, 2), (1, 0))
    return s[:, :, 2 * m + 1:] - s[:, :, :w]


def _update_flow(mats: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateFlow_Blur``: the 15x15 box mean of M
    (replicate borders) and the 2x2 solve, in fp64; the flow ``(2, H, W)``
    as (dx, dy) in fp32."""
    s = _box_sum(mats.double(), WINSIZE // 2) * (1.0 / (WINSIZE * WINSIZE))
    g11, g12, g22 = s[0], s[1], s[2]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    h1, h2 = s[3], s[4]
    num = torch.stack([g11 * h2, g22 * h1]) - g12 * torch.stack([h1, h2])
    return (num * idet).float()


def farneback_flow(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """The flow ``(H, W, 2)`` fp32 as (dx, dy) with ``prev[y, x] ~ nxt[y +
    dy, x + dx]``, of two ``(H, W)`` gray images (uint8, int or float) on
    one device, as ``cv2.calcOpticalFlowFarneback(prev, nxt, None, 0.5, 3,
    15, 3, 5, 1.2, 0)`` gives it."""
    h, w = prev.shape
    imgs = torch.stack([prev, nxt]).float()
    dev = imgs.device
    flow = None
    for sigma, ksize, lh, lw in pyramid_levels(h, w):
        if flow is None:
            flow = torch.zeros(2, lh, lw, dtype=torch.float32, device=dev)
        else:
            flow = resize_linear(flow, (lh, lw), fp32_coords=True) \
                * (1.0 / PYR_SCALE)
        level = _separable(imgs, _matrix("pyramid", (h, lh, ksize, sigma), dev),
                           _matrix("pyramid", (w, lw, ksize, sigma), dev))
        r0, r1 = poly_expansion(level.float())
        mats = _update_matrices(r0, r1, flow)
        for it in range(ITERATIONS):
            flow = _update_flow(mats)
            if it < ITERATIONS - 1:
                mats = _update_matrices(r0, r1, flow)
    return flow.permute(1, 2, 0).contiguous()


def estimate_flow_farneback(prev: torch.Tensor,
                            cur: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``estimate_flow_farneback``
    (video_enhancer_tpu/runtime/experts.py:72-82) on float ``(H, W, 3)``
    frames in [0, 1]: the gray of each frame times 255 truncated to uint8,
    the flow from ``cur`` to ``prev``; returns ``(H, W, 2)`` as (dy, dx)."""
    pg = rgb_to_gray((prev * 255).to(torch.uint8))
    cg = rgb_to_gray((cur * 255).to(torch.uint8))
    flow = farneback_flow(cg, pg)
    return torch.stack([flow[..., 1], flow[..., 0]], -1)
