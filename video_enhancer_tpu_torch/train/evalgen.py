"""The cross-generator held-out eval family of the JAX package
(train/evalgen.py), without OpenCV.

A second synthetic family sharing nothing structural with the training
one: multi-octave value noise, Voronoi cells and rotated stripes moved by
an affine camera (rotate, zoom, pan) and a sinusoidal local warp, degraded
by motion blur -> bilinear downsample -> 5-bit quantization + uniform
noise -> a real JPEG round trip. cv2's resize, warpAffine, remap,
filter2D and line come from ``ops/cvhost.py`` and the JPEG round trip from
``io/jpeg.py``; the RNG draws are the JAX package's, in its order.
"""

from __future__ import annotations

import numpy as np

from ..io.jpeg import jpeg_roundtrip
from ..ops import cvhost
from .data import _motion_line_kernel

__all__ = ["make_alt_frames", "degrade_alt", "make_alt_pairs",
           "make_alt_triplets"]


def _value_noise(rng: np.random.Generator, h: int, w: int,
                 octaves: int = 4) -> np.ndarray:
    """Multi-octave smooth value noise in [0, 1], (h, w) float32."""
    img = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh = max(2, h // (1 << (octaves - o + 1)))
        gw = max(2, w // (1 << (octaves - o + 1)))
        g = rng.random((gh, gw)).astype(np.float32)
        img += amp * cvhost.resize(g, (w, h),
                                   interpolation=cvhost.INTER_CUBIC)
        amp *= 0.55
    img -= img.min()
    return img / max(img.max(), 1e-6)


def _voronoi(rng: np.random.Generator, h: int, w: int,
             cells: int = 24) -> np.ndarray:
    """Voronoi cell map in [0, 1]: hard edges, piecewise-flat regions."""
    pts = np.stack([rng.uniform(0, h, cells), rng.uniform(0, w, cells)],
                   axis=1).astype(np.float32)
    vals = rng.random(cells).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = ((yy[..., None] - pts[:, 0]) ** 2
         + (xx[..., None] - pts[:, 1]) ** 2)
    return vals[np.argmin(d, axis=-1)]


def _stripes(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Rotated sinusoidal stripes: directional high-frequency content."""
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(0.05, 0.25)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = (yy * np.sin(theta) + xx * np.cos(theta)) * freq
    return (0.5 + 0.5 * np.sin(2 * np.pi * phase)).astype(np.float32)


def make_alt_frames(frames: int = 24, size_hw: tuple[int, int] = (256, 256),
                    seed: int = 0) -> np.ndarray:
    """(frames, h, w, 3) uint8: an affine-moving composite texture field
    (a 1.6x-oversized static field resampled along the camera path, plus
    a small sinusoidal non-rigid warp)."""
    h, w = size_hw
    rng = np.random.default_rng(seed)
    fh, fw = int(h * 1.6), int(w * 1.6)
    field = np.stack([
        0.6 * _value_noise(rng, fh, fw) + 0.4 * _voronoi(rng, fh, fw),
        0.7 * _value_noise(rng, fh, fw) + 0.3 * _stripes(rng, fh, fw),
        0.5 * _voronoi(rng, fh, fw) + 0.5 * _stripes(rng, fh, fw),
    ], axis=-1).astype(np.float32)

    dx_amp = rng.uniform(0.05, 0.15) * fw
    dy_amp = rng.uniform(0.05, 0.15) * fh
    rot_amp = rng.uniform(2.0, 8.0)          # degrees
    zoom_amp = rng.uniform(0.03, 0.10)
    warp_amp = rng.uniform(0.5, 2.0)         # px
    warp_freq = rng.uniform(1.0, 3.0)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((frames, h, w, 3), np.uint8)
    cx, cy = fw / 2.0, fh / 2.0
    for t in range(frames):
        ph = 2 * np.pi * t / max(frames, 1)
        ang = rot_amp * np.sin(ph)
        zoom = 1.0 + zoom_amp * np.sin(ph * 0.5)
        m = cvhost.rotation_matrix_2d((cx, cy), ang, zoom)
        m[0, 2] += dx_amp * np.sin(ph) - (fw - w) / 2.0
        m[1, 2] += dy_amp * np.cos(ph) - (fh - h) / 2.0
        frame = cvhost.warp_affine(field, m, (w, h))
        mx = (xx + warp_amp * np.sin(2 * np.pi * warp_freq * yy / h + ph)
              ).astype(np.float32)
        my = (yy + warp_amp * np.cos(2 * np.pi * warp_freq * xx / w + ph)
              ).astype(np.float32)
        frame = cvhost.remap(frame, mx, my)
        out[t] = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    return out


def _motion_kernel(rng: np.random.Generator, ksize: int = 7) -> np.ndarray:
    """Normalized linear motion-blur kernel at a random angle/length."""
    return _motion_line_kernel(rng, ksize, 2.0)


def degrade_alt(hr: np.ndarray, scale: int,
                rng: np.random.Generator) -> np.ndarray:
    """HR (t, h, w, 3) float32 [0, 1] -> LR by the alt chain: motion blur
    -> bilinear downsample -> 5-bit quantization + uniform noise -> a JPEG
    round trip."""
    t, h, w, _ = hr.shape
    lh, lw = h // scale, w // scale
    k = _motion_kernel(rng)
    jpeg_q = int(rng.integers(35, 75))
    lr = np.empty((t, lh, lw, 3), np.float32)
    for i in range(t):
        f = cvhost.filter2d(hr[i], k)
        f = cvhost.resize(f, (lw, lh), interpolation=cvhost.INTER_LINEAR)
        f = np.floor(np.clip(f, 0, 1) * 31.0 + 0.5) / 31.0
        f = f + rng.uniform(-0.015, 0.015, f.shape).astype(np.float32)
        u8 = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        lr[i] = jpeg_roundtrip(u8, jpeg_q).astype(np.float32) / 255.0
    return np.clip(lr, 0.0, 1.0)


def make_alt_pairs(frames: np.ndarray, batch: int, clip_len: int, crop: int,
                   scale: int, seed: int = 0) -> dict:
    """Cross-generator (lr, hr) clip pairs; the dict of ``make_pairs``."""
    rng = np.random.default_rng(seed)
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    n, H, W, _ = frames.shape
    assert n >= clip_len, "need at least clip_len source frames"
    hr = np.empty((batch, clip_len, crop, crop, 3), np.float32)
    lr = np.empty((batch, clip_len, crop // scale, crop // scale, 3),
                  np.float32)
    for b in range(batch):
        t0 = rng.integers(0, n - clip_len + 1)
        y = rng.integers(0, max(H - crop, 1))
        x = rng.integers(0, max(W - crop, 1))
        clip_hr = frames[t0:t0 + clip_len, y:y + crop, x:x + crop]
        hr[b] = clip_hr
        lr[b] = degrade_alt(clip_hr, scale, rng)
    return {"lr": lr, "hr": hr}


def make_alt_triplets(frames: np.ndarray, batch: int, crop: int,
                      seed: int = 0) -> dict:
    """Interpolation triplets from the alt motion family."""
    rng = np.random.default_rng(seed)
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    n, H, W, _ = frames.shape
    assert n >= 3, "need at least 3 source frames"
    lr = np.empty((batch, 2, crop, crop, 3), np.float32)
    hr = np.empty((batch, 1, crop, crop, 3), np.float32)
    for b in range(batch):
        t0 = rng.integers(0, n - 2)
        y = rng.integers(0, max(H - crop, 1))
        x = rng.integers(0, max(W - crop, 1))
        win = frames[t0:t0 + 3, y:y + crop, x:x + crop]
        lr[b, 0], lr[b, 1] = win[0], win[2]
        hr[b, 0] = win[1]
    return {"lr": lr, "hr": hr}
