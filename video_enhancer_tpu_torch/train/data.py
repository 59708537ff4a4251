"""Synthetic degradation data: the eval's part of the JAX package's
train/data.py.

HR crops from source frames, degraded to LR by the randomized pipeline
(blur family -> resampler -> noise family -> compression family), with
cv2's ops replaced by ``ops/cvhost.py`` and the JPEG round trip by
``io/jpeg.py``. The RNG draws are made in the JAX package's order, so a
seed gives the same pairs (``_degrade``'s NOTE: the held-out eval
realisations are a function of the draw order). ``make_pairs``'s third
family (``chain_p > 0``, a WebP round trip), ``make_train_frames`` and
``pair_iterator`` are the training side and are not ported.
"""

from __future__ import annotations

import numpy as np

from ..io.jpeg import jpeg_roundtrip
from ..ops import cvhost

__all__ = ["make_pairs", "make_triplets", "triplet_iterator"]


def _rand_blur(f: np.ndarray, kind: int, sigma: float,
               mkernel: np.ndarray | None, ksize: int = 5):
    if kind == 0:
        return f  # no blur
    if kind == 1:
        return cvhost.gaussian_blur(f, ksize, sigma)
    return cvhost.filter2d(f, mkernel)


def _motion_line_kernel(rng: np.random.Generator, ksize: int,
                        min_len: float) -> np.ndarray:
    """A normalized one-pixel line at a random angle and length."""
    k = np.zeros((ksize, ksize), np.float32)
    theta = rng.uniform(0, np.pi)
    c = (ksize - 1) / 2.0
    length = rng.uniform(min_len, ksize - 1.0)
    p0 = (int(round(c - np.cos(theta) * length / 2)),
          int(round(c - np.sin(theta) * length / 2)))
    p1 = (int(round(c + np.cos(theta) * length / 2)),
          int(round(c + np.sin(theta) * length / 2)))
    cvhost.line(k, p0, p1, 1.0)
    s = k.sum()
    if s <= 0:
        k[int(c), int(c)] = 1.0
        s = 1.0
    return k / s


def _rand_motion_kernel(rng: np.random.Generator, ksize: int = 5
                        ) -> np.ndarray:
    return _motion_line_kernel(rng, ksize, 1.5)


def _degrade(hr: np.ndarray, scale: int, rng: np.random.Generator,
             wide: bool = False) -> np.ndarray:
    """One draw per clip of the randomized degradation (see the JAX
    package's ``_degrade``): ``wide`` raises the severity ceiling and the
    per-op firing rates. The default branch keeps the round-4 draw order
    (blur -> mkernel -> interp -> noise -> quant -> compression)."""
    t, h, w, _ = hr.shape
    lh, lw = h // scale, w // scale
    lr = np.empty((t, lh, lw, 3), np.float32)
    interps = [cvhost.INTER_AREA, cvhost.INTER_LINEAR, cvhost.INTER_CUBIC]

    if wide:
        blur_kind = int(rng.choice(3, p=[0.2, 0.4, 0.4]))
        ksize = int(rng.choice([5, 7, 9]))
        sigma = rng.uniform(0.2, 3.0)
        mkernel = _rand_motion_kernel(rng, ksize) if blur_kind == 2 else None
        interp = interps[int(rng.integers(0, 3))]
        noise_kind = int(rng.choice(3, p=[0.2, 0.4, 0.4]))
        noise_std = rng.uniform(0.005, 0.06)
        quantize = rng.random() < 0.45
        qbits_lo = 4
        comp_kind = int(rng.choice(3, p=[0.2, 0.4, 0.4]))
        jpeg_q = int(rng.integers(30, 90))
    else:
        blur_kind = int(rng.integers(0, 3))  # none / gaussian / motion
        ksize = 5
        sigma = rng.uniform(0.2, 2.0)
        mkernel = _rand_motion_kernel(rng) if blur_kind == 2 else None
        interp = interps[int(rng.integers(0, 3))]
        noise_kind = int(rng.integers(0, 3))  # none / gaussian / uniform
        noise_std = rng.uniform(0.005, 0.04)
        quantize = rng.random() < 0.3
        qbits_lo = 5
        comp_kind = int(rng.integers(0, 3))  # none / resize smear / jpeg
        jpeg_q = int(rng.integers(40, 90))

    for i in range(t):
        f = _rand_blur(hr[i], blur_kind, sigma, mkernel, ksize)
        lr[i] = cvhost.resize(f, (lw, lh), interpolation=interp)
    if noise_kind == 1:
        lr += rng.normal(0, noise_std, lr.shape).astype(np.float32)
    elif noise_kind == 2:
        lr += rng.uniform(-noise_std * 1.7, noise_std * 1.7,
                          lr.shape).astype(np.float32)
    if quantize:
        bits = int(rng.integers(qbits_lo, 7))
        levels = (1 << bits) - 1
        lr = np.floor(np.clip(lr, 0, 1) * levels + 0.5) / levels
    if comp_kind == 1:
        for i in range(t):
            small = cvhost.resize(lr[i], (lw * 3 // 4, lh * 3 // 4))
            lr[i] = cvhost.resize(small, (lw, lh),
                                  interpolation=cvhost.INTER_LINEAR)
    elif comp_kind == 2:
        for i in range(t):
            u8 = np.clip(lr[i] * 255.0, 0, 255).astype(np.uint8)
            lr[i] = jpeg_roundtrip(u8, jpeg_q).astype(np.float32) / 255.0
    return np.clip(lr, 0.0, 1.0)


def make_pairs(frames: np.ndarray, batch: int, clip_len: int,
               crop: int, scale: int, seed: int = 0,
               compound_p: float = 0.0, wide: bool = False,
               chain_p: float = 0.0, wide_p: float = 0.0) -> dict:
    """A batch of (lr, hr) clip pairs from source frames ``(N, H, W, 3)``
    (uint8 or float): ``{"lr": (B, T, h, w, 3), "hr": (B, T, H, W, 3)}``
    float32 in [0, 1]. ``compound_p`` stacks a second scale-1 ``_degrade``
    on the LR; ``wide_p`` / ``wide`` draw the wide tier; the defaults are
    the eval's. ``chain_p > 0`` (the WebP chain family of training)
    raises NotImplementedError."""
    if chain_p:
        raise NotImplementedError(
            "make_pairs(chain_p > 0): the chain family needs a WebP round "
            "trip, which the port does not have yet")
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
        # no mixture draw on the default path: the eval's realisations are
        # pinned to the canonical RNG stream
        draw = rng.random() if wide_p else 1.0
        if draw < wide_p or wide:
            lr[b] = _degrade(clip_hr, scale, rng, wide=True)
        else:
            lr[b] = _degrade(clip_hr, scale, rng)
        if compound_p and rng.random() < compound_p:
            lr[b] = _degrade(lr[b], 1, rng)
    return {"lr": lr, "hr": hr}


def make_triplets(frames: np.ndarray, batch: int, crop: int,
                  seed: int = 0) -> dict:
    """Frame-interpolation triplets: ``lr`` the two endpoint frames
    (B, 2, c, c, 3), ``hr`` the true middle frame (B, 1, c, c, 3)."""
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


def triplet_iterator(frames: np.ndarray, batch: int, crop: int,
                     seed: int = 0):
    step = 0
    while True:
        yield make_triplets(frames, batch, crop, seed=seed + step)
        step += 1
