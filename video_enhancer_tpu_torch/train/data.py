"""Synthetic degradation data: the counterpart of the JAX package's
train/data.py.

HR crops from source frames, degraded to LR by a randomized pipeline
(blur family -> resampler -> noise family -> compression family), with
cv2's ops replaced by ``ops/cvhost.py``, the JPEG round trip by
``io/jpeg.py`` and the WebP round trip by ``io/webp.py``. The RNG draws
are made in the JAX package's order, so a seed gives the same pairs
(``_degrade``'s NOTE: the held-out eval realisations are a function of the
draw order). The training side: ``make_train_frames`` (five content and
motion processes), the always-compound chain family (``_degrade_chain``:
defocus or anisotropic blur, nearest or Lanczos4 resample, shot noise, a
WebP round trip) and ``pair_iterator``'s mixture. It stays in numpy, as
the JAX package's does; the train CLI runs it in a thread beside the
device step.

The WebP round trip is not libwebp's bit for bit (``io/webp.py``), so a
chain clip's LR differs from the JAX package's by its codec's distance;
it draws nothing from the RNG, so every later draw of a batch stays the
same. Shot noise (``rng.poisson``) draws a value-dependent number of
uniforms, which is why the resample before it is cv2's to the bit.
"""

from __future__ import annotations

import numpy as np

from ..io.jpeg import jpeg_roundtrip
from ..io.webp import webp_roundtrip
from ..ops import cvhost

__all__ = ["make_pairs", "pair_iterator", "make_triplets",
           "triplet_iterator", "make_train_frames"]


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


def _disk_kernel(rng: np.random.Generator) -> np.ndarray:
    """Defocus (disk) blur kernel."""
    r = float(rng.uniform(1.0, 3.0))
    k = int(2 * np.ceil(r) + 1)
    yy, xx = np.mgrid[0:k, 0:k].astype(np.float32)
    c = (k - 1) / 2.0
    disk = ((yy - c) ** 2 + (xx - c) ** 2 <= r * r).astype(np.float32)
    return disk / disk.sum()


def _degrade_chain(hr: np.ndarray, scale: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """The always-compound training family: defocus or rotated
    anisotropic blur -> nearest or Lanczos4 resample -> shot noise ->
    WebP round trip (of the frame as cv2 sees it: channel 0 is blue)."""
    t, h, w, _ = hr.shape
    lh, lw = h // scale, w // scale
    if rng.random() < 0.5:
        kern = _disk_kernel(rng)
    else:
        sx, sy = rng.uniform(0.4, 2.5, 2)
        theta = rng.uniform(0, np.pi)
        k = 7
        yy, xx = np.mgrid[0:k, 0:k].astype(np.float32) - (k - 1) / 2.0
        xr = xx * np.cos(theta) + yy * np.sin(theta)
        yr = -xx * np.sin(theta) + yy * np.cos(theta)
        kern = np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
        kern /= kern.sum()
    interp = (cvhost.INTER_NEAREST if rng.random() < 0.5
              else cvhost.INTER_LANCZOS4)
    shot = rng.uniform(200.0, 1200.0)  # photons at full scale
    webp_q = int(rng.integers(20, 75))

    lr = np.empty((t, lh, lw, 3), np.float32)
    for i in range(t):
        f = cvhost.filter2d(hr[i], kern)
        f = cvhost.resize(f, (lw, lh), interpolation=interp)
        f = rng.poisson(np.clip(f, 0, 1) * shot).astype(np.float32) / shot
        u8 = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        lr[i] = webp_roundtrip(u8, webp_q).astype(np.float32) / 255.0
    return np.clip(lr, 0.0, 1.0)


def _spectral_texture(rng: np.random.Generator, h: int, w: int,
                      slope: float) -> np.ndarray:
    """Power-law-filtered Gaussian noise field in [0, 1]."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    rad = np.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    spec = (np.fft.rfft2(rng.standard_normal((h, w)))
            * (rad ** (-slope))).astype(np.complex64)
    img = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def _mosaic_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random rectangular mosaic: piecewise-flat cells with hard edges."""
    img = np.empty((h, w, 3), np.float32)
    img[:] = rng.uniform(0, 1, 3)
    for _ in range(int(rng.integers(30, 90))):
        x0, y0 = int(rng.integers(0, w - 4)), int(rng.integers(0, h - 4))
        bw = int(rng.integers(4, max(w // 3, 5)))
        bh = int(rng.integers(4, max(h // 3, 5)))
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(0, 1, 3)
    return img


def _plaid_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Outer sum of two random 1-D step/wave profiles."""
    def profile(n):
        steps = np.repeat(rng.uniform(0, 1, max(n // int(rng.integers(4, 17)),
                                                2)), n)[:n]
        wave = 0.5 + 0.5 * np.sin(np.arange(n) * rng.uniform(0.05, 0.6)
                                  + rng.uniform(0, 6.28))
        a = rng.uniform(0.2, 0.8)
        return a * steps + (1 - a) * wave

    py, px = profile(h)[:, None], profile(w)[None, :]
    base = (py + px) / 2
    return np.stack([base * c for c in rng.uniform(0.4, 1.0, 3)],
                    axis=-1).astype(np.float32)


def make_train_frames(frames: int = 48,
                      size_hw: tuple[int, int] = (256, 256),
                      seed: int = 0, mode: int | None = None) -> np.ndarray:
    """Diverse training clips, ``(frames, h, w, 3)`` uint8. ``mode`` picks
    the content and motion process (None: a seeded choice): 0 spectral
    noise + sprites under an integer scroll, 1 a mosaic under affine drift,
    2 a plaid under subpixel translation and brightness drift, 3 a
    gradient + polygons with subpixel sprites, 4 a composite texture under
    a smooth random flow field and a random-walk camera."""
    h, w = size_hw
    rng = np.random.default_rng(seed)
    if mode is None:
        mode = int(rng.integers(0, 5))
    if mode == 4:
        return _make_flow_clip(rng, frames, h, w)
    if mode != 0:
        return _make_warped_clip(rng, frames, h, w, mode)
    slope = rng.uniform(0.8, 2.2)
    bg = np.stack([_spectral_texture(rng, h * 2, w * 2, slope)
                   for _ in range(3)], axis=-1)
    bg = (bg * rng.uniform(120, 255, (1, 1, 3))).astype(np.float32)
    vx, vy = rng.uniform(-3, 3), rng.uniform(-3, 3)

    n_sprites = int(rng.integers(2, 6))
    sprites = [{
        "pos": rng.uniform([0, 0], [w, h]),
        "vel": rng.uniform(-4, 4, 2),
        "size": rng.uniform(h / 16, h / 5),
        "color": rng.uniform(40, 250, 3),
        "poly": rng.random() < 0.5,
        "nv": int(rng.integers(3, 7)),
        "phase": rng.uniform(0, 2 * np.pi),
    } for _ in range(n_sprites)]

    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        x0 = int(w / 2 + vx * t) % w
        y0 = int(h / 2 + vy * t) % h
        img = bg[y0:y0 + h, x0:x0 + w].copy()
        flick = 1.0 + 0.08 * np.sin(2 * np.pi * t / max(frames, 1)
                                    + sprites[0]["phase"])
        for s in sprites:
            cx, cy = s["pos"] + s["vel"] * t
            cx, cy = int(cx) % w, int(cy) % h
            color = tuple(float(c) * flick for c in s["color"])
            if s["poly"]:
                ang = s["phase"] + 0.1 * t
                pts = np.stack([
                    cx + s["size"] * np.cos(ang + 2 * np.pi
                                            * np.arange(s["nv"]) / s["nv"]),
                    cy + s["size"] * np.sin(ang + 2 * np.pi
                                            * np.arange(s["nv"]) / s["nv"]),
                ], axis=1).astype(np.int32)
                cvhost.fill_poly(img, [pts], color)
            else:
                cvhost.ellipse(img, (cx, cy),
                               (int(s["size"]), int(s["size"] * 0.6)),
                               float(np.degrees(s["phase"])) + 3 * t, 0, 360,
                               color, -1)
        out[t] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def _make_warped_clip(rng: np.random.Generator, frames: int, h: int,
                      w: int, mode: int) -> np.ndarray:
    """Subpixel-motion clips (modes 1-3 of make_train_frames)."""
    pad = 1.35  # canvas margin so affine drift never exposes the border
    ch, cw = int(h * pad), int(w * pad)
    if mode == 1:
        canvas = _mosaic_texture(rng, ch, cw)
    elif mode == 2:
        canvas = _plaid_texture(rng, ch, cw)
    else:
        ramp_y = np.linspace(0, 1, ch, dtype=np.float32)[:, None, None]
        ramp_x = np.linspace(0, 1, cw, dtype=np.float32)[None, :, None]
        c0, c1, c2 = (rng.uniform(0, 1, 3).astype(np.float32)
                      for _ in range(3))
        canvas = c0 * (1 - ramp_y) + c1 * ramp_y * (1 - ramp_x) \
            + c2 * ramp_x
        for _ in range(int(rng.integers(2, 6))):
            ctr = rng.integers(10, min(ch, cw) - 10, 2)
            verts = (ctr + rng.integers(-max(h // 6, 8), max(h // 6, 8) + 1,
                                        (int(rng.integers(3, 7)), 2)))
            cvhost.fill_poly(canvas, [verts.astype(np.int32)],
                             rng.uniform(0, 1, 3).tolist())
    canvas = np.ascontiguousarray(canvas, np.float32)

    # global affine drift at a constant per-clip velocity, warped with
    # subpixel (bilinear) resampling
    tvx, tvy = rng.uniform(-1.6, 1.6, 2)
    if mode == 2:
        rot_v, zoom_v = 0.0, 0.0   # pure subpixel translation
    else:
        rot_v = rng.uniform(-0.5, 0.5)          # deg / frame
        zoom_v = rng.uniform(-0.003, 0.003)     # log-zoom / frame
    cx, cy = cw / 2, ch / 2
    bright_v = rng.uniform(-0.002, 0.002)

    n_sp = int(rng.integers(0, 4)) if mode != 2 else 0
    sprites = [{
        "pos": rng.uniform([0, 0], [cw, ch]),
        "vel": rng.uniform(-2.5, 2.5, 2),
        "size": rng.uniform(h / 14, h / 5),
        "color": rng.uniform(0.05, 1.0, 3),
    } for _ in range(n_sp)]

    out = np.empty((frames, h, w, 3), np.uint8)
    y0, x0 = (ch - h) // 2, (cw - w) // 2
    for t in range(frames):
        img = canvas.copy()
        for s in sprites:
            px, py = s["pos"] + s["vel"] * t
            # the JAX package asks for LINE_AA, which cv2 draws as LINE_8
            # on a float image
            cvhost.circle(img, (int(px) % cw, int(py) % ch),
                          int(s["size"]), s["color"].tolist(), -1)
        ang = rot_v * t
        z = float(np.exp(zoom_v * t))
        M = cvhost.rotation_matrix_2d((cx, cy), ang, z)
        M[0, 2] += tvx * t
        M[1, 2] += tvy * t
        warped = cvhost.warp_affine(img, M, (cw, ch))
        crop = warped[y0:y0 + h, x0:x0 + w] * (1.0 + bright_v * t)
        out[t] = np.clip(crop * 255.0, 0, 255).astype(np.uint8)
    return out


def _make_flow_clip(rng: np.random.Generator, frames: int, h: int,
                    w: int) -> np.ndarray:
    """Mode 4 of make_train_frames: a composite texture advected by a
    smooth random per-pixel velocity field while an integrated random
    walk pans the crop; every pixel resampled (remap) each frame."""
    pad = 1.3
    ch, cw = int(h * pad), int(w * pad)
    slope = rng.uniform(0.8, 2.0)
    mix = rng.uniform(0.25, 0.75)
    canvas = np.stack([
        mix * _spectral_texture(rng, ch, cw, slope)
        + (1 - mix) * _mosaic_texture(rng, ch, cw)[..., c]
        for c in range(3)
    ], axis=-1).astype(np.float32)
    canvas *= rng.uniform(0.5, 1.0, (1, 1, 3)).astype(np.float32)

    # smooth random flow: white noise blurred to ~h/6 correlation length,
    # scaled to a subpixel per-frame velocity
    vmax = rng.uniform(0.3, 1.4)  # px / frame
    sig = max(h, w) / 6.0
    flow = np.stack([cvhost.gaussian_blur(rng.standard_normal((ch, cw))
                                          .astype(np.float32), 0, sig)
                     for _ in range(2)], axis=-1)
    flow *= vmax / max(np.abs(flow).max(), 1e-6)

    kicks = rng.normal(0, 0.25, (frames, 2)).astype(np.float32)
    vel = np.cumsum(kicks, axis=0)
    cam = np.cumsum(vel, axis=0)
    cam -= cam.mean(axis=0, keepdims=True)
    lim = (min(ch - h, cw - w) / 2.0) * 0.9
    scale_cam = lim / max(np.abs(cam).max(), 1e-6)
    cam *= min(1.0, scale_cam)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y0, x0 = (ch - h) // 2, (cw - w) // 2
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        mx = xx + x0 + cam[t, 0] + t * flow[y0:y0 + h, x0:x0 + w, 0]
        my = yy + y0 + cam[t, 1] + t * flow[y0:y0 + h, x0:x0 + w, 1]
        fr = cvhost.remap(canvas, mx.astype(np.float32),
                          my.astype(np.float32))
        out[t] = np.clip(fr * 255.0, 0, 255).astype(np.uint8)
    return out


def make_pairs(frames: np.ndarray, batch: int, clip_len: int,
               crop: int, scale: int, seed: int = 0,
               compound_p: float = 0.0, wide: bool = False,
               chain_p: float = 0.0, wide_p: float = 0.0) -> dict:
    """A batch of (lr, hr) clip pairs from source frames ``(N, H, W, 3)``
    (uint8 or float): ``{"lr": (B, T, h, w, 3), "hr": (B, T, H, W, 3)}``
    float32 in [0, 1]. The per-clip mixture (training only): ``chain_p``
    draws the chain family, ``wide_p`` (or ``wide``) the wide tier, the
    rest the canonical chain; ``compound_p`` stacks a second scale-1
    ``_degrade`` on the LR. The defaults are the eval's, with no mixture
    draw."""
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
        draw = rng.random() if (chain_p or wide_p) else 1.0
        if draw < chain_p:
            lr[b] = _degrade_chain(clip_hr, scale, rng)
        elif draw < chain_p + wide_p or wide:
            lr[b] = _degrade(clip_hr, scale, rng, wide=True)
        else:
            lr[b] = _degrade(clip_hr, scale, rng)
        if compound_p and rng.random() < compound_p:
            lr[b] = _degrade(lr[b], 1, rng)
    return {"lr": lr, "hr": hr}


def pair_iterator(frames: np.ndarray, batch: int, clip_len: int, crop: int,
                  scale: int, seed: int = 0, compound_p: float = 0.25,
                  chain_p: float = 0.3, wide_p: float = 0.2):
    """Infinite iterator of training batches, batch ``k`` from seed
    ``seed + k``: 50% canonical draws, 30% the chain family, 20% the wide
    tier, plus an independent 25% second-pass stack."""
    step = 0
    while True:
        yield make_pairs(frames, batch, clip_len, crop, scale,
                         seed=seed + step, compound_p=compound_p,
                         chain_p=chain_p, wide_p=wide_p)
        step += 1


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
