"""The benchmark's input frames, made on the host with numpy from the seed.

A traffic mix (``traffic/<mix>.json``) gives the frame size, the frames a
clip holds and how many distinct clips the run cycles through
(``pool_clips``), and optionally ``degrade``: for each of ``noise``,
``blur`` and ``compression`` the range its strength is drawn from, per
clip. Each clip is a moving textured scene: a canvas of smooth colour,
gratings and hard-edged shapes that the camera pans across at a speed
drawn per clip, with sprites moving over it at their own speeds; a
degraded clip's scene is blurred and blocked into 8x8 means, and its
frames are given noise, by its drawn strengths. Every seed gives the same
sizes and the same amount of work; only the content differs.

The pattern follows the program's own seeded content generators (its
demo video and evaluation data); this is the benchmark's own copy, so
that the inputs do not change when the program does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_DEG_KINDS = ("noise", "blur", "compression")
_MAX_SPEED = 1.5          # pixels a frame, camera and sprites


@dataclass
class Clip:
    frames: np.ndarray                     # (n, H, W, 3) uint8
    degradation: dict = field(default_factory=dict)

    def context(self) -> dict:
        """The degradation context a conditioned model is given for this
        clip: the scores (noise, motion blur, compression) and the type, an
        index into (unknown, noise, blur, compression): the strongest
        degradation's when one is above 0.3, as the program's router
        derives it."""
        scores = [float(self.degradation.get(k, 0.0)) for k in _DEG_KINDS]
        kind = 1 + int(np.argmax(scores)) if max(scores) > 0.3 else 0
        return {"degradation_scores": scores, "degradation_type": kind}


def _box_blur(img: np.ndarray, r: int) -> np.ndarray:
    """Separable box filter of radius ``r`` with edge padding."""
    if r <= 0:
        return img
    for axis in (0, 1):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(img, pad, mode="edge"), axis=axis,
                      dtype=np.float32)
        n = img.shape[axis]
        hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
        lo = np.take(c, np.arange(0, n), axis=axis)
        img = (hi - lo) / (2 * r + 1)
    return img


def _canvas(rng, h: int, w: int) -> np.ndarray:
    """Smooth colour, three gratings and some hard-edged shapes, float32
    in [0, 1]."""
    coarse = rng.random((h // 32 + 2, w // 32 + 2, 3), dtype=np.float32)
    base = np.repeat(np.repeat(coarse, 32, axis=0), 32, axis=1)[:h, :w]
    img = 0.2 + 0.6 * _box_blur(base, 16)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(3):
        freq = rng.uniform(0.05, 0.6)
        ang = rng.uniform(0, np.pi)
        phase = rng.uniform(0, 2 * np.pi)
        g = np.sin(freq * (np.cos(ang) * xx + np.sin(ang) * yy) + phase)
        img += (0.08 * g)[..., None] * rng.uniform(0.3, 1.0, 3).astype(
            np.float32)
    for _ in range(h * w // 4000):
        y, x = rng.integers(0, h), rng.integers(0, w)
        sh, sw = rng.integers(4, 48, 2)
        colour = rng.random(3, dtype=np.float32)
        if rng.random() < 0.5:
            img[y:y + sh, x:x + sw] = colour
        else:
            r = min(sh, sw) // 2 + 1
            ys, xs = np.ogrid[-r:r, -r:r]
            disc = (ys * ys + xs * xs) < r * r
            patch = img[y:y + 2 * r, x:x + 2 * r]
            m = disc[:patch.shape[0], :patch.shape[1]]
            patch[m] = colour
    return np.clip(img, 0.0, 1.0)


def _degrade(img: np.ndarray, deg: dict) -> np.ndarray:
    """Blur by a box of radius 1-4 and 8x8 blocking, by their drawn
    strengths, then to uint8."""
    if deg.get("blur"):
        img = _box_blur(img, int(round(1 + 3 * deg["blur"])))
    c = deg.get("compression", 0.0)
    if c:
        h, w = img.shape[0] // 8 * 8, img.shape[1] // 8 * 8
        blocks = img[:h, :w].reshape(h // 8, 8, w // 8, 8, 3)
        img = img.copy()
        img[:h, :w] = ((1 - c) * blocks + c * blocks.mean(
            axis=(1, 3), keepdims=True)).reshape(h, w, 3)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def make_clip(mix: dict, seed: int, index: int) -> Clip:
    """Clip ``index`` of ``mix`` for ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    h, w, n = mix["height"], mix["width"], mix["clip_frames"]
    pad = int(np.ceil(_MAX_SPEED * n)) + 8
    ch, cw = h + 2 * pad, w + 2 * pad
    deg = {k: float(rng.uniform(*rng_range))
           for k, rng_range in mix.get("degrade", {}).items()}
    canvas = _degrade(_canvas(rng, ch, cw), deg)
    vy, vx = rng.uniform(-_MAX_SPEED, _MAX_SPEED, 2)
    sprites = []
    for _ in range(3):
        sh, sw = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        sprites.append((_degrade(_canvas(rng, sh, sw)[::-1], deg),
                        rng.uniform(0, h - sh), rng.uniform(0, w - sw),
                        *rng.uniform(-2 * _MAX_SPEED, 2 * _MAX_SPEED, 2)))
    noise = None
    if deg.get("noise"):
        sigma = 20.0 * deg["noise"]
        noise = np.round(rng.standard_normal((4, h, w, 3), dtype=np.float32)
                         * sigma).astype(np.int16)
    frames = np.empty((n, h, w, 3), dtype=np.uint8)
    for t in range(n):
        oy, ox = int(round(pad + vy * t)), int(round(pad + vx * t))
        f = frames[t]
        f[:] = canvas[oy:oy + h, ox:ox + w]
        for img, sy, sx, svy, svx in sprites:
            y = int(sy + svy * t) % max(h - img.shape[0], 1)
            x = int(sx + svx * t) % max(w - img.shape[1], 1)
            f[y:y + img.shape[0], x:x + img.shape[1]] = img
        if noise is not None:
            f[:] = np.clip(f + noise[t % 4], 0, 255)
    return Clip(frames, deg)


def make_pool(mix: dict, seed: int) -> list[Clip]:
    """The distinct clips a run cycles through."""
    return [make_clip(mix, seed, k) for k in range(mix["pool_clips"])]
