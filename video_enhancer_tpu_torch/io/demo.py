"""Synthetic demo video: moving shapes on a gradient with a frame counter.

Counterpart of video_enhancer_tpu/io/demo.py without OpenCV. The gradient,
the saturating add of the seeded noise, the filled circle (OpenCV's LINE_8
fill, ``Circle`` in drawing.cpp) and the filled rectangle equal the JAX
package's frames bit for bit. The label ``frame NNN`` is the one
difference: OpenCV's Hershey glyph tables are not part of the repository,
so the port draws it with a 5x7 font of its own, stretched over the same
ink area, inside the box ``cv2.getTextSize`` gives the label at scale 0.6
from (8, 24) (``LABEL_BOX``); every pixel outside that box is the JAX
package's. ``write_demo_video`` writes any suffix that io/video.py writes;
the port's entry points write ``.avi``.
"""

from __future__ import annotations

import numpy as np

from .video import write_video

__all__ = ["make_demo_frames", "write_demo_video", "LABEL_BOX"]

# (x0, y0, x1, y1), exclusive ends: cv2.getTextSize("frame NNN",
# FONT_HERSHEY_SIMPLEX, 0.6, 1) is (80, 16) with baseline 1, from (8, 24)
LABEL_BOX = (8, 8, 88, 25)
_INK = (8, 11, 87, 25)               # where OpenCV's strokes fall in it

_GLYPHS = {
    "f": "..##. .#... .#... ####. .#... .#... .#...",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "m": "..... ..... ##.#. #.#.# #.#.# #.#.# #.#.#",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    " ": "..... ..... ..... ..... ..... ..... .....",
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": "####. ....# ....# .###. ....# ....# ####.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
}


def _text_mask(text: str) -> np.ndarray:
    """The label in the 5x7 font, one blank column between glyphs."""
    cols = []
    for ch in text:
        rows = _GLYPHS[ch].split()
        glyph = np.array([[c == "#" for c in r] for r in rows])
        cols += [glyph, np.zeros((7, 1), bool)]
    return np.concatenate(cols[:-1], axis=1)


def _put_label(img: np.ndarray, text: str) -> None:
    """Draws ``text`` in white over ``_INK`` (clipped to the image)."""
    x0, y0, x1, y1 = _INK
    mask = _text_mask(text)
    ys = np.arange(y0, y1)
    xs = np.arange(x0, x1)
    big = mask[(ys - y0) * mask.shape[0] // (y1 - y0)][
        :, (xs - x0) * mask.shape[1] // (x1 - x0)]
    h, w = img.shape[:2]
    big = big[:max(min(h - y0, big.shape[0]), 0),
              :max(min(w - x0, big.shape[1]), 0)]
    img[y0:y0 + big.shape[0], x0:x0 + big.shape[1]][big] = 255


def _fill_circle(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """OpenCV's filled ``Circle`` (LINE_8, no shift): the midpoint walk's
    horizontal spans, clipped to the image."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        for y, xl, xr in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xl < w and xr >= 0:
                img[y, max(xl, 0):min(xr, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def make_demo_frames(frames: int = 48, size_hw: tuple[int, int] = (240, 320),
                     seed: int = 0) -> np.ndarray:
    h, w = size_hw
    rng = np.random.default_rng(seed)
    base_noise = rng.integers(0, 12, (h, w, 3), dtype=np.uint8)
    out = np.empty((frames, h, w, 3), np.uint8)
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    for t in range(frames):
        ph = 2 * np.pi * t / max(frames, 1)
        grad = np.stack(
            [
                (120 + 100 * yy * np.cos(ph)) * np.ones_like(xx),
                (90 + 80 * xx) * np.ones_like(yy),
                60 + 50 * (xx + yy) / 2,
            ],
            axis=-1,
        ).astype(np.uint8)
        img = np.minimum(grad.astype(np.uint16) + base_noise, 255).astype(
            np.uint8)
        cx = int(w * (0.5 + 0.35 * np.cos(ph)))
        cy = int(h * (0.5 + 0.35 * np.sin(ph)))
        _fill_circle(img, cx, cy, max(h // 12, 4), (250, 220, 90))
        x0, y0 = int(w * 0.1), int(h * 0.7)
        x1, y1 = x0 + 30 + t % 20, y0 + 24
        img[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = (80, 200, 240)
        _put_label(img, f"frame {t:03d}")
        out[t] = img
    return out


def write_demo_video(path, frames: int = 48,
                     size_hw: tuple[int, int] = (240, 320),
                     fps: float = 24.0, seed: int = 0) -> str:
    return write_video(path, make_demo_frames(frames, size_hw, seed), fps=fps)
