"""Synthetic demo video: moving shapes on a gradient with a frame counter.

Counterpart of video_enhancer_tpu/io/demo.py without OpenCV, equal to the
JAX package's frames bit for bit: the gradient, the saturating add of the
seeded noise, the filled circle (OpenCV's LINE_8 fill, ``Circle`` in
drawing.cpp), the filled rectangle and the label ``frame NNN`` that
``cv2.putText(img, label, (8, 24), FONT_HERSHEY_SIMPLEX, 0.6, white, 1)``
draws. cv2 5 draws that text anti-aliased, one glyph after another: each
pixel of a glyph has a coverage ``a`` (0-255), and a channel value ``v``
under it becomes ``v + ((255 - v) * a + 127) // 255`` (``_over``; adjacent
digits share a column, blended twice). The coverage of ``frame `` and of
each digit (the same map at each of the three places 10 px apart) was
rendered once with cv2 on black and is kept below as hex bytes, rows 11-24
of the frame from column 8 (``frame ``) and from column 57 (a digit in the
first place); each is clipped to the frame. ``write_demo_video`` writes any
suffix that io/video.py writes; the port's entry points write ``.avi``.
"""

from __future__ import annotations

import numpy as np

from .video import write_video

__all__ = ["make_demo_frames", "write_demo_video"]

_LABEL_Y0, _PREFIX_X0, _DIGIT_X0, _DIGIT_STEP = 11, 8, 57, 10

_PREFIX_ALPHA = """
000000488aa949000000000000000000000000000000
0000000000000000000000000000000000000000000000
000058feebb54f000000000000000000000000000000
0000000000000000000000000000000000000000000000
0000b5ed070000000000000000000000000000000000
0000000000000000000000000000000000000000000000
0000d6be000000000000000000000000080000000000
0000000005000000000400000000000000000500000000
93e5fbf8e5e5409db454bfe3390379e1feeeac1d0000
9dae75e3f9c42521b7f4e482000000004bbdf6e2a01800
4978eadb78781dbbf7fabb96227eff8c4475ebcd0200
bbfedc697ff8dee1a561b3ff75000047f9ac4a62dfcb0b
0000d7ba000000bbff4d0000005f6000000089ff2700
bbff28000073ffbb000004d7ca0000c4d004000033ff68
0000d7ba000000bbf00400000000000a4369b5ff3f00
bbeb00000035ff80000000a0f8030dfa9815151515ee9c
0000d7ba000000bbe3000000002a9df1ecc0c3ff3f00
bbdb00000023ff6f0000008fff0829ffffffffffffffc2
0000d7ba000000bbe300000001cccc3d030074ff3f00
bbdb00000023ff6f0000008fff080df49919191919190d
0000d7ba000000bbe30000003fff52000000b6ff3f00
bbdb00000023ff6f0000008fff08009ed1040000065426
0000d7ba000000bbe300000016fbc0343195fdff3f00
bbdb00000023ff6f0000008fff08003bffa2333abbfd49
0000cdb0000000b1d80000000047e2ffffc874fe3500
b1d00000001cfc6500000085f705000048aaf9ffda5200
0000000000000000000000000000001b120000000000
0000000000000000000000000000000000001112000000
"""
_DIGIT_ALPHA = """
0000000006180000000000 000033c9f9fff195080000 002df8fcaa70ffffb30000
00abff480001d8f2ff3700 00e9f0040041d562ff7800 0cffb20000ac6b20ff9d00
17ffa3001cee0d10ffa600 17ffa30082940010ffa600 0cffb106e72a001fff9e00
00e8ee5cbe000061ff7c00 00acffff540001afff3f00 0033ffffa66ad2ffbe0000
00003decfdfff19e0c0000 000000000a1e0100000000
0000000000000000000000 000000099cf87200000000 000023cfffff8000000000
003eefee78ff8000000000 0035bb212cff8000000000 000000002cff8000000000
000000002cff8000000000 000000002cff8000000000 000000002cff8000000000
000000002cff8000000000 000000002cff8000000000 00307d7d93ffbe7d7d3a00
0070ffffffffffffff8500 0000000000000000000000
0000000006160000000000 000023bdf9ffe08d030000 0012e8f48167beff980000
007dff56000001dbf50500 0090cc0600000097ff2300 00000000000005d2f30400
00000000000195ff7b0000 00000000039fffa8040000 00000003a4ffa904000000
000003a4ffac0400000000 0003a4ffb0050000000000 0098fff4837d7d7d7d2b00
00dcffffffffffffff6700 0000000000000000000000
0000000000000000000000 0085fafafafafafaf20800 003f7e7e7e7eaeffc80200
000000000025e9da150000 000000001adee822000000 00000011d2f23300000000
00000092fff2b9800c0000 0000003c707dbaf8d01100 0000000000000086ff5900
0130110000000034ff8c00 0bfac1010000008dff5600 0097ffb55d5fa7f7dd0f00
000578e8ffffeda8120000 00000000121c0000000000
0000000000000000000000 000000000049edf4110000 0000000018e9fcff180000
00000001b6e79dff180000 0000006cfe4a88ff180000 00002bf6950088ff180000
0007d0d70a0088ff180000 008dfa33000088ff180000 3efdb6505050adff685000
79fffffffffffffffffe05 0a24242424249cff391e00 0000000000008cff180000
00000000000082fb120000 0000000000000000000000
0000000000000000000000 0000defafafafafacc0000 0008ffc17e7e7e7e610000
0020ff7200000000000000 0039ff5900000000000000 0051ff8395ad8b32000000
006afffdbfb5edfd780000 00378837000010c3fd3200 000000000000004bff7400
006a41000000003aff7b00 00d4ee1100000091ff3900 0065fed46257a3ffc00400
00005bd4fdffe898070000 000000000d1e0000000000
0000000000000000000000 0000000000a6f51a000000 0000000069ff8200000000
0000002bf6c70400000000 000008d1f2230000000000 000092fffbf9d184090000
003bfef8a17db5ffcb0600 00b3fe400000007bff7100 01f7d0000000000ffbb200
01ecc8000000000af7b000 00adfb280000005fff6f00 0031edeb7a578dfbcc1000
000030b9f2ffe6a4120000 00000000031c0000000000
0000000000000000000000 008efafafafafafaf72900 00488686868686dcff2100
00000000000011f4bf0000 00000000000074ff510000 000000000003dedf030000
00000000004fff75000000 0000000000bcf512000000 000000002bfe9900000000
0000000098fe2c00000000 00000011f4bd0000000000 00000074ff4f0000000000
000000cdd6030000000000 0000000000000000000000
0000000006180000000000 000043d0faffeca20d0000 0043fcd5634b88facb0000
0099fa130000007aff2700 00a9f00600000065ff3800 0059ff9d1f0b4be3e30500
0000a0fffffffffe340000 005efada81699cfbd21800 01e4d40c00000051ff7600
21ff8b0000000004f8b200 06f7c6030000003aff7f00 0086ffbd594174efec2700
000372e5fffff1b9210000 00000000111e0100000000
0000000009160000000000 000042cffbffe883060000 004afee27d68b9ffac0000
00d6ee1d000002a8ff3d00 0ffeac000000004aff7500 08fbb80000000056ff6e00
00bff73a00000cc3fe2a00 002aecf5af9bdfffa30000 00001991c8e1ffe3120000
0000000000aafd42000000 0000000062ff8900000000 00000026f3cc0600000000
000000b2ee270000000000 0000000000000000000000
"""


def _hex_maps(text: str, shape: tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(text.split())),
                         np.uint8).reshape(shape).astype(np.int64)


_PREFIX_MAP = _hex_maps(_PREFIX_ALPHA, (14, 45))
_DIGIT_MAPS = _hex_maps(_DIGIT_ALPHA, (10, 14, 11))


def _over(v, a):
    """White blended over ``v`` with coverage ``a``."""
    return v + ((255 - v) * a + 127) // 255


def _paint(img: np.ndarray, alpha: np.ndarray, x0: int) -> None:
    """Blends white over ``img`` with ``alpha`` from row 11, column
    ``x0``, clipped to the image."""
    h, w = img.shape[:2]
    alpha = alpha[:max(h - _LABEL_Y0, 0), :max(w - x0, 0)]
    region = img[_LABEL_Y0:_LABEL_Y0 + alpha.shape[0],
                 x0:x0 + alpha.shape[1]]
    region[...] = _over(region.astype(np.int64), alpha[..., None])


def _put_label(img: np.ndarray, t: int) -> None:
    """Draws ``frame {t:03d}`` in white as cv2.putText does (see the
    docstring)."""
    _paint(img, _PREFIX_MAP, _PREFIX_X0)
    for k, ch in enumerate(f"{t:03d}"):
        _paint(img, _DIGIT_MAPS[int(ch)], _DIGIT_X0 + _DIGIT_STEP * k)


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
        _put_label(img, t)
        out[t] = img
    return out


def write_demo_video(path, frames: int = 48,
                     size_hw: tuple[int, int] = (240, 320),
                     fps: float = 24.0, seed: int = 0) -> str:
    return write_video(path, make_demo_frames(frames, size_hw, seed), fps=fps)
