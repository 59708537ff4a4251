"""The port's JPEG round trip (video_enhancer_tpu_torch/io/jpeg.py)
against cv2's ``imencode(".jpg")`` / ``imdecode`` on seeded images.

Tolerance: equal, every value (0 LSB), at qualities 30-90, at the eval's
LR sizes (32x32, 64x64) and at sizes that are not multiples of 16.
"""

import cv2
import numpy as np
import pytest

from video_enhancer_tpu_torch.io.jpeg import jpeg_roundtrip, quant_tables


def _cv2_roundtrip(u8, q):
    ok, enc = cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


def _images(h, w, rng):
    yy, xx = np.mgrid[0:h, 0:w]
    wave = (np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
            * np.array([1.0, 0.6, -0.8]))
    yield np.clip(128 + 80 * wave + rng.normal(0, 20, (h, w, 3)), 0,
                  255).astype(np.uint8)
    yield rng.integers(0, 256, (h, w, 3), dtype=np.uint8)   # pure noise
    flat = np.zeros((h, w, 3), np.uint8)
    flat[:, : w // 2] = (250, 3, 128)
    yield flat                                               # hard edges


@pytest.mark.parametrize("h,w", [(32, 32), (64, 64), (45, 37), (50, 70),
                                 (17, 9)])
def test_jpeg_roundtrip_equals_cv2(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    for img in _images(h, w, rng):
        for q in (30, 35, 42, 50, 61, 74, 89, 90):
            got = jpeg_roundtrip(img, q)
            assert got.dtype == np.uint8 and got.shape == img.shape
            assert np.array_equal(got, _cv2_roundtrip(img, q)), (h, w, q)


def test_quant_tables_follow_the_ijg_scaling():
    luma, chroma = quant_tables(50)
    assert luma[0, 0] == 16 and chroma[7, 7] == 99
    luma, chroma = quant_tables(30)           # scale 166
    assert luma.max() == 201 and luma[0, 0] == 27
    luma, _ = quant_tables(10)                # scale 500: baseline clamp
    assert luma.max() == 255
    luma, _ = quant_tables(90)                # scale 20
    assert luma[0, 0] == 3
