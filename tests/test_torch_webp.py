"""The port's lossy WebP round trip (video_enhancer_tpu_torch/io/webp.py)
against OpenCV's (libwebp's ``WebPEncodeBGR`` at the quality, then its
decoder).

It is not libwebp bit for bit: the mode decisions use a rate model in
place of libwebp's token costs (the module docstring). What is held, on
64x64 frames of the training data's chain family (make_train_frames
content, downscaled and shot-noised as ``_degrade_chain`` does) at q 20,
35, 50 and 74: the port's PSNR against its input within 1.0 dB of
libwebp's (within 0.05 dB measured), a mean absolute difference from
libwebp's decoded frame of at most 5 LSB (2.6-4.6 measured) with at most
70% of the values more than 2 LSB apart (36-61% measured); on smooth
gradients at q 100, where the quantiser is finest, within 6 LSB
everywhere and 0.6 on average (4 and 0.33, 6 and 0.58 measured).
"""

import cv2
import numpy as np
import pytest

from video_enhancer_tpu_torch.io.webp import webp_roundtrip
from video_enhancer_tpu_torch.train.data import make_train_frames


def _libwebp(img, q):
    ok, enc = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
    assert ok
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def chain_frames():
    rng = np.random.default_rng(0)
    out = []
    for mode in (0, 1, 3):
        f = make_train_frames(2, (128, 128), seed=mode + 1, mode=mode)[0]
        f = f[::2, ::2].astype(np.float32) / 255.0
        f = rng.poisson(np.clip(f, 0, 1) * 600).astype(np.float32) / 600
        out.append(np.clip(f * 255.0, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("q", [20, 35, 50, 74])
def test_webp_roundtrip_is_close_to_libwebp(chain_frames, q):
    for img in chain_frames:
        got, ref = webp_roundtrip(img, q), _libwebp(img, q)
        assert got.shape == ref.shape and got.dtype == np.uint8
        assert abs(_psnr(got, img) - _psnr(ref, img)) <= 1.0
        diff = np.abs(got.astype(np.int64) - ref)
        assert diff.mean() <= 5.0 and (diff > 2).mean() <= 0.7, q


@pytest.mark.parametrize("h,w,steps", [(64, 64, (3, 3, 2)),
                                       (48, 80, (3, 5, 2))])
def test_colour_conversion_and_upsampling_at_q100(h, w, steps):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * steps[0], yy * steps[1], (xx + yy) * steps[2]],
                   -1).clip(0, 255).astype(np.uint8)
    diff = np.abs(webp_roundtrip(img, 100).astype(np.int64)
                  - _libwebp(img, 100))
    assert diff.max() <= 6 and diff.mean() <= 0.6


def test_odd_sizes_keep_their_shape(chain_frames):
    img = chain_frames[0][:21, :13]
    got = webp_roundtrip(img, 40)
    assert got.shape == img.shape
    assert abs(_psnr(got, img) - _psnr(_libwebp(img, 40), img)) <= 1.0
