"""The port's Farneback optical flow (ops/optflow.py) against OpenCV, on the
CPU: its Gaussian blur, its bilinear resize, its polynomial expansion
(against a straight fp64 least-squares fit), the whole flow with the
parameters the temporal stage serves, and ``estimate_flow_farneback``
against the JAX package's.

Tolerances: 1e-4 absolute on images in [0, 255] for the blur and the
resize (fp32 sums in another order: a few ulps at 255); 1e-5 on flows of a
few pixels for the resize; 1e-5 of each plane's largest value for the
expansion; 1e-4 px for the flow (measured 5e-7 to 1.4e-5 px at these
sizes, 1.4e-5 px at 720x1280). Two controls show that the flow test sees
the level-0 blur and the border weights: without either the flow moves by
more than 1e-2 px (measured 0.63 and 7.3 px).
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from video_enhancer_tpu.runtime import experts as jexperts
from video_enhancer_tpu_torch.ops import optflow
from video_enhancer_tpu_torch.ops.optflow import (estimate_flow_farneback,
                                                  farneback_flow,
                                                  gaussian_blur,
                                                  poly_expansion,
                                                  pyramid_levels,
                                                  resize_linear)

SERVED = (0.5, 3, 15, 3, 5, 1.2, 0)
FLOW_TOL = 1e-4


def _field(h: int, w: int, seed: int, shift=(0.0, 0.0)) -> np.ndarray:
    """A smooth seeded gray image in [0, 255]: a sum of 8 plane waves and
    4 Gaussian blobs, sampled at (y + dy, x + dx), float64."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = yy + shift[0], xx + shift[1]
    img = np.zeros((h, w))
    for _ in range(8):
        fy, fx = g.uniform(-0.2, 0.2, 2)
        img += g.uniform(0.5, 1) * np.sin(fy * yy + fx * xx
                                          + g.uniform(0, 2 * np.pi))
    for _ in range(4):
        cy, cx = g.uniform(0, h), g.uniform(0, w)
        img += 2 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                          / (2 * g.uniform(3, 8) ** 2))
    return 127.5 + 110 * img / np.abs(img).max()


def _pair(h, w, seed, shift):
    a = np.round(_field(h, w, seed)).astype(np.uint8)
    b = np.round(_field(h, w, seed, shift)).astype(np.uint8)
    return a, b


def _flow_err(a, b) -> tuple[float, float]:
    want = cv2.calcOpticalFlowFarneback(a, b, None, *SERVED)
    got = farneback_flow(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    return float(np.abs(got - want).max()), float(np.abs(want).max())


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5),
                                         (19, 3.5)])
def test_gaussian_blur_matches_cv2(ksize, sigma):
    img = (np.random.default_rng(ksize).random((45, 77)) * 255).astype(
        np.float32)
    want = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    got = gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("src,dst", [((45, 77), (22, 38)), ((45, 77), (11, 19)),
                                     ((132, 154), (33, 38)),
                                     ((90, 160), (45, 80))])
def test_resize_down_matches_cv2(src, dst):
    img = (np.random.default_rng(src[0]).random(src) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("src,dst", [((23, 39), (45, 77)), ((33, 38), (66, 77)),
                                     ((11, 19), (22, 38))])
def test_resize_flow_up_matches_cv2(src, dst):
    flow = np.random.default_rng(dst[1]).normal(0, 3, src + (2,)).astype(
        np.float32)
    want = cv2.resize(flow, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(torch.from_numpy(flow).permute(2, 0, 1), dst,
                        fp32_coords=True)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("h,w", [(13, 17), (40, 29)])
def test_poly_expansion_matches_least_squares(h, w):
    """Each pixel's weighted fit of 1, x, y, x^2, y^2, xy over its 11x11
    neighbourhood (replicate borders, weights g(y) g(x), g the Gaussian of
    sigma 1.2), solved in fp64 from the full 6x6 normal equations."""
    img = (np.random.default_rng(h).random((h, w)) * 255).astype(np.float32)
    n = optflow.POLY_N
    d = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-d * d / (2 * optflow.POLY_SIGMA ** 2))
    dy, dx = np.meshgrid(d, d, indexing="ij")
    basis = np.stack([np.ones_like(dx), dx, dy, dx * dx, dy * dy, dx * dy],
                     -1).reshape(-1, 6)
    wts = np.outer(g, g).reshape(-1)
    solve = np.linalg.solve(basis.T @ (wts[:, None] * basis),
                            basis.T * wts)            # (6, 121)
    pad = np.pad(img.astype(np.float64), n, mode="edge")
    patches = np.lib.stride_tricks.sliding_window_view(
        pad, (2 * n + 1, 2 * n + 1)).reshape(h, w, -1)
    c = patches @ solve.T                             # (h, w, 6)
    want = np.stack([c[..., 2], c[..., 1], c[..., 4], c[..., 3], c[..., 5]])
    got = poly_expansion(torch.from_numpy(img)[None])[0].numpy()
    assert got.shape == (5, h, w) and got.dtype == np.float32
    for p in range(5):
        np.testing.assert_allclose(got[p], want[p], rtol=0,
                                   atol=1e-5 * np.abs(want[p]).max())


def test_pyramid_levels_as_opencv_sizes_them():
    """Levels k < 3 with both sides times 0.5 ** (k + 1) at least 32; the
    sides rounded halves to even (132x154 at 0.25 is 33x38.5: 38, where
    halves up would give 39)."""
    sizes = lambda h, w: [(lh, lw) for _, _, lh, lw in pyramid_levels(h, w)]
    assert sizes(720, 1280) == [(90, 160), (180, 320), (360, 640),
                                (720, 1280)]
    assert sizes(180, 320) == [(45, 80), (90, 160), (180, 320)]
    assert sizes(132, 154) == [(33, 38), (66, 77), (132, 154)]
    assert sizes(45, 77) == [(45, 77)]
    assert [(s, k) for s, k, _, _ in pyramid_levels(720, 1280)] == [
        (3.5, 19), (1.5, 9), (0.5, 3), (0.0, 3)]


@pytest.mark.parametrize("h,w,shift", [(45, 77, (3.0, -5.0)),
                                       (90, 160, (-4.0, 6.5)),
                                       (132, 154, (5.5, 7.0)),
                                       (90, 160, (0.0, 0.0))])
def test_flow_matches_cv2(h, w, shift):
    a, b = _pair(h, w, h + w, shift)
    err, peak = _flow_err(a, b)
    assert err <= FLOW_TOL, (err, peak)
    if shift != (0.0, 0.0):
        assert peak > 2.0                              # there is motion


@pytest.fixture
def fresh_caches():
    optflow._matrix.cache_clear()
    optflow._level_constants.cache_clear()
    yield
    optflow._matrix.cache_clear()
    optflow._level_constants.cache_clear()


@pytest.mark.parametrize("control", ["no level-0 blur", "no border weights"])
def test_flow_test_sees_level0_blur_and_border_weights(monkeypatch,
                                                       fresh_caches, control):
    """The flow of test_flow_matches_cv2 at 132x154, with the level-0 blur
    taken out, or the border weights set to 1, moves past 1e-2 px."""
    if control == "no level-0 blur":
        real = optflow.gaussian_kernel
        monkeypatch.setattr(optflow, "gaussian_kernel",
                            lambda k, s: np.float32([0, 1, 0]) if s <= 0
                            else real(k, s))
    else:
        monkeypatch.setattr(optflow, "_BORDER", np.ones(5, np.float32))
    err, _ = _flow_err(*_pair(132, 154, 286, (5.5, 7.0)))
    assert err > 1e-2, err


def test_estimate_flow_farneback_matches_jax():
    """The JAX package's (dy, dx) from ``cur`` to ``prev`` on float RGB
    frames, through its gray of the frames times 255 truncated."""
    g = np.random.default_rng(3)
    mix = g.uniform(0.6, 1.0, 3).astype(np.float32)
    prev = np.stack([_field(64, 96, 7) * m for m in mix], -1) / 255
    cur = np.stack([_field(64, 96, 7, (2.3, -3.1)) * m for m in mix], -1) / 255
    prev, cur = prev.astype(np.float32), cur.astype(np.float32)
    want = jexperts.estimate_flow_farneback(prev, cur)
    got = estimate_flow_farneback(torch.from_numpy(prev),
                                  torch.from_numpy(cur)).numpy()
    assert got.shape == want.shape == (64, 96, 2)
    assert np.abs(want).max() > 2.0
    np.testing.assert_allclose(got, want, atol=FLOW_TOL, rtol=0)
