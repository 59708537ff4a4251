"""The port's host image ops (video_enhancer_tpu_torch/ops/cvhost.py)
against OpenCV on seeded float32 images.

Tolerances, on values in [0, 1]: ``line``, the rotation matrix, nearest
and integer-factor area resizes, warp_affine, remap, filter2D and the 7-
and 9-tap blurs are equal; the 5-tap blur 1.8e-7 (three ulps), linear resizes
1.2e-7, cubic and non-integer area resizes 3.6e-7.

The drawing ops (cv2 5 on float images): ``fill_poly``, ``ellipse``
(filled, arcs, outlines of any thickness), ``circle``, ``rectangle`` and
``line`` of any thickness are equal on shapes inside the image, and the
thick lines, circles, rectangles and full ellipses also where they cross
its border. A filled polygon or arc that crosses the border can differ
on the border column (cv2 5 fills some spans there that its edge list
does not explain): at most 2% of such draws here. Lanczos4 downscales by
integer factors are equal (the data path's 2x and 4x); the sigma-derived
Gaussian blur (``ksize`` 0: ``round(8 sigma + 1) | 1`` taps) within 1e-7
of unit-variance noise (its row tails take cv2's other vector widths).
"""

import itertools

import cv2
import numpy as np
import pytest

from video_enhancer_tpu_torch.ops import cvhost

RNG = np.random.default_rng(20260)


def _img(h, w, c=3):
    return RNG.random((h, w, c)).astype(np.float32)


def test_line_equals_cv2_on_every_pair_of_a_7x7_grid():
    pts = list(itertools.product(range(7), range(7)))
    for p0, p1 in itertools.product(pts, pts):
        ref = np.zeros((7, 7), np.float32)
        cv2.line(ref, p0, p1, 1.0, 1)
        got = cvhost.line(np.zeros((7, 7), np.float32), p0, p1, 1.0)
        assert np.array_equal(got, ref), (p0, p1)


@pytest.mark.parametrize("ksize,sigma,tol", [
    (5, 0.35, 1.8e-7), (5, 1.7, 1.8e-7), (7, 2.1, 0.0), (9, 0.7, 0.0),
    (9, 3.3, 0.0)])
def test_gaussian_blur_matches_cv2(ksize, sigma, tol):
    assert np.array_equal(cvhost.gaussian_kernel(ksize, sigma),
                          cv2.getGaussianKernel(ksize, sigma,
                                                cv2.CV_32F).ravel())
    for h, w in ((128, 128), (96, 96), (64, 64)):
        img = _img(h, w)
        got = cvhost.gaussian_blur(img, ksize, sigma)
        ref = cv2.GaussianBlur(img, (ksize, ksize), sigma)
        assert np.abs(got - ref).max() <= tol, (h, w)


@pytest.mark.parametrize("ksize", [5, 7, 9])
def test_filter2d_matches_cv2_on_motion_kernels(ksize):
    for trial in range(4):
        k = np.zeros((ksize, ksize), np.float32)
        p0 = tuple(int(v) for v in RNG.integers(0, ksize, 2))
        p1 = tuple(int(v) for v in RNG.integers(0, ksize, 2))
        cv2.line(k, p0, p1, 1.0, 1)
        k /= k.sum()
        for h, w in ((128, 128), (64, 64)):
            img = _img(h, w)
            assert np.array_equal(cvhost.filter2d(img, k),
                                  cv2.filter2D(img, -1, k)), (trial, h, w)


@pytest.mark.parametrize("interp,name,tol", [
    (cv2.INTER_LINEAR, "linear", 1.2e-7), (cv2.INTER_CUBIC, "cubic", 3.6e-7),
    (cv2.INTER_AREA, "area", 3.6e-7), (cv2.INTER_NEAREST, "nearest", 0.0)])
def test_resize_matches_cv2(interp, name, tol):
    sizes = [((128, 128), (32, 32)), ((128, 128), (64, 64)),
             ((32, 32), (24, 24)), ((96, 96), (57, 57)),
             ((40, 52), (17, 23)), ((64, 64), (64, 64))]
    if interp != cv2.INTER_AREA:     # cv2's area upscale is not ported
        sizes += [((24, 24), (32, 32)), ((12, 12), (409, 409)),
                  ((16, 16), (64, 64))]
    for (h, w), (oh, ow) in sizes:
        for c in (3, None):
            img = _img(h, w, 3) if c else _img(h, w, 1)[..., 0]
            got = cvhost.resize(img, (ow, oh), interpolation=interp)
            ref = cv2.resize(img, (ow, oh), interpolation=interp)
            assert got.shape == ref.shape
            err = np.abs(got - ref).max()
            exact = (interp == cv2.INTER_AREA and h % oh == 0
                     and w % ow == 0) or (h, w) == (oh, ow)
            assert err <= (0.0 if exact else tol), (name, h, w, oh, ow, err)
    img = _img(40, 44)
    assert np.abs(cvhost.resize(img, (33, 30)) - cv2.resize(img, (33, 30))
                  ).max() <= 1.2e-7


def test_warp_affine_and_remap_match_cv2():
    field = _img(409, 409)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    for t in range(4):
        ph = 2 * np.pi * t / 24
        m = cv2.getRotationMatrix2D((204.5, 204.5), 5.0 * np.sin(ph),
                                    1.0 + 0.07 * np.sin(ph * 0.5))
        m[0, 2] += 30.3 * np.sin(ph) - 76.5
        m[1, 2] += 21.7 * np.cos(ph) - 76.5
        mine = cvhost.rotation_matrix_2d((204.5, 204.5), 5.0 * np.sin(ph),
                                         1.0 + 0.07 * np.sin(ph * 0.5))
        mine[0, 2] += 30.3 * np.sin(ph) - 76.5
        mine[1, 2] += 21.7 * np.cos(ph) - 76.5
        assert np.array_equal(mine, m)
        ref = cv2.warpAffine(field, m, (256, 256), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_REFLECT)
        got = cvhost.warp_affine(field, mine, (256, 256))
        assert np.array_equal(got, ref), t
        mx = (xx + 1.3 * np.sin(2 * np.pi * 2.2 * yy / 256 + ph)
              ).astype(np.float32)
        my = (yy + 1.1 * np.cos(2 * np.pi * 2.2 * xx / 256 + ph)
              ).astype(np.float32)
        ref2 = cv2.remap(ref, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
        assert np.array_equal(cvhost.remap(got, mx, my), ref2), t


def _draw_cases(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (tuple(int(v) for v in rng.integers(lo, hi, 2)),
               tuple(int(v) for v in rng.integers(0, 30, 2)),
               float(rng.uniform(-30, 400)),
               tuple(int(v) for v in rng.integers(-50, 400, 2)),
               int(rng.integers(1, 7)),
               rng.integers(lo, hi, (int(rng.integers(3, 9)), 2)).astype(
                   np.int32),
               tuple(int(v) for v in rng.integers(lo - 20, hi + 20, 2)))


def _same(ref_fn, got_fn, shape=(64, 80, 3)):
    ref, got = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    ref_fn(ref)
    got_fn(got)
    return np.array_equal(ref, got)


def test_drawing_equals_cv2_inside_the_image():
    col = (0.3, 0.55, 0.8)
    for c, ax, ang, (s, e), th, pts, p1 in _draw_cases(150, 30, 50, 1):
        pts = np.clip(pts, 0, 63)
        cases = {
            "fill_poly": (lambda a: cv2.fillPoly(a, [pts], col),
                          lambda a: cvhost.fill_poly(a, [pts], col)),
            "ellipse": (lambda a: cv2.ellipse(a, c, ax, ang, 0, 360, col, -1),
                        lambda a: cvhost.ellipse(a, c, ax, ang, 0, 360, col,
                                                 -1)),
            "arc": (lambda a: cv2.ellipse(a, c, ax, ang, s, e, col, -1),
                    lambda a: cvhost.ellipse(a, c, ax, ang, s, e, col, -1)),
            "outline": (lambda a: cv2.ellipse(a, c, ax, ang, s, e, col, th),
                        lambda a: cvhost.ellipse(a, c, ax, ang, s, e, col,
                                                 th)),
            "circle": (lambda a: cv2.circle(a, c, ax[0], col, -1),
                       lambda a: cvhost.circle(a, c, ax[0], col, -1)),
            "ring": (lambda a: cv2.circle(a, c, ax[0], col, th),
                     lambda a: cvhost.circle(a, c, ax[0], col, th)),
            "rectangle": (lambda a: cv2.rectangle(a, c, p1, col, -1),
                          lambda a: cvhost.rectangle(a, c, p1, col, -1)),
            "line": (lambda a: cv2.line(a, c, p1, col, th),
                     lambda a: cvhost.line(a, c, p1, col, th)),
        }
        if max(ax) + 1 > 30:     # the ellipses stay inside
            for k in ("ellipse", "arc", "outline", "circle", "ring"):
                del cases[k]
        for name, (ref_fn, got_fn) in cases.items():
            assert _same(ref_fn, got_fn), (name, c, ax, ang, s, e, th)


def test_drawing_across_the_border():
    col = (0.3, 0.55, 0.8)
    bad = {"fill_poly": 0, "arc": 0}
    cases = list(_draw_cases(200, -10, 90, 2))
    for c, ax, ang, (s, e), th, pts, p1 in cases:
        assert _same(lambda a: cv2.line(a, c, p1, col, th),
                     lambda a: cvhost.line(a, c, p1, col, th))
        assert _same(lambda a: cv2.circle(a, c, ax[0], col, th),
                     lambda a: cvhost.circle(a, c, ax[0], col, th))
        assert _same(lambda a: cv2.circle(a, c, ax[0], col, -1),
                     lambda a: cvhost.circle(a, c, ax[0], col, -1))
        assert _same(lambda a: cv2.rectangle(a, c, p1, col, -1),
                     lambda a: cvhost.rectangle(a, c, p1, col, -1))
        assert _same(lambda a: cv2.ellipse(a, c, ax, ang, 0, 360, col, -1),
                     lambda a: cvhost.ellipse(a, c, ax, ang, 0, 360, col, -1))
        bad["fill_poly"] += not _same(
            lambda a: cv2.fillPoly(a, [pts], col),
            lambda a: cvhost.fill_poly(a, [pts], col))
        bad["arc"] += not _same(
            lambda a: cv2.ellipse(a, c, ax, ang, s, e, col, -1),
            lambda a: cvhost.ellipse(a, c, ax, ang, s, e, col, -1))
    assert max(bad.values()) <= 0.02 * len(cases), bad


@pytest.mark.parametrize("factor", [2, 4])
def test_lanczos4_integer_downscale_equals_cv2(factor):
    for (h, w, c) in ((128, 128, 3), (64, 96, 3), (48, 48, 1), (256, 64, 3)):
        img = _img(h, w, c)
        if c == 1:
            img = img[..., 0]
        dsize = (w // factor, h // factor)
        assert np.array_equal(
            cvhost.resize(img, dsize, interpolation=cvhost.INTER_LANCZOS4),
            cv2.resize(img, dsize, interpolation=cv2.INTER_LANCZOS4))


@pytest.mark.parametrize("h,w,sigma", [(62, 62, 8.0), (83, 83, 64 / 6),
                                       (104, 104, 80 / 6), (40, 60, 2.5)])
def test_sigma_derived_blur_matches_cv2(h, w, sigma):
    img = RNG.standard_normal((h, w)).astype(np.float32)
    n = int(round(sigma * 8 + 1)) | 1
    assert np.array_equal(cvhost.gaussian_kernel(n, sigma),
                          cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel())
    got = cvhost.gaussian_blur(img, 0, sigma)
    assert np.abs(got - cv2.GaussianBlur(img, (0, 0), sigma)).max() <= 1e-7
