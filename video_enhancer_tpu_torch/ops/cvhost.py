"""OpenCV's image ops on host float32 arrays, in numpy.

The eval data of the JAX package (train/data.py, train/evalgen.py,
train/lpips.py) is made on the host with cv2; these are its counterparts
for a machine without OpenCV. Each follows what cv2 5 (x86-64, AVX-512
dispatch) computes, down to its rounding where that was found:

- ``gaussian_kernel``: ``cv2.getGaussianKernel(n, sigma, CV_32F)`` for
  sigma > 0, the taps in double, normalised in double, then rounded to
  float32.
- ``gaussian_blur`` / ``filter2d``: ``cv2.GaussianBlur(f, (k, k), sigma)``
  and ``cv2.filter2D(f, -1, k)`` with ``BORDER_REFLECT_101``. OpenCV's
  filter engine runs 16 float lanes with fused multiply-adds over each
  row's ``W * C`` values and plain float arithmetic on the tail past the
  last whole vector; both are reproduced (a fused multiply-add as a
  double product and sum rounded once). filter2D sums the non-zero taps in
  row-major order; the separable blur's row pass runs taps in order, its
  column pass (and a 5-tap row pass) the symmetric pairs outward from the
  centre. Equal to cv2 at 7 and 9 taps and for filter2D; at 5 taps (a row
  form not identified) within three float32 ulps.
- ``line``: ``cv2.line(img, p0, p1, value, 1)``, OpenCV's 8-connected
  ``LineIterator`` walked left to right. Exact.
- ``resize``: ``cv2.resize`` of float32 images. A size equal to the
  input's is a copy. ``INTER_NEAREST`` takes ``floor(x * sw / dw)``;
  ``INTER_AREA`` at integer factors sums each block in groups of four
  (halving 1 or 4 channels: two pairs) and scales by ``1 / area`` in
  float32 (exact), at other factors (downscale
  only) weighs the covered cells; ``INTER_LINEAR`` (the default) and
  ``INTER_CUBIC`` (A = -0.75, indices clamped) place each output at
  ``(d + 0.5) * sw / dw - 0.5`` in double, with the weights in float32.
  Linear within one ulp, cubic and area within three.
- ``rotation_matrix_2d``, ``warp_affine`` and ``remap`` with
  ``INTER_LINEAR`` and ``BORDER_REFLECT``: cv2 5's warp kernels invert the
  affine matrix in double, take it in float32, place each output pixel at
  ``fma(M0, x, M1 * y + M2)`` and blend by fused lerps
  ``fma(a, v1 - v0, v0)`` across, then down; remap reads its float maps
  the same way. Exact, at widths a multiple of 16 for warp_affine (the
  last ``w mod 16`` columns of a row take another path in cv2, within
  5e-6 here).
"""

from __future__ import annotations

import numpy as np

__all__ = ["INTER_NEAREST", "INTER_LINEAR", "INTER_CUBIC", "INTER_AREA",
           "INTER_LANCZOS4", "gaussian_kernel", "gaussian_blur", "filter2d",
           "line", "fill_poly", "ellipse", "circle", "rectangle", "resize",
           "rotation_matrix_2d", "warp_affine", "remap"]

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA = 0, 1, 2, 3
INTER_LANCZOS4 = 4

_LANES = 16          # float32 lanes of OpenCV's AVX-512 filter loops
_f32, _f64 = np.float32, np.float64


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in double)."""
    return (np.asarray(a, _f64) * np.asarray(b, _f64)
            + np.asarray(c, _f64)).astype(_f32)


def _reflect101(n: int, idx: np.ndarray) -> np.ndarray:
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def _reflect(n: int, idx: np.ndarray) -> np.ndarray:
    """BORDER_REFLECT: ``fedcba|abcdef|fedcba``."""
    idx = np.mod(idx, 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def _as3(img: np.ndarray) -> tuple[np.ndarray, bool]:
    img = np.asarray(img, _f32)
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _tail_merge(vec: np.ndarray, plain: np.ndarray) -> np.ndarray:
    """Rows of ``W * C`` values: the vector loop's result up to the last
    whole 16-lane vector, the scalar loop's after it."""
    h, w, c = vec.shape
    v = (w * c) // _LANES * _LANES
    out = vec.reshape(h, w * c).copy()
    out[:, v:] = plain.reshape(h, w * c)[:, v:]
    return out.reshape(h, w, c)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t / t.sum()).astype(_f32)


def _row_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    n = len(k)
    r = n // 2
    pad = img[:, _reflect101(w, np.arange(-r, w + r))]
    taps = [pad[:, j:j + w] for j in range(n)]
    if n <= 5:                        # the symmetric small-kernel form
        vec = taps[r] * k[r]
        plain = k[r] * taps[r]
        for j in range(1, r + 1):
            pair = taps[r + j] + taps[r - j]
            vec = _fma(pair, k[r + j], vec)
            plain = plain + k[r + j] * pair
        return _tail_merge(vec, plain)
    vec = np.zeros_like(img)
    plain = np.zeros_like(img)
    for j in range(n):
        vec = _fma(taps[j], k[j], vec)
        plain = plain + taps[j] * k[j]
    return _tail_merge(vec, plain)


def _col_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    h = img.shape[0]
    r = len(k) // 2
    pad = img[_reflect101(h, np.arange(-r, h + r))]

    def row(j):
        return pad[r + j:r + j + h]

    vec = row(0) * k[r]
    plain = k[r] * row(0)
    for j in range(1, r + 1):
        pair = row(j) + row(-j)
        vec = _fma(pair, k[r + j], vec)
        plain = plain + k[r + j] * pair
    return _tail_merge(vec, plain)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)``; ``ksize`` 0 takes
    cv2's size for a float image, ``round(8 * sigma + 1) | 1``."""
    x, flat = _as3(img)
    if ksize <= 0:
        ksize = _cround(sigma * 8 + 1) | 1
    k = gaussian_kernel(ksize, sigma)
    out = _col_pass(_row_pass(x, k), k)
    return out[..., 0] if flat else out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Correlation with ``kernel`` (odd sizes), anchor at its centre."""
    x, flat = _as3(img)
    k = np.asarray(kernel, _f32)
    kh, kw = k.shape
    h, w, _ = x.shape
    ry, rx = kh // 2, kw // 2
    pad = x[_reflect101(h, np.arange(-ry, h + ry))][
        :, _reflect101(w, np.arange(-rx, w + rx))]
    vec = np.zeros_like(x)
    plain = np.zeros_like(x)
    for (i, j) in zip(*np.nonzero(k)):
        tap = pad[i:i + h, j:j + w]
        vec = _fma(tap, k[i, j], vec)
        plain = plain + k[i, j] * tap
    out = _tail_merge(vec, plain)
    return out[..., 0] if flat else out


# -- drawing: OpenCV's drawing.cpp on float images (8-connected) --

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1
# OpenCV's table of sin(0..450 degrees), printed to seven decimals
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(_f32)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img, value):
    c = img.shape[2] if img.ndim == 3 else 1
    v = np.atleast_1d(np.asarray(value, np.float64))
    v = np.concatenate([v, np.zeros(max(c - v.size, 0))])[:c]
    return v.astype(img.dtype)


def _hline(img, color, y, x1, x2):
    if x1 <= x2:
        img[y, x1:x2 + 1] = color


def _put(img, color, x, y):
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's ``clipLine`` (int64 form): the clipped end points and
    whether any of the line lies in the image."""
    if w <= 0 or h <= 0:
        return False, (x1, y1, x2, y2)
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1, x2, y2)


def _line8(img, color, p0, p1):
    """OpenCV's ``Line``: the 8-connected ``LineIterator``, clipped to the
    image and walked left to right."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (p0, p1))
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        ok, (x0, y0, x1, y1) = _clip_line(w, h, x0, y0, x1, y1)
        if not ok:
            return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:
            err += 2 * dx - 2 * dy
            x, y = x + 1, y + sy
        else:
            err -= 2 * dy
            if steep:
                y += sy
            else:
                x += 1


def _line2(img, color, p0, p1):
    """OpenCV's ``Line2``: a line between end points in 1/65536 pixel."""
    h, w = img.shape[:2]
    ok, (x1, y1, x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                      *p0, *p1)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    _put(img, color, (x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT)
    k = np.arange(count + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * step) >> XY_SHIFT
    else:
        xs = (x1 + k * step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _fill_convex(img, color, pts, shift):
    """OpenCV's ``FillConvexPoly`` (8-connected edges)."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = (1 << shift) >> 1
    p0 = pts[-1]
    p0 = (p0[0] << (XY_SHIFT - shift), p0[1] << (XY_SHIFT - shift))
    xs_ = [p[0] for p in pts]
    ys_ = [p[1] for p in pts]
    ymin = min(ys_)
    imin = ys_.index(ymin)
    xmin, xmax, ymax = min(xs_), max(xs_), max(ys_)
    for p in pts:
        q = (p[0] << (XY_SHIFT - shift), p[1] << (XY_SHIFT - shift))
        if shift == 0:
            _line8(img, color, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (q[0] >> XY_SHIFT, q[1] >> XY_SHIFT))
        else:
            _line2(img, color, p0, q)
        p0 = q
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    e_idx = [imin, imin]
    e_di = [1, n - 1]
    e_ye = [ymin, ymin]
    e_x = [-XY_ONE, -XY_ONE]
    e_dx = [0, 0]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                di = e_di[i]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs = pts[idx0][0] << (XY_SHIFT - shift)
                        xe = pts[idx][0] << (XY_SHIFT - shift)
                        e_ye[i] = ty
                        e_dx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            x1 = (e_x[left] + _HALF) >> XY_SHIFT
            x2 = (e_x[right] + _HALF) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, color, y, max(x1, 0), min(x2, w - 1))
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _collect_edges(img, color, pts, shift, edges):
    """OpenCV's ``CollectPolyEdges`` (8-connected, no offset): draws each
    edge and appends ``(y0, y1, x, dx)`` for the non-horizontal ones."""
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    x0 = pts[-1][0] << (XY_SHIFT - shift)
    y0 = (pts[-1][1] + delta) >> shift
    for p in pts:
        x1 = p[0] << (XY_SHIFT - shift)
        y1 = (p[1] + delta) >> shift
        t0 = ((x0 + _HALF) >> XY_SHIFT, y0)
        t1 = ((x1 + _HALF) >> XY_SHIFT, y1)
        _line8(img, color, t0, t1)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0[0] < w and 0 <= t1[0] < w
                and 0 <= t0[1] < h and 0 <= t1[1] < h):
            _, (a, b, c, d) = _clip_line(w, h, *t0, *t1)
            if b != d:
                c0x, c0y, c1x, c1y = a << XY_SHIFT, b, c << XY_SHIFT, d
        if y0 != y1:
            dx = _cdiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
            else:
                edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1


def _fill_edges(img, color, edges):
    """OpenCV's ``FillEdgeCollection``: each row's active edges sorted by
    x and filled in pairs (even-odd)."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y0 = np.array([t[0] for t in edges], np.int64)
    y1 = np.array([t[1] for t in edges], np.int64)
    x = np.array([t[2] for t in edges], np.int64)
    dx = np.array([t[3] for t in edges], np.int64)
    xend = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x.max(), xend.max()) < 0
            or min(x.min(), xend.min()) >= (w << XY_SHIFT)):
        return
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), h)):
        act = (y0 <= y) & (y < y1)
        if act.sum() < 2:
            continue
        xs = np.sort(x[act] + (y - y0[act]) * dx[act])
        for a, b in zip(xs[0::2], xs[1::2]):
            x1 = (int(a) + XY_ONE - 1) >> XY_SHIFT
            x2 = int(b) >> XY_SHIFT
            if x1 < w and x2 >= 0:
                _hline(img, color, y, max(x1, 0), min(x2, w - 1))


def _circle(img, color, center, radius, fill):
    """OpenCV's ``Circle``: the integer midpoint circle, filled or one
    pixel wide."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx,
                                                          cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy,
                                                         cx + dy)):
            if not 0 <= yy < h:
                continue
            if fill:
                if xb >= 0 and xa < w:
                    _hline(img, color, yy, max(xa, 0), min(xb, w - 1))
            else:
                _put(img, color, xa, yy)
                _put(img, color, xb, yy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _cround(v: float) -> int:
    """``cvRound``: to nearest, ties to even."""
    return int(round(v))


def ellipse_points(center, axes, angle: int, arc_start: int, arc_end: int,
                   delta: int):
    """OpenCV's double ``ellipse2Poly``: (x, y) in the units of
    ``center`` and ``axes``."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    alpha, beta = float(_SIN[450 - a]), float(_SIN[a])
    cx, cy = (float(v) for v in center)
    ax, ay = (float(v) for v in axes)
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        t = min(i, arc_end)
        if t < 0:
            t += 360
        x = ax * float(_SIN[450 - t])
        y = ay * float(_SIN[t])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy), (cx, cy)]
    return pts


def _thick_line(img, color, p0, p1, thickness, flags, shift):
    """OpenCV's ``ThickLine`` (8-connected)."""
    p0 = (p0[0] << (XY_SHIFT - shift), p0[1] << (XY_SHIFT - shift))
    p1 = (p1[0] << (XY_SHIFT - shift), p1[1] << (XY_SHIFT - shift))
    if thickness <= 1:
        # cv2 5 rounds the end points to whole pixels, whatever the shift
        _line8(img, color, ((p0[0] + _HALF) >> XY_SHIFT,
                            (p0[1] + _HALF) >> XY_SHIFT),
               ((p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT))
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = _cround(dy * r), _cround(dx * r)
        quad = [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)]
        _fill_convex(img, color, quad, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            _circle(img, color, ((p0[0] + _HALF) >> XY_SHIFT,
                                 (p0[1] + _HALF) >> XY_SHIFT),
                    (thickness + _HALF) >> XY_SHIFT, True)
        p0 = p1


def _ellipse_ex(img, color, center, axes, angle, arc_start, arc_end,
                thickness):
    """OpenCV's ``EllipseEx``: center and axes in 1/65536 pixel."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 \
        else 5
    pts = []
    for fx, fy in ellipse_points(center, axes, angle, arc_start, arc_end,
                                 delta):
        px = _cround(fx / XY_ONE) << XY_SHIFT
        py = _cround(fy / XY_ONE) << XY_SHIFT
        p = (px + _cround(fx - px), py + _cround(fy - py))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [tuple(center), tuple(center)]
    if thickness >= 0:
        _polyline(img, color, pts, False, thickness, XY_SHIFT)
    elif arc_end - arc_start >= 360:
        _fill_convex(img, color, pts, XY_SHIFT)
    else:
        edges = []
        _collect_edges(img, color, pts + [tuple(center)], XY_SHIFT, edges)
        _fill_edges(img, color, edges)


def _polyline(img, color, pts, closed, thickness, shift):
    i = len(pts) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = pts[i]
    for p in pts[(not closed):]:
        _thick_line(img, color, p0, p, thickness, flags, shift)
        p0 = p
        flags = 2


def fill_poly(img, polys, color):
    """``cv2.fillPoly(img, polys, color)`` on a float image, in place:
    integer vertices, 8-connected edges, even-odd fill."""
    color = _color(img, color)
    edges = []
    for pts in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
        _collect_edges(img, color, pts, 0, edges)
    _fill_edges(img, color, edges)
    return img


def ellipse(img, center, axes, angle, start_angle, end_angle, color,
            thickness: int = 1):
    """``cv2.ellipse(img, center, axes, angle, start, end, color,
    thickness)`` on a float image, in place (``thickness < 0`` fills).
    The angles are rounded to whole degrees, as OpenCV does."""
    color = _color(img, color)
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    a = (int(axes[0]) << XY_SHIFT, int(axes[1]) << XY_SHIFT)
    _ellipse_ex(img, color, c, a, _cround(angle), _cround(start_angle),
                _cround(end_angle), thickness)
    return img


def circle(img, center, radius, color, thickness: int = 1):
    """``cv2.circle`` on a float image, in place (``thickness < 0``
    fills). On a float image OpenCV draws ``LINE_AA`` as ``LINE_8``, so
    the line type is not an argument."""
    color = _color(img, color)
    center = (int(center[0]), int(center[1]))
    radius = int(radius)
    if thickness > 1:
        _ellipse_ex(img, color, (center[0] << XY_SHIFT,
                                 center[1] << XY_SHIFT),
                    (radius << XY_SHIFT, radius << XY_SHIFT), 0, 0, 360,
                    thickness)
    else:
        _circle(img, color, center, radius, thickness < 0)
    return img


def rectangle(img, p0, p1, color, thickness: int = 1):
    """``cv2.rectangle(img, p0, p1, color, thickness)`` on a float image,
    in place (``thickness < 0`` fills)."""
    color = _color(img, color)
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (p0, p1))
    pts = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    if thickness >= 0:
        _polyline(img, color, pts, True, thickness, 0)
    else:
        _fill_convex(img, color, pts, 0)
    return img


def line(img, p0, p1, value, thickness: int = 1):
    """``cv2.line(img, p0, p1, value, thickness)`` on a float image, in
    place, and returns the image."""
    color = _color(img, value) if img.ndim == 3 else _f32(value)
    h, w = img.shape[:2]
    m = int(thickness)
    p0, p1 = tuple(int(v) for v in p0), tuple(int(v) for v in p1)
    if m > 1:
        # cv2 5 first clips a thick line to the image grown by its
        # thickness
        ok, (x0, y0, x1, y1) = _clip_line(w + 2 * m, h + 2 * m, p0[0] + m,
                                          p0[1] + m, p1[0] + m, p1[1] + m)
        if not ok:
            return img
        p0, p1 = (x0 - m, y0 - m), (x1 - m, y1 - m)
    _thick_line(img, color, p0, p1, m, 3, 0)
    return img


def _cubic_weights(fx: np.ndarray) -> np.ndarray:
    a = -0.75
    c0 = ((a * (fx + 1) - 5 * a) * (fx + 1) + 8 * a) * (fx + 1) - 4 * a
    c1 = ((a + 2) * fx - (a + 3)) * fx * fx + 1
    c2 = ((a + 2) * (1 - fx) - (a + 3)) * (1 - fx) * (1 - fx) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(_f32)


def _interp_taps(n_in: int, n_out: int, cubic: bool):
    """Source indices ``(n_out, taps)`` and float32 weights."""
    fxd = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fxd).astype(np.int64)
    fx = fxd - sx
    if cubic:
        idx = np.clip(sx[:, None] + np.arange(-1, 3), 0, n_in - 1)
        return idx, _cubic_weights(fx)
    fx = fx.astype(_f32)
    lo, hi = sx < 0, sx >= n_in - 1
    fx[lo | hi] = 0
    sx = np.clip(sx, 0, n_in - 1)
    idx = np.stack([sx, np.minimum(sx + 1, n_in - 1)], -1)
    return idx, np.stack([_f32(1) - fx, fx], -1)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_taps(n_in: int, n_out: int):
    """Source indices ``(n_out, 8)`` (clamped) and OpenCV's float32
    ``interpolateLanczos4`` weights at float32 positions."""
    d = np.arange(n_out)
    fx = ((d + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(_f32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(_f32)).astype(_f32)
    y0 = -(fx + _f32(3)).astype(_f64) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    co = np.empty((n_out, 8), _f32)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        yi = (fx + _f32(3 - i)).astype(_f32)
        y = -yi.astype(_f64) * np.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((cs * s0 + cc * c0) / (y * y)).astype(_f32)
        co[:, i] = np.where(np.abs(yi) >= _f32(1e-6), v, _f32(1e30))
    total = np.zeros(n_out, _f32)
    for i in range(8):
        total = total + co[:, i]
    co = co * (_f32(1) / total)[:, None]
    return np.clip(sx[:, None] + np.arange(-3, 5), 0, n_in - 1), co


def _resize_lanczos4(x: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """cv2's float Lanczos4: the row pass sums its eight taps in order;
    the column pass sums them from the last to the first over the row's
    whole 4-lane vectors and in order on the scalar tail."""
    h, w, c = x.shape
    ix, wx = _lanczos4_taps(w, ow)
    iy, wy = _lanczos4_taps(h, oh)
    rows = np.zeros((h, ow, c), _f32)
    for k in range(8):
        rows = rows + x[:, ix[:, k]] * wx[None, :, k, None]
    taps = [rows[iy[:, k]] * wy[:, k, None, None] for k in range(8)]
    fwd, rev = taps[0], taps[7]
    for k in range(1, 8):
        fwd = fwd + taps[k]
        rev = rev + taps[7 - k]
    v = (ow * c) // 4 * 4
    out = fwd.reshape(oh, ow * c)
    out[:, :v] = rev.reshape(oh, ow * c)[:, :v]
    return out.reshape(oh, ow, c)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` cell coverage of OpenCV's area downscale."""
    scale = n_in / n_out
    wt = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        s1 = int(np.ceil(f1))
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(s1, s2)
        cell = min(scale, n_in - f1)
        if s1 - f1 > 1e-3:
            wt[d, s1 - 1] = (s1 - f1) / cell
        wt[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            wt[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return wt


def _separable(x: np.ndarray, taps_x, taps_y) -> np.ndarray:
    def one(src, idx, wts, axis):
        acc = 0.0
        shape = [1] * src.ndim
        shape[axis] = -1
        for k in range(idx.shape[1]):
            acc = acc + (np.take(src, idx[:, k], axis=axis).astype(_f64)
                         * wts[:, k].reshape(shape).astype(_f64))
        return acc.astype(_f32)

    return one(one(x, *taps_x, 1), *taps_y, 0)


def resize(img: np.ndarray, dsize: tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize=(w, h), interpolation=...)`` of a float32
    ``(H, W)`` or ``(H, W, C)`` image."""
    x, flat = _as3(img)
    h, w = x.shape[:2]
    ow, oh = int(dsize[0]), int(dsize[1])
    if (oh, ow) == (h, w):
        out = x.copy()
    elif interpolation == INTER_NEAREST:
        xi = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
        yi = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
        out = x[yi.astype(np.int64)][:, xi.astype(np.int64)]
    elif interpolation == INTER_AREA:
        if ow > w or oh > h:
            raise NotImplementedError("resize: INTER_AREA upscaling")
        if w % ow == 0 and h % oh == 0:
            sx, sy = w // ow, h // oh
            blocks = x.reshape(oh, sy, ow, sx, -1)
            cells = [blocks[:, i, :, j] for i in range(sy) for j in range(sx)]
            acc = np.zeros_like(cells[0])
            k = 0
            if (sx, sy) == (2, 2) and x.shape[2] in (1, 4):
                # the vector form of 1- and 4-channel halving
                acc = (cells[0] + cells[1]) + (cells[2] + cells[3])
                k = 4
            while k + 4 <= len(cells):
                acc = acc + (((cells[k] + cells[k + 1]) + cells[k + 2])
                             + cells[k + 3])
                k += 4
            for c in cells[k:]:
                acc = acc + c
            out = acc * _f32(1.0 / (sx * sy))
        else:
            wx, wy = _area_weights(w, ow), _area_weights(h, oh)
            out = np.einsum("yh,hxc->yxc", wy,
                            np.einsum("xw,hwc->hxc", wx,
                                      x.astype(_f64))).astype(_f32)
    elif interpolation == INTER_LANCZOS4:
        out = _resize_lanczos4(x, ow, oh)
    elif interpolation in (INTER_LINEAR, INTER_CUBIC):
        cubic = interpolation == INTER_CUBIC
        out = _separable(x, _interp_taps(w, ow, cubic),
                         _interp_taps(h, oh, cubic))
    else:
        raise ValueError(f"resize: unsupported interpolation {interpolation}")
    return out[..., 0] if flat else out


def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in double."""
    m = np.asarray(m, _f64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _bilinear(x: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              border: str = "reflect") -> np.ndarray:
    """cv2 5's linear warp kernel at float32 source coordinates; outside
    the image ``BORDER_REFLECT`` or ``BORDER_CONSTANT`` (zeros)."""
    h, w = x.shape[:2]
    ix = np.floor(sx).astype(np.int64)
    iy = np.floor(sy).astype(np.int64)
    a = (sx - ix.astype(_f32)).astype(_f32)[..., None]
    b = (sy - iy.astype(_f32)).astype(_f32)[..., None]
    if border == "reflect":
        x0, x1 = _reflect(w, ix), _reflect(w, ix + 1)
        y0, y1 = _reflect(h, iy), _reflect(h, iy + 1)
        v00, v01 = x[y0, x0], x[y0, x1]
        v10, v11 = x[y1, x0], x[y1, x1]
    else:
        def tap(yy, xx):
            ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            return np.where(ok, x[np.clip(yy, 0, h - 1),
                                  np.clip(xx, 0, w - 1)], _f32(0))
        v00, v01 = tap(iy, ix), tap(iy, ix + 1)
        v10, v11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma(a, v01 - v00, v00)
    bot = _fma(a, v11 - v10, v10)
    return _fma(b, bot - top, top)


def warp_affine(img: np.ndarray, m: np.ndarray,
                dsize: tuple[int, int], border: str = "reflect"
                ) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT)``; ``border="constant"`` is cv2's default
    ``BORDER_CONSTANT`` with zeros."""
    x, flat = _as3(img)
    mi = _invert_affine(m).astype(_f32)
    ow, oh = int(dsize[0]), int(dsize[1])
    ys, xs = np.mgrid[0:oh, 0:ow].astype(_f32)
    sx = _fma(mi[0, 0], xs, mi[0, 1] * ys + mi[0, 2])
    sy = _fma(mi[1, 0], xs, mi[1, 1] * ys + mi[1, 2])
    out = _bilinear(x, sx, sy, border)
    return out[..., 0] if flat else out


def remap(img: np.ndarray, map_x: np.ndarray,
          map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR,
    borderMode=BORDER_REFLECT)`` with float32 maps."""
    x, flat = _as3(img)
    out = _bilinear(x, np.asarray(map_x, _f32), np.asarray(map_y, _f32))
    return out[..., 0] if flat else out
