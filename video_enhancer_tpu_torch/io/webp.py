"""The lossy WebP round trip that OpenCV makes, in numpy.

``cv2.imencode(".webp", img, [IMWRITE_WEBP_QUALITY, q])`` followed by
``cv2.imdecode`` runs libwebp's simple ``WebPEncodeBGR`` at ``WebPConfig``'s
defaults (method 4, SNS 50, filter strength 60, sharpness 0, 4 segments)
and decodes with fancy chroma upsampling. ``webp_roundtrip`` returns the
decoded image without writing a bitstream, following libwebp's stages:

- RGB -> YUV 4:2:0 (``picture_csp_enc.c``): luma by ``VP8RGBToY``, chroma
  from each 2x2 block averaged in linear light through libwebp's gamma
  tables (gamma 0.80), then ``VP8RGBToU`` / ``VP8RGBToV``; the planes are
  padded to whole macroblocks by repeating their last row and column;
- the analysis pass (``analysis_enc.c``): per macroblock the DCT
  histograms of its DC and TM predictions from the source, the mixed
  susceptibility alpha, k-means into 4 segments, SNS's segment alphas;
- the quantisers (``quant_enc.c``): ``QualityToCompression`` modulated per
  segment by SNS, ``SetupMatrices`` (the VP8 DC/AC tables, libwebp's
  biases and luma sharpening), the UV delta from the mean chroma alpha,
  and each segment's filter strength;
- each macroblock's modes, on the reconstruction so far: the four 16x16
  luma modes, the ten 4x4 modes of every sub-block, the four chroma modes,
  picked by method 4's basic rate-distortion score (``PickBestIntra16``,
  ``PickBestIntra4``, ``PickBestUV``: SSE plus the spectral distortion
  ``TDisto`` times lambda, the flatness rules, the fixed mode costs), with
  the forward DCT / WHT, the quantisation (``QuantizeBlock``) and the
  inverse transforms of ``dsp/enc.c``;
- the chroma DC error diffusion (``CorrectDCValues``) and the raise of a
  segment's filter level for blocky macroblocks (``StoreMaxDelta``,
  ``VP8AdjustFilterStrength``);
- the normal loop filter of ``dsp/dec.c`` at each segment's level (inner
  edges where the macroblock is 4x4-coded or has a non-zero coefficient);
- the fancy upsampler and the fixed-point ``VP8YUVToR/G/B`` of ``yuv.h``.

What is not libwebp's: the rate term of the mode decisions. libwebp counts
the bits of each block's tokens under its coefficient probabilities and
the context-dependent 4x4 mode costs; here a block's rate is a fixed
function of its levels and a 4x4 mode costs a constant per mode. So
the result is close to libwebp's, not equal to it: the tests state the
distance. Channel 0 is blue, as OpenCV sees an image.
"""

from __future__ import annotations

import numpy as np

__all__ = ["webp_roundtrip", "rgb_to_yuv420", "yuv420_to_bgr"]

_i32 = np.int32


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _level_from_delta(delta: int) -> int:
    """``VP8FilterStrengthFromDelta`` at sharpness 0 (its table's first
    row is the identity, up to 63)."""
    return min(max(delta, 0), 63)

# -- colour conversion (picture_csp_enc.c, yuv.h) ----------------------

_YUV_FIX = 16
_YUV_HALF = 1 << (_YUV_FIX - 1)
_GAMMA_FIX, _GAMMA_TAB_FIX = 12, 7
_GAMMA_SCALE = (1 << _GAMMA_FIX) - 1
_GAMMA_TAB_SIZE = 1 << (_GAMMA_FIX - _GAMMA_TAB_FIX)
_GAMMA_TO_LINEAR = (np.power(np.arange(256) / 255.0, 0.80) * _GAMMA_SCALE
                    + 0.5).astype(np.int64)
_LINEAR_TO_GAMMA = (255.0 * np.power(
    np.arange(_GAMMA_TAB_SIZE + 1) * ((1 << _GAMMA_TAB_FIX) / _GAMMA_SCALE),
    1.0 / 0.80) + 0.5).astype(np.int64)


def _linear_to_gamma(v: np.ndarray) -> np.ndarray:
    """A sum of four linear values -> a gamma value at 4x (the ``YUV_FIX +
    2`` scale of ``VP8RGBToU``)."""
    pos = v >> (_GAMMA_TAB_FIX + 2)
    frac = v & ((1 << (_GAMMA_TAB_FIX + 2)) - 1)
    y = (_LINEAR_TO_GAMMA[pos + 1] * frac
         + _LINEAR_TO_GAMMA[pos] * ((1 << (_GAMMA_TAB_FIX + 2)) - frac))
    return (y + (1 << (_GAMMA_TAB_FIX - 1))) >> _GAMMA_TAB_FIX


def _clip_uv(uv: np.ndarray, rounding: int) -> np.ndarray:
    uv = (uv + rounding + (128 << (_YUV_FIX + 2))) >> (_YUV_FIX + 2)
    return np.clip(uv, 0, 255)


def rgb_to_yuv420(bgr: np.ndarray):
    """libwebp's import of an ``(H, W, 3)`` uint8 BGR picture: Y ``(H,
    W)``, U and V ``((H + 1) // 2, (W + 1) // 2)``, int arrays."""
    x = bgr.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + _YUV_HALF
         + (16 << _YUV_FIX)) >> _YUV_FIX
    h, w = y.shape
    xe = np.pad(x, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge")
    lin = _GAMMA_TO_LINEAR[xe]
    s = (lin[0::2, 0::2] + lin[0::2, 1::2] + lin[1::2, 0::2]
         + lin[1::2, 1::2])
    bb, gg, rr = (_linear_to_gamma(s[..., c]) for c in range(3))
    u = _clip_uv(-9719 * rr - 19081 * gg + 28800 * bb, _YUV_HALF << 2)
    v = _clip_uv(28800 * rr - 24116 * gg - 4684 * bb, _YUV_HALF << 2)
    return y.astype(_i32), u.astype(_i32), v.astype(_i32)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~((256 << 6) - 1)) == 0, v >> 6,
                    np.where(v < 0, 0, 255))


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler of one chroma plane to ``(h, w)``."""
    c = c.astype(np.int64)
    # rows: luma row 0 and (for an even height) the last use one chroma
    # row; rows 2k - 1 and 2k lie between chroma rows k - 1 and k
    n = (h + 1) // 2
    top_idx, cur_idx, near_top = [], [], []
    for yy in range(h):
        if yy == 0:
            top_idx.append(0), cur_idx.append(0), near_top.append(True)
        elif yy % 2 == 1:
            k = (yy + 1) // 2
            if k >= n:      # the last row of an even height
                top_idx.append(n - 1), cur_idx.append(n - 1)
            else:
                top_idx.append(k - 1), cur_idx.append(k)
            near_top.append(True)
        else:
            k = yy // 2
            top_idx.append(k - 1), cur_idx.append(k), near_top.append(False)
    t = c[top_idx]
    u = c[cur_idx]
    nt = np.array(near_top)[:, None]
    out = np.empty((h, w), np.int64)
    near, far = np.where(nt, t, u), np.where(nt, u, t)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    last = (w - 1) >> 1
    if last >= 1:
        tl, tt = t[:, :last], t[:, 1:last + 1]
        ll, uv = u[:, :last], u[:, 1:last + 1]
        avg = tl + tt + ll + uv + 8
        d12 = (avg + 2 * (tt + ll)) >> 3
        d03 = (avg + 2 * (tl + uv)) >> 3
        out[:, 1:2 * last:2] = np.where(nt, (d12 + tl) >> 1, (d03 + ll) >> 1)
        out[:, 2:2 * last + 1:2] = np.where(nt, (d03 + tt) >> 1,
                                            (d12 + uv) >> 1)
    if not w & 1:
        out[:, w - 1] = (3 * near[:, last] + far[:, last] + 2) >> 2
    return out


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's decode to BGR: fancy upsampling and ``yuv.h``'s
    fixed-point conversion."""
    h, w = y.shape
    uu, vv = _upsample(u, h, w), _upsample(v, h, w)
    yy = y.astype(np.int64)
    yh = (yy * 19077) >> 8
    r = _clip8(yh + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yh - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yh + ((uu * 33050) >> 8) - 17685)
    return np.stack([b, g, r], -1).astype(np.uint8)


# -- transforms and quantisation (dsp/enc.c, quant_enc.c) ---------------

_ZIGZAG = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
_DC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148,
    151, 154, 157])
_AC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146,
    149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254,
    259, 264, 269, 274, 279, 284])
# x * 155 / 100, at least 8 (the decoder's y2 AC)
_AC_TABLE2 = np.maximum((_AC_TABLE * 101581) >> 16, 8)
_FREQ_SHARPEN = np.array([0, 30, 60, 90, 30, 60, 90, 90, 60, 90, 90, 90,
                          90, 90, 90, 90])
_BIAS = {0: (96, 110), 1: (96, 108), 2: (110, 115)}  # luma AC, y2, chroma
_QFIX = 17
_MAX_LEVEL = 2047
_WEIGHT_Y = np.array([38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4,
                      2])
_COST_I16 = (663, 919, 872, 919)
_COST_UV = (302, 984, 439, 642)
# the rate model's stand-ins for libwebp's context-dependent 4x4 mode
# costs (VP8FixedCostsI4), in 1/256 bit
_COST_I4 = (450, 650, 650, 750, 1100, 1250, 1100, 1250, 1250, 1250)
_FLATNESS_PENALTY = 140


class _Matrix:
    """``VP8Matrix``: per coefficient (raster order) q, iq, bias, zero
    threshold and sharpening, as ``ExpandMatrix`` fills them."""

    def __init__(self, q_dc: int, q_ac: int, kind: int):
        q = np.full(16, q_ac, np.int64)
        q[0] = q_dc
        iq = (1 << _QFIX) // q
        bias = np.full(16, _BIAS[kind][1] << (_QFIX - 8), np.int64)
        bias[0] = _BIAS[kind][0] << (_QFIX - 8)
        self.q, self.iq, self.bias = q, iq, bias
        self.zthresh = ((1 << _QFIX) - 1 - bias) // iq
        self.sharpen = ((_FREQ_SHARPEN * q) >> 11 if kind == 0
                        else np.zeros(16, np.int64))
        self.expand = int((q.sum() + 8) >> 4)

    def quantize(self, coeffs: np.ndarray):
        """``QuantizeBlock``: levels and dequantized coefficients (raster)."""
        sign = coeffs < 0
        mag = np.abs(coeffs) + self.sharpen
        level = np.minimum((mag * self.iq + self.bias) >> _QFIX, _MAX_LEVEL)
        level = np.where(mag > self.zthresh, level, 0)
        level = np.where(sign, -level, level)
        return level, level * self.q


def _fdct(diff: np.ndarray) -> np.ndarray:
    """``FTransform`` of ``(..., 4, 4)`` differences -> ``(..., 16)``."""
    d = diff.astype(np.int64)
    a0 = d[..., 0] + d[..., 3]
    a1 = d[..., 1] + d[..., 2]
    a2 = d[..., 1] - d[..., 2]
    a3 = d[..., 0] - d[..., 3]
    t = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9,
                  (a0 - a1) * 8, (a3 * 2217 - a2 * 5352 + 937) >> 9], -1)
    # t[..., row, u]
    a0 = t[..., 0, :] + t[..., 3, :]
    a1 = t[..., 1, :] + t[..., 2, :]
    a2 = t[..., 1, :] - t[..., 2, :]
    a3 = t[..., 0, :] - t[..., 3, :]
    out = np.stack([(a0 + a1 + 7) >> 4,
                    ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0),
                    (a0 - a1 + 7) >> 4,
                    (a3 * 2217 - a2 * 5352 + 51000) >> 16], -2)
    return out.reshape(out.shape[:-2] + (16,))


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(ref: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """``ITransform``: ``ref (..., 4, 4)`` plus the inverse of ``coeffs
    (..., 16)``, clipped to 8 bits."""
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).astype(np.int64)
    # vertical pass: columns of the coefficient matrix
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    dd = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    tmp = np.stack([a + dd, b + cc, b - cc, a - dd], -2)   # [row, col]
    dc = tmp[..., :, 0] + 4
    a = dc + tmp[..., :, 2]
    b = dc - tmp[..., :, 2]
    cc = _mul2(tmp[..., :, 1]) - _mul1(tmp[..., :, 3])
    dd = _mul1(tmp[..., :, 1]) + _mul2(tmp[..., :, 3])
    res = np.stack([a + dd, b + cc, b - cc, a - dd], -1) >> 3
    return np.clip(ref + res, 0, 255)


def _fwht(dc: np.ndarray) -> np.ndarray:
    """``FTransformWHT`` of ``(..., 4, 4)`` DC coefficients -> ``(...,
    16)``."""
    d = dc.astype(np.int64)
    a0 = d[..., 0] + d[..., 2]
    a1 = d[..., 1] + d[..., 3]
    a2 = d[..., 1] - d[..., 3]
    a3 = d[..., 0] - d[..., 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], -1)
    a0 = t[..., 0, :] + t[..., 2, :]
    a1 = t[..., 1, :] + t[..., 3, :]
    a2 = t[..., 1, :] - t[..., 3, :]
    a3 = t[..., 0, :] - t[..., 2, :]
    out = np.stack([(a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1,
                    (a0 - a1) >> 1], -2)
    return out.reshape(out.shape[:-2] + (16,))


def _iwht(c: np.ndarray) -> np.ndarray:
    """``TransformWHT``: ``(..., 16)`` -> ``(..., 4, 4)`` block DCs."""
    x = c.reshape(c.shape[:-1] + (4, 4)).astype(np.int64)
    a0 = x[..., 0, :] + x[..., 3, :]
    a1 = x[..., 1, :] + x[..., 2, :]
    a2 = x[..., 1, :] - x[..., 2, :]
    a3 = x[..., 0, :] - x[..., 3, :]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -2)
    dc = t[..., :, 0] + 3
    a0 = dc + t[..., :, 3]
    a1 = t[..., :, 1] + t[..., :, 2]
    a2 = t[..., :, 1] - t[..., :, 2]
    a3 = dc - t[..., :, 3]
    return np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
                     (a3 - a2) >> 3], -1)


def _blocks(x: np.ndarray) -> np.ndarray:
    """``(..., 4a, 4b)`` -> ``(..., a * b, 4, 4)`` in raster order."""
    *lead, h, w = x.shape
    y = x.reshape(*lead, h // 4, 4, w // 4, 4)
    y = np.moveaxis(y, -3, -2)
    return y.reshape(*lead, (h // 4) * (w // 4), 4, 4)


def _unblocks(x: np.ndarray, h: int, w: int) -> np.ndarray:
    *lead, _, _, _ = x.shape
    y = x.reshape(*lead, h // 4, w // 4, 4, 4)
    y = np.moveaxis(y, -2, -3)
    return y.reshape(*lead, h, w)


def _tdisto(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``Disto4x4`` summed over the blocks of ``(..., n, 4, 4)``."""
    def tt(x):
        x = x.astype(np.int64)
        a0 = x[..., 0] + x[..., 2]
        a1 = x[..., 1] + x[..., 3]
        a2 = x[..., 1] - x[..., 3]
        a3 = x[..., 0] - x[..., 2]
        t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], -1)
        a0 = t[..., 0, :] + t[..., 2, :]
        a1 = t[..., 1, :] + t[..., 3, :]
        a2 = t[..., 1, :] - t[..., 3, :]
        a3 = t[..., 0, :] - t[..., 2, :]
        bb = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], -2)
        return (np.abs(bb) * _WEIGHT_Y.reshape(4, 4)).sum((-2, -1))
    return (np.abs(tt(b) - tt(a)) >> 5).sum(-1)


def _rate(levels: np.ndarray, first: int = 0) -> np.ndarray:
    """The rate model, in 1/256 bit: per block of ``(..., 16)`` raster
    levels, the coded zigzag run up to the last non-zero level (a zero
    ~0.6 bit, a level ~2 bits plus 1.5 a doubling, with its sign) and an
    end of block."""
    z = np.abs(levels[..., _ZIGZAG[first:]])
    nz = z > 0
    pos = np.arange(z.shape[-1])
    last = np.where(nz.any(-1), (nz * (pos + 1)).max(-1), 0)
    coded = pos < last[..., None]
    cost = np.where(nz, 512 + 384 * np.log2(1 + z), 150.0) * coded
    return (cost.sum(-1) + 100).sum(-1)


def _mult8(a: int, b):
    return (a * b + 128) >> 8


def _is_flat(levels: np.ndarray, thresh: int) -> np.ndarray:
    """``IsFlat`` over the blocks of ``(..., n, 16)``: at most ``thresh``
    non-zero AC levels in all."""
    return (levels[..., 1:] != 0).sum((-2, -1)) <= thresh


# -- predictions -------------------------------------------------------

def _pred16(top, left, tl, size):
    """DC, TM, V and H predictions ``(4, size, size)`` of one block from
    its top row and left column (None at the picture's edge)."""
    shift = 5 if size == 16 else 4
    if top is not None and left is not None:
        dc = (top.sum() + left.sum() + size) >> shift
    elif top is not None:
        dc = (2 * top.sum() + size) >> shift
    elif left is not None:
        dc = (2 * left.sum() + size) >> shift
    else:
        dc = 128
    p = np.empty((4, size, size), np.int64)
    p[0] = dc
    if left is not None and top is not None:
        p[1] = np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    elif left is not None:
        p[1] = left[:, None]
    elif top is not None:
        p[1] = top[None, :]
    else:
        p[1] = 129
    p[2] = top[None, :] if top is not None else 127
    p[3] = left[:, None] if left is not None else 129
    return p


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(top8, left4, x):
    """The ten 4x4 predictions ``(10, 4, 4)`` (``dsp/enc.c`` Intra4Preds)
    from the top row with its top-right (8), the left column (4) and the
    top-left sample."""
    A, B, C, D, E, F, G, H = (int(v) for v in top8)
    I, J, K, L = (int(v) for v in left4)
    X = int(x)
    p = np.empty((10, 4, 4), np.int64)
    p[0] = (sum(top8[:4]) + sum(left4) + 4) >> 3
    p[1] = np.clip(np.asarray(top8[:4])[None, :] + np.asarray(left4)[:, None]
                   - X, 0, 255)
    p[2] = np.array([_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                     _avg3(C, D, E)])[None, :]
    p[3] = np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                     _avg3(K, L, L)])[:, None]
    # RD (dst[row][col])
    rd = {3: _avg3(J, K, L), 2: _avg3(I, J, K), 1: _avg3(X, I, J),
          0: _avg3(A, X, I), -1: _avg3(B, A, X), -2: _avg3(C, B, A),
          -3: _avg3(D, C, B)}
    p[4] = np.array([[rd[r - c] for c in range(4)] for r in range(4)])
    vr = np.empty((4, 4), np.int64)
    vr[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
    vr[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)]
    vr[2] = [_avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C)]
    vr[3] = [_avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
    p[5] = vr
    ld = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
          _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
    p[6] = np.array([[ld[r + c] for c in range(4)] for r in range(4)])
    vl = np.empty((4, 4), np.int64)
    vl[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
    vl[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)]
    vl[2] = [_avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G)]
    vl[3] = [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]
    p[7] = vl
    hd = np.empty((4, 4), np.int64)
    hd[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
    hd[1] = [_avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A)]
    hd[2] = [_avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X)]
    hd[3] = [_avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    p[8] = hd
    hu = np.empty((4, 4), np.int64)
    hu[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)]
    hu[1] = [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)]
    hu[2] = [_avg2(K, L), _avg3(K, L, L), L, L]
    hu[3] = [L, L, L, L]
    p[9] = hu
    return p


# -- analysis and segments (analysis_enc.c) -----------------------------

def _alpha(coeffs: np.ndarray) -> np.ndarray:
    """``GetAlpha`` of the histogram of ``(..., blocks, 16)`` coeffs."""
    bins = np.minimum(np.abs(coeffs) >> 3, 31)
    lead = bins.shape[:-2]
    flat = bins.reshape(-1, bins.shape[-2] * 16)
    dist = np.zeros((flat.shape[0], 32), np.int64)
    np.add.at(dist, (np.arange(flat.shape[0])[:, None], flat), 1)
    maxv = dist.max(-1)
    last = np.where(dist > 0, np.arange(32), 0).max(-1)
    alpha = np.where(maxv > 1, 510 * last // np.maximum(maxv, 1), 0)
    return alpha.reshape(lead)


def _analyse(yp, up, vp, mbw, mbh):
    """Per-macroblock mixed alpha and chroma alpha from the source."""
    alphas = np.zeros((mbh, mbw), np.int64)
    uv_alphas = np.zeros((mbh, mbw), np.int64)
    for my in range(mbh):
        for mx in range(mbw):
            y0, x0 = 16 * my, 16 * mx
            src = yp[y0:y0 + 16, x0:x0 + 16]
            top = yp[y0 - 1, x0:x0 + 16] if my else None
            left = yp[y0:y0 + 16, x0 - 1] if mx else None
            tl = (yp[y0 - 1, x0 - 1] if my else 127) if mx else 0
            pred = _pred16(top, left, tl, 16)[:2]
            co = _fdct(_blocks(src[None] - pred))
            best = int(_alpha(co).max())
            c0, c1 = 8 * my, 8 * mx
            uvs, preds = [], []
            for pl in (up, vp):
                s = pl[c0:c0 + 8, c1:c1 + 8]
                t = pl[c0 - 1, c1:c1 + 8] if my else None
                lf = pl[c0:c0 + 8, c1 - 1] if mx else None
                tlc = (pl[c0 - 1, c1 - 1] if my else 127) if mx else 0
                uvs.append(s)
                preds.append(_pred16(t, lf, tlc, 8)[:2])
            co = np.concatenate([_fdct(_blocks(s[None] - p))
                                 for s, p in zip(uvs, preds)], axis=1)
            best_uv = int(_alpha(co).max())
            mixed = (3 * best + best_uv + 2) >> 2
            alphas[my, mx] = min(max(255 - mixed, 0), 255)
            uv_alphas[my, mx] = best_uv
    return alphas, uv_alphas


def _segments(alphas: np.ndarray, nb: int = 4):
    """``AssignSegments``: k-means of the alpha histogram into ``nb``
    centres; the segment of each macroblock, the centres and the weighted
    average."""
    hist = np.bincount(alphas.ravel(), minlength=256)
    nzi = np.nonzero(hist)[0]
    min_a, max_a = int(nzi[0]), int(nzi[-1])
    rng_a = max_a - min_a
    centers = [min_a + (n * rng_a) // (2 * nb) for n in range(1, 2 * nb, 2)]
    amap = np.zeros(256, np.int64)
    weighted = 0
    for _ in range(6):
        accum = [0] * nb
        dist = [0] * nb
        n = 0
        for a in range(min_a, max_a + 1):
            if hist[a]:
                while n + 1 < nb and abs(a - centers[n + 1]) < abs(
                        a - centers[n]):
                    n += 1
                amap[a] = n
                dist[n] += a * int(hist[a])
                accum[n] += int(hist[a])
        displaced = weighted = total = 0
        for n in range(nb):
            if accum[n]:
                new = (dist[n] + accum[n] // 2) // accum[n]
                displaced += abs(centers[n] - new)
                centers[n] = new
                weighted += new * accum[n]
                total += accum[n]
        weighted = (weighted + total // 2) // total
        if displaced < 5:
            break
    return amap[alphas], centers, weighted


# -- the loop filter (dsp/dec.c) ---------------------------------------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _filter_edge(seg: np.ndarray, thresh: int, ithresh: int, hev_t: int,
                 outer: bool) -> None:
    """One edge across ``seg (n, 8)`` (p3 p2 p1 p0 | q0 q1 q2 q3), in
    place: ``FilterLoop26`` on a macroblock edge, ``FilterLoop24``
    inside."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, i].astype(np.int64)
                                      for i in range(8))
    t2 = 2 * thresh + 1
    need = ((4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t2)
    need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
             & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
             & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
    if not need.any():
        return
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    # DoFilter2 (high edge variance)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    f2 = (np.clip(p0 + a2, 0, 255), np.clip(q0 - a1, 0, 255))
    out = [p2, p1, p0, q0, q1, q2]
    if outer:   # DoFilter6
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        b1 = (27 * a + 63) >> 7
        b2 = (18 * a + 63) >> 7
        b3 = (9 * a + 63) >> 7
        f = [np.clip(p2 + b3, 0, 255), np.clip(p1 + b2, 0, 255),
             np.clip(p0 + b1, 0, 255), np.clip(q0 - b1, 0, 255),
             np.clip(q1 - b2, 0, 255), np.clip(q2 - b3, 0, 255)]
    else:       # DoFilter4
        a = 3 * (q0 - p0)
        b1 = _sclip2((a + 4) >> 3)
        b2 = _sclip2((a + 3) >> 3)
        b3 = (b1 + 1) >> 1
        f = [p2, np.clip(p1 + b3, 0, 255), np.clip(p0 + b2, 0, 255),
             np.clip(q0 - b1, 0, 255), np.clip(q1 - b3, 0, 255), q2]
    for i in range(6):
        v = np.where(hev, out[i], f[i])
        if i == 2:
            v = np.where(hev, f2[0], v)
        elif i == 3:
            v = np.where(hev, f2[1], v)
        out[i] = np.where(need, v, out[i])
    seg[:, 1:7] = np.stack(out, -1)


def _loop_filter(planes, info, levels):
    """The normal filter over every macroblock in decoding order."""
    yp, up, vp = planes
    mbh, mbw = info["segment"].shape
    for my in range(mbh):
        for mx in range(mbw):
            level = levels[info["segment"][my, mx]]
            if level == 0:
                continue
            ilevel = max(level, 1)
            limit = 2 * level + ilevel
            hev_t = 2 if level >= 40 else 1 if level >= 15 else 0
            inner = bool(info["i4"][my, mx] or info["nz"][my, mx])
            for plane, n in ((yp, 16), (up, 8), (vp, 8)):
                r0, c0 = n * my, n * mx
                if mx > 0:
                    _filter_edge(plane[r0:r0 + n, c0 - 4:c0 + 4],
                                 limit + 4, ilevel, hev_t, True)
                if inner:
                    for e in range(4, n, 4):
                        _filter_edge(plane[r0:r0 + n, c0 + e - 4:c0 + e + 4],
                                     limit, ilevel, hev_t, False)
                if my > 0:
                    _filter_edge(plane[r0 - 4:r0 + 4, c0:c0 + n].T,
                                 limit + 4, ilevel, hev_t, True)
                if inner:
                    for e in range(4, n, 4):
                        _filter_edge(plane[r0 + e - 4:r0 + e + 4,
                                           c0:c0 + n].T,
                                     limit, ilevel, hev_t, False)


# -- the encoder ---------------------------------------------------------

def _segment_params(quality: float, seg_alpha, uv_alpha: int,
                    seg_beta):
    """``VP8SetSegmentParams`` and ``SetupFilterStrength`` at SNS 50,
    filter strength 60, sharpness 0: per segment the quantiser index and
    the filter level, and the chroma quantiser deltas."""
    sns = 50
    amp = 0.9 * sns / 100.0 / 128.0
    c = quality / 100.0
    c_base = (c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0) ** (1 / 3.0)
    quants = []
    for a in seg_alpha:
        q = int(127.0 * (1.0 - c_base ** (1.0 - amp * a)))
        quants.append(min(max(q, 0), 127))
    dq_uv_ac = _cdiv((uv_alpha - 64) * (6 - (-4)), 100 - 30)
    dq_uv_ac = min(max(_cdiv(dq_uv_ac * sns, 100), -4), 6)
    dq_uv_dc = min(max(_cdiv(-4 * sns, 100), -15), 15)
    levels = []
    for q, beta in zip(quants, seg_beta):
        base = _level_from_delta(int(_AC_TABLE[q]) >> 2)
        f = base * 5 * 60 // (256 + beta)
        levels.append(0 if f < 2 else min(f, 63))
    return quants, levels, dq_uv_dc, dq_uv_ac


class _Segment:
    def __init__(self, q: int, dq_uv_dc: int, dq_uv_ac: int):
        self.y1 = _Matrix(int(_DC_TABLE[q]), int(_AC_TABLE[q]), 0)
        self.y2 = _Matrix(int(_DC_TABLE[q]) * 2, int(_AC_TABLE2[q]), 1)
        self.uv = _Matrix(int(_DC_TABLE[min(max(q + dq_uv_dc, 0), 117)]),
                          int(_AC_TABLE[min(max(q + dq_uv_ac, 0), 127)]), 2)
        q_i4, q_i16, q_uv = self.y1.expand, self.y2.expand, self.uv.expand
        self.lambda_i4 = max((3 * q_i4 * q_i4) >> 7, 1)
        self.lambda_i16 = max(3 * q_i16 * q_i16, 1)
        self.lambda_uv = max((3 * q_uv * q_uv) >> 6, 1)
        self.lambda_mode = max((q_i4 * q_i4) >> 7, 1)
        self.tlambda = (50 * q_i4) >> 5
        self.min_disto = 20 * int(self.y1.q[0])
        self.max_edge = 0


def _recon_i16(src, preds, seg):
    """``ReconstructIntra16`` for each prediction of ``preds (m, 16,
    16)``: reconstructions, y2 levels, AC levels."""
    co = _fdct(_blocks(src[None] - preds))           # (m, 16, 16)
    dc_lv, dc_dq = seg.y2.quantize(_fwht(co[..., 0].reshape(-1, 4, 4)))
    co = co.copy()
    co[..., 0] = 0
    ac_lv, ac_dq = seg.y1.quantize(co)
    ac_dq[..., 0] = _iwht(dc_dq).reshape(-1, 16)
    rec = _idct(_blocks(preds), ac_dq)
    return _unblocks(rec, 16, 16), dc_lv, ac_lv


def _score(rate, disto, lam):
    return rate * lam + 256 * disto


def _quantize_single(v, m: _Matrix):
    """``QuantizeSingle``: a DC quantized alone, and its error halved."""
    sign = v < 0
    mag = np.abs(v)
    qv = ((mag * m.iq[0] + m.bias[0]) >> _QFIX) * m.q[0]
    keep = mag > m.zthresh[0]
    err = np.where(keep, mag - qv, mag)
    return (np.where(keep, np.where(sign, -qv, qv), 0),
            np.where(sign, -err, err) >> 1)


def _diffuse_dc(co, m: _Matrix, top, left):
    """``CorrectDCValues``: the chroma DCs of ``co (modes, 2, 4, 16)``
    moved by the quantisation errors diffused from the blocks above and to
    the left (7/16 down, 8/16 right), in place; returns each mode's
    (err1, err2, err3) per channel."""
    c = co[..., 0]
    c[..., 0] += (7 * top[:, 0] + 8 * left[:, 0]) >> 3
    c[..., 0], e0 = _quantize_single(c[..., 0], m)
    c[..., 1] += (7 * top[:, 1] + 8 * e0) >> 3
    c[..., 1], e1 = _quantize_single(c[..., 1], m)
    c[..., 2] += (7 * e0 + 8 * left[:, 1]) >> 3
    c[..., 2], e2 = _quantize_single(c[..., 2], m)
    c[..., 3] += (7 * e1 + 8 * e2) >> 3
    c[..., 3], e3 = _quantize_single(c[..., 3], m)
    co[..., 0] = c
    return e1, e2, e3


def _encode_mb(src_y, src_u, src_v, ry, ru, rv, mx, my, mbw, seg, derr):
    """One macroblock's modes and reconstruction, written into the
    reconstruction planes; returns (is_i4, any non-zero level)."""
    y0, x0 = 16 * my, 16 * mx
    top = ry[y0 - 1, x0:x0 + 16] if my else None
    left = ry[y0:y0 + 16, x0 - 1] if mx else None
    tl = ry[y0 - 1, x0 - 1] if (my and mx) else (127 if mx else 129)
    preds = _pred16(top, left, tl, 16)
    recs, dc_lv, ac_lv = _recon_i16(src_y, preds, seg)
    d = ((recs - src_y[None]) ** 2).sum((-2, -1))
    sd = (_mult8(seg.tlambda, _tdisto(_blocks(src_y)[None], _blocks(recs)))
          if seg.tlambda else np.zeros(4, np.int64))
    rate = _rate(dc_lv) + _rate(ac_lv, first=1)
    flat_src = bool((src_y == src_y[0, 0]).all())
    best = None
    for m in range(4):
        dm, sdm = int(d[m]), int(sd[m])
        if flat_src and bool(_is_flat(ac_lv[m], 0)):
            dm, sdm = 2 * dm, 2 * sdm
        sc = _score(rate[m] + _COST_I16[m], dm + sdm, seg.lambda_i16)
        if best is None or sc < best[0]:
            best = (sc, m, dm, sdm, rate[m] + _COST_I16[m])
    _, m16, d16, sd16, r16 = best
    nz16 = bool(dc_lv[m16].any() or ac_lv[m16].any())
    if dc_lv[m16].any() and not ac_lv[m16].any() and d16 > seg.min_disto:
        # StoreMaxDelta: a blocky (DC-only) macroblock with a high
        # distortion raises its segment's filter level at the end
        edge = int(np.abs(dc_lv[m16][[1, 4, 5]]).max())
        seg.max_edge = max(seg.max_edge, edge)
    score16 = _score(r16, d16 + sd16, seg.lambda_mode)
    rec_y = recs[m16]
    is_i4 = False

    # PickBestIntra4
    blk_rec = np.zeros((16, 16), np.int64)
    total = _score(211, 0, seg.lambda_mode)
    nz4 = False
    ok = True
    for n in range(16):
        r, c = divmod(n, 4)
        by, bx = y0 + 4 * r, x0 + 4 * c

        def px(yy, xx):
            # reconstructed sample: inside this macroblock from the 4x4
            # blocks done so far, outside from the planes (127 above the
            # picture, 129 left of it)
            if yy < 0:
                return 127
            if xx < 0:
                return 129
            if y0 <= yy < y0 + 16 and x0 <= xx < x0 + 16:
                return int(blk_rec[yy - y0, xx - x0])
            return int(ry[yy, xx])

        topv = [px(by - 1, bx + i) for i in range(4)]
        if c < 3:
            tr = [px(by - 1, bx + 4 + i) for i in range(4)]
        elif mx < mbw - 1:
            tr = [px(y0 - 1, x0 + 16 + i) for i in range(4)]
        else:
            tr = [px(y0 - 1, x0 + 15)] * 4
        leftv = [px(by + i, bx - 1) for i in range(4)]
        if by - 1 < 0:
            xv = 127
        elif bx - 1 < 0:
            xv = 129
        else:
            xv = px(by - 1, bx - 1)
        p4 = _pred4(topv + tr, leftv, xv)
        s4 = src_y[4 * r:4 * r + 4, 4 * c:4 * c + 4]
        lv, dq = seg.y1.quantize(_fdct(s4[None] - p4))
        rec = _idct(p4, dq)
        d4 = ((rec - s4[None]) ** 2).sum((-2, -1))
        sd4 = (_mult8(seg.tlambda, _tdisto(s4[None, None], rec[:, None]))
               if seg.tlambda else np.zeros(10, np.int64))
        flat = (lv[:, 1:] != 0).sum(-1) <= 3
        rt = _rate(lv[:, None, :]) + np.where(
            (np.arange(10) > 0) & flat, _FLATNESS_PENALTY, 0)
        h4 = np.array(_COST_I4)
        sc = _score(rt + h4, d4 + sd4, seg.lambda_i4)
        m4 = int(np.argmin(sc))
        total += _score(int(rt[m4] + h4[m4]), int(d4[m4] + sd4[m4]),
                        seg.lambda_mode)
        if total >= score16:
            ok = False
            break
        blk_rec[4 * r:4 * r + 4, 4 * c:4 * c + 4] = rec[m4]
        nz4 |= bool(lv[m4].any())
    if ok:
        is_i4 = True
        rec_y = blk_rec
    ry[y0:y0 + 16, x0:x0 + 16] = rec_y
    nz = nz4 if is_i4 else nz16

    # PickBestUV
    c0, c1 = 8 * my, 8 * mx
    srcs = np.stack([src_u, src_v])
    preds = []
    for pl in (ru, rv):
        t = pl[c0 - 1, c1:c1 + 8] if my else None
        lf = pl[c0:c0 + 8, c1 - 1] if mx else None
        tlc = pl[c0 - 1, c1 - 1] if (my and mx) else (127 if mx else 129)
        preds.append(_pred16(t, lf, tlc, 8))
    preds = np.stack(preds, 1)                       # (4, 2, 8, 8)
    co = _fdct(_blocks(srcs[None] - preds))
    e1, e2, e3 = _diffuse_dc(co, seg.uv, derr["top"][mx], derr["left"])
    lv, dq = seg.uv.quantize(co)
    rec = _unblocks(_idct(_blocks(preds), dq), 8, 8)
    d = ((rec - srcs[None]) ** 2).sum((-3, -2, -1))
    lv8 = lv.reshape(4, 8, 16)
    rt = _rate(lv8) + np.where((np.arange(4) > 0) & _is_flat(lv8, 2),
                               _FLATNESS_PENALTY * 8, 0)
    sc = _score(rt + np.array(_COST_UV), d, seg.lambda_uv)
    muv = int(np.argmin(sc))
    # StoreDiffusionErrors
    left = (3 * e3[muv]) >> 2
    derr["left"] = np.stack([e1[muv], left], -1)
    derr["top"][mx] = np.stack([e2[muv], e3[muv] - left], -1)
    ru[c0:c0 + 8, c1:c1 + 8] = rec[muv, 0]
    rv[c0:c0 + 8, c1:c1 + 8] = rec[muv, 1]
    nz |= bool(lv8[muv].any())
    return is_i4, nz


def webp_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".webp", img, [IMWRITE_WEBP_QUALITY,
    quality])[1], IMREAD_COLOR)`` of an ``(H, W, 3)`` uint8 image, channel
    0 taken as blue, as OpenCV takes it (module docstring)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    quality = float(min(max(quality, 1), 100))
    y, u, v = rgb_to_yuv420(img)
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    yp = np.pad(y, ((0, 16 * mbh - h), (0, 16 * mbw - w)), mode="edge")
    uh, uw = u.shape
    up = np.pad(u, ((0, 8 * mbh - uh), (0, 8 * mbw - uw)), mode="edge")
    vp = np.pad(v, ((0, 8 * mbh - uh), (0, 8 * mbw - uw)), mode="edge")
    yp, up, vp = (p.astype(np.int64) for p in (yp, up, vp))

    alphas, uv_alphas = _analyse(yp, up, vp, mbw, mbh)
    seg_map, centers, mid = _segments(alphas)
    lo, hi = min(centers), max(centers)
    if hi == lo:
        hi = lo + 1
    seg_alpha = [min(max(_cdiv(255 * (cc - mid), hi - lo), -127), 127)
                 for cc in centers]
    seg_beta = [min(max(_cdiv(255 * (cc - lo), hi - lo), 0), 255)
                for cc in centers]
    uv_alpha = int(uv_alphas.sum()) // (mbw * mbh)
    quants, levels, dq_uv_dc, dq_uv_ac = _segment_params(
        quality, seg_alpha, uv_alpha, seg_beta)
    segs = [_Segment(q, dq_uv_dc, dq_uv_ac) for q in quants]

    ry = np.zeros_like(yp)
    ru = np.zeros_like(up)
    rv = np.zeros_like(vp)
    info = {"segment": seg_map, "i4": np.zeros((mbh, mbw), bool),
            "nz": np.zeros((mbh, mbw), bool)}
    derr = {"top": np.zeros((mbw, 2, 2), np.int64)}
    for my in range(mbh):
        derr["left"] = np.zeros((2, 2), np.int64)
        for mx in range(mbw):
            s = segs[seg_map[my, mx]]
            i4, nz = _encode_mb(
                yp[16 * my:16 * my + 16, 16 * mx:16 * mx + 16],
                up[8 * my:8 * my + 8, 8 * mx:8 * mx + 8],
                vp[8 * my:8 * my + 8, 8 * mx:8 * mx + 8],
                ry, ru, rv, mx, my, mbw, s, derr)
            info["i4"][my, mx], info["nz"][my, mx] = i4, nz
    # VP8AdjustFilterStrength
    levels = [max(lv, _level_from_delta((sg.max_edge * int(sg.y2.q[1])) >> 3))
              for lv, sg in zip(levels, segs)]
    _loop_filter((ry, ru, rv), info, levels)
    return yuv420_to_bgr(ry[:h, :w], ru[:uh, :uw], rv[:uh, :uw])
