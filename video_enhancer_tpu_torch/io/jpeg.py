"""A JPEG encode and decode round trip in numpy, without a codec.

``jpeg_roundtrip(u8, q)`` returns what
``cv2.imdecode(cv2.imencode(".jpg", u8, [IMWRITE_JPEG_QUALITY, q])[1],
IMREAD_COLOR)`` returns: OpenCV writes a baseline JPEG through
libjpeg-turbo (islow DCT, 4:2:0, the IJG tables scaled to ``q``) and reads
it back with fancy upsampling. The entropy coding is lossless, so only the
lossy steps are reproduced, each with libjpeg-turbo's integer arithmetic:

- the array is BGR (channel 0 blue), converted to YCbCr by ``jccolor.c``'s
  16-bit fixed point;
- chroma is halved both ways by ``jcsample.c`` ``h2v2_downsample``
  (rounding bias 1, 2, 1, 2 along a row) after the rows are padded to an
  even count and the columns to whole MCUs by repeating the edge; each
  plane is padded to whole blocks by repeating its last row and column;
- ``jfdctint.c``'s islow forward DCT, quantised as ``jcdctmgr.c`` does for
  16-bit DCT elements (a reciprocal, a rounding correction and a shift per
  table entry), with ``jcparam.c``'s tables at ``jpeg_quality_scaling(q)``,
  clamped to baseline;
- dequantisation, ``jidctint.c``'s islow inverse DCT and its range limit;
- ``jdsample.c`` ``h2v2_fancy_upsample`` (the first and last chroma rows
  repeated as context) and ``jdcolor.c``'s fixed-point YCbCr to RGB.

Equal to cv2 5 (libjpeg-turbo 3.1.2, whose SIMD paths give its C code's
results) bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["quant_tables", "jpeg_roundtrip"]

_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64).reshape(8, 8)

_SCALEBITS, _CONST_BITS, _PASS1_BITS = 16, 13, 2
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float, bits: int = _SCALEBITS) -> int:
    return int(x * (1 << bits) + 0.5)


# jfdctint.c / jidctint.c constants at CONST_BITS 13
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the luma and
    chroma tables (8, 8) in natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA, _STD_CHROMA))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool, axis: int):
    """One pass of jpeg_fdct_islow along ``axis`` (length 8): the row pass
    (``first``) or the column pass."""
    s = [np.take(d, i, axis=axis) for i in range(8)]
    tmp0, tmp7 = s[0] + s[7], s[0] - s[7]
    tmp1, tmp6 = s[1] + s[6], s[1] - s[6]
    tmp2, tmp5 = s[2] + s[5], s[2] - s[5]
    tmp3, tmp4 = s[3] + s[4], s[3] - s[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
        sh = _CONST_BITS - _PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        sh = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0_541
    out[2] = _descale(z1 + tmp13 * _F0_765, sh)
    out[6] = _descale(z1 - tmp12 * _F1_847, sh)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1_175
    tmp4, tmp5 = tmp4 * _F0_298, tmp5 * _F2_053
    tmp6, tmp7 = tmp6 * _F3_072, tmp7 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, sh)
    out[5] = _descale(tmp5 + z2 + z4, sh)
    out[3] = _descale(tmp6 + z2 + z3, sh)
    out[1] = _descale(tmp7 + z1 + z4, sh)
    return np.stack(out, axis=axis)


def _idct_1d(d, axis, sh):
    """One pass of jpeg_idct_islow along ``axis``, descaled by ``sh``."""
    s = [np.take(d, i, axis=axis) for i in range(8)]
    z1 = (s[2] + s[6]) * _F0_541
    tmp2 = z1 - s[6] * _F1_847
    tmp3 = z1 + s[2] * _F0_765
    tmp0 = (s[0] + s[4]) << _CONST_BITS
    tmp1 = (s[0] - s[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0, t1 = t0 * _F0_298, t1 * _F2_053
    t2, t3 = t2 * _F3_072, t3 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([_descale(o, sh) for o in out], axis=axis)


def _reciprocals(table: np.ndarray):
    """jcdctmgr.c ``compute_reciprocal`` for 16-bit DCT elements, over the
    divisors ``table << 3``: (reciprocal, correction, shift)."""
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, q in enumerate((table.ravel() << 3).tolist()):
        b = q.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, q)
        c = q // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= q // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return (recip.reshape(8, 8), corr.reshape(8, 8), shift.reshape(8, 8))


def _code_plane(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Blocks of one padded plane through the forward DCT, quantisation,
    dequantisation and the inverse DCT; returns the decoded samples."""
    h, w = plane.shape
    blocks = (plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
              .astype(np.int64) - 128)
    coef = _fdct_1d(_fdct_1d(blocks, True, 3), False, 2)
    recip, corr, shift = _reciprocals(table)
    mag = ((np.abs(coef) + corr) * recip) >> shift
    quant = np.where(coef < 0, -mag, mag)
    deq = quant * table
    ws = _idct_1d(deq, 2, _CONST_BITS - _PASS1_BITS)
    out = _idct_1d(ws, 3, _CONST_BITS + _PASS1_BITS + 3)
    # jdmaster.c's post-IDCT range limit, indexed by the value & 1023
    idx = out & 1023
    lut = np.zeros(1024, np.int64)
    lut[:128] = np.arange(128, 256)
    lut[128:512] = 255
    lut[896:] = np.arange(0, 128)
    samples = lut[idx]
    return samples.transpose(0, 2, 1, 3).reshape(h, w)


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _fancy_up(c: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample of a (h, w) chroma plane to (2h, 2w)."""
    c = c.astype(np.int64)
    above = np.concatenate([c[:1], c[:-1]], 0)
    below = np.concatenate([c[1:], c[-1:]], 0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    for v, near in ((0, above), (1, below)):
        col = c * 3 + near                        # this row's column sums
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        even = (col * 3 + left + 8) >> 4
        odd = (col * 3 + right + 7) >> 4
        even[:, 0] = (col[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (col[:, -1] * 4 + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """A (H, W, 3) uint8 BGR image through cv2's JPEG encode and decode at
    ``quality``; (H, W, 3) uint8 BGR."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("jpeg_roundtrip takes (H, W, 3) uint8")
    h, w = img.shape[:2]
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    off = 128 << _SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off + _ONE_HALF - 1) >> _SCALEBITS
    luma_t, chroma_t = quant_tables(quality)

    ch, cw = -(-h // 16) * 8, -(-w // 16) * 8     # chroma blocks' extent
    y_dec = _code_plane(_pad_edge(y, -(-h // 8) * 8, -(-w // 8) * 8),
                        luma_t)[:h, :w]
    bias = np.tile([1, 2], cw // 2)
    planes = []
    for c in (cb, cr):
        full = _pad_edge(c, -(-h // 2) * 2, 2 * cw)
        down = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
                + full[1::2, 1::2] + bias) >> 2
        dec = _code_plane(_pad_edge(down, ch, cw), chroma_t)
        planes.append(_fancy_up(dec[:-(-h // 2), :-(-w // 2)])[:h, :w])
    cb_d, cr_d = planes
    x = np.arange(256) - 128
    cr_r = (_fix(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    red = y_dec + cr_r[cr_d]
    green = y_dec + ((cb_g[cb_d] + cr_g[cr_d]) >> _SCALEBITS)
    blue = y_dec + cb_b[cb_d]
    return np.clip(np.stack([blue, green, red], -1), 0, 255).astype(np.uint8)
