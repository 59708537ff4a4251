"""Colour conversion as OpenCV computes it, without OpenCV.

``rgb_to_gray`` is cv2's ``COLOR_RGB2GRAY`` of uint8 frames in its fixed
point (OpenCV 5): the (R, G, B) weights over 2 ** 15, equal to cv2 on all
2 ** 24 colours. The quality gate of scale-1 models
(runtime/vsr_handler.py ``window_quality``), the temporal stage's optical
flow (ops/optflow.py) and the face quality score
(runtime/face_handler.py) read their gray images through it.

``rgb_to_ycrcb`` is cv2's ``COLOR_RGB2YCrCb`` of uint8 frames in its 14-bit
fixed point, which the skin-blob face detector reads
(video_enhancer_tpu/analysis/faces.py:104), equal to cv2 on all 2 ** 24
colours.
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray", "rgb_to_ycrcb"]

_GRAY_WEIGHTS = (9798, 19235, 3735)
_GRAY_SHIFT = 15


def rgb_to_gray(frame_u8: torch.Tensor) -> torch.Tensor:
    """cv2's ``COLOR_RGB2GRAY`` of a uint8 ``(..., 3)`` frame, in its
    fixed point: ``(9798 R + 19235 G + 3735 B + 2 ** 14) >> 15``, int32."""
    r, g, b = frame_u8.int().unbind(-1)
    wr, wg, wb = _GRAY_WEIGHTS
    return (r * wr + g * wg + b * wb + (1 << (_GRAY_SHIFT - 1))) \
        >> _GRAY_SHIFT


# Y's (R, G, B) weights, then Cr's and Cb's, over 2 ** 14
_YCRCB_WEIGHTS = (4899, 9617, 1868, 11682, 9241)
_YCRCB_SHIFT = 14


def rgb_to_ycrcb(frame_u8: torch.Tensor) -> torch.Tensor:
    """cv2's ``COLOR_RGB2YCrCb`` of a uint8 ``(..., 3)`` frame in its fixed
    point, as int32 ``(..., 3)``: Y as ``rgb_to_gray`` computes it at 14
    bits, ``Cr = (R - Y) 11682 + 128 * 2 ** 14`` and ``Cb = (B - Y) 9241 +
    128 * 2 ** 14``, each descaled with rounding and clamped to uint8."""
    r, g, b = frame_u8.int().unbind(-1)
    wr, wg, wb, wcr, wcb = _YCRCB_WEIGHTS
    half = 1 << (_YCRCB_SHIFT - 1)
    delta = 128 << _YCRCB_SHIFT
    y = (r * wr + g * wg + b * wb + half) >> _YCRCB_SHIFT
    cr = ((r - y) * wcr + delta + half) >> _YCRCB_SHIFT
    cb = ((b - y) * wcb + delta + half) >> _YCRCB_SHIFT
    return torch.stack([y, cr, cb], -1).clamp(0, 255)
