"""Colour conversion as OpenCV computes it, without OpenCV.

``rgb_to_gray`` is cv2's ``COLOR_RGB2GRAY`` of uint8 frames in its fixed
point (OpenCV 5): the (R, G, B) weights over 2 ** 15, equal to cv2 on all
2 ** 24 colours. The quality gate of scale-1 models
(runtime/vsr_handler.py ``window_quality``) and the temporal stage's
optical flow (ops/optflow.py) read their gray images through it.
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray"]

_GRAY_WEIGHTS = (9798, 19235, 3735)
_GRAY_SHIFT = 15


def rgb_to_gray(frame_u8: torch.Tensor) -> torch.Tensor:
    """cv2's ``COLOR_RGB2GRAY`` of a uint8 ``(..., 3)`` frame, in its
    fixed point: ``(9798 R + 19235 G + 3735 B + 2 ** 14) >> 15``, int32."""
    r, g, b = frame_u8.int().unbind(-1)
    wr, wg, wb = _GRAY_WEIGHTS
    return (r * wr + g * wg + b * wb + (1 << (_GRAY_SHIFT - 1))) \
        >> _GRAY_SHIFT
