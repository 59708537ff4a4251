"""Sliding frame windows over a stream of frames.

Counterpart of the windowing of video_enhancer_tpu/io/pipeline.py:54-98:
windows of ``window`` frames every ``stride`` frames; a tail that does not
fill a window is padded by repeating its last frame and reports how many
frames are real (``valid``). It takes any iterator of uint8 ``(H, W, 3)``
frames and stays on the host; the handler moves each window to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

__all__ = ["Window", "iter_windows"]


@dataclass(frozen=True)
class Window:
    frames: np.ndarray   # (window, H, W, 3) uint8
    start: int           # index of the first frame in the stream
    valid: int           # real frames; the rest repeat the last one


def iter_windows(frames: Iterable[np.ndarray], window: int,
                 stride: int | None = None) -> Iterator[Window]:
    stride = stride or window
    buf: list[np.ndarray] = []
    start = 0
    for frame in frames:
        buf.append(frame)
        if len(buf) == window:
            yield Window(np.stack(buf), start, window)
            buf = buf[stride:] if window > stride else []
            start += stride
    if buf:
        valid = len(buf)
        buf += [buf[-1]] * (window - valid)
        yield Window(np.stack(buf), start, valid)
