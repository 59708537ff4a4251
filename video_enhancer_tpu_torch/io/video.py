"""Video file read and write through OpenCV.

Counterpart of video_enhancer_tpu/io/video.py. Frames are RGB uint8 ``(H,
W, 3)``; BGR exists only inside this module. ``cv2`` is imported inside the
functions that touch files, so the rest of the port imports without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

__all__ = ["VideoMetadata", "get_video_metadata", "read_frames",
           "write_frames"]


@dataclass(frozen=True)
class VideoMetadata:
    path: str
    width: int
    height: int
    fps: float
    frame_count: int


def _open(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    return cap


def get_video_metadata(path) -> VideoMetadata:
    import cv2

    cap = _open(path)
    try:
        return VideoMetadata(
            path=str(path),
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS) or 30.0),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    finally:
        cap.release()


def read_frames(path) -> Iterator[np.ndarray]:
    """Yield the file's frames as RGB uint8."""
    import cv2

    cap = _open(path)
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def write_frames(path, frames: Iterable[np.ndarray], size_hw: tuple[int, int],
                 fps: float = 30.0, codec: str = "mp4v") -> int:
    """Write RGB uint8 frames of ``size_hw``; returns how many."""
    import cv2

    h, w = size_hw
    Path(str(path)).parent.mkdir(parents=True, exist_ok=True)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    if not vw.isOpened():
        raise IOError(f"cannot open writer: {path}")
    n = 0
    try:
        for f in frames:
            vw.write(cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_RGB2BGR))
            n += 1
    finally:
        vw.release()
    return n
