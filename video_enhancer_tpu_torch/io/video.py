"""Video file read and write: raw AVI by the port itself, the rest through
OpenCV.

Counterpart of video_enhancer_tpu/io/video.py, with its surface
(``VideoMetadata``, ``get_video_metadata``, ``read_video``,
``sample_frames``, ``write_video``, ``VideoReader``, ``VideoWriter``) and the
port's streaming pair ``read_frames`` / ``write_frames``. Frames are RGB
uint8 ``(H, W, 3)``; BGR exists only inside this module and io/avi.py.

- Reading goes by content: a RIFF/AVI whose video stream is uncompressed
  24-bit BI_RGB is read by io/avi.py with numpy alone; any other file goes
  to OpenCV.
- Writing goes by suffix: ``.avi`` is written by io/avi.py (raw, top-down
  rows, which OpenCV reads back bit for bit); any other suffix goes through
  OpenCV with the codec given (mp4v), as in the JAX package.

The card's machine has no OpenCV: there a file of another container raises
an ``IOError`` that names the container and says that uncompressed AVI
reads without OpenCV. Nothing is transcoded in silence. For a raw AVI the
metadata are what OpenCV reports for it (its fourcc is 0, so ``codec`` is
four NUL characters, as the JAX package's).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from . import avi

__all__ = ["VideoMetadata", "get_video_metadata", "read_video",
           "read_frames", "write_video", "write_frames", "sample_indices",
           "sample_frames", "VideoReader", "VideoWriter", "scratch_suffix"]

_RAW_CODEC = "\x00" * 4              # OpenCV's fourcc 0, as JAX reports it


@dataclasses.dataclass(frozen=True)
class VideoMetadata:
    path: str
    width: int
    height: int
    fps: float
    frame_count: int
    duration_sec: float = 0.0
    codec: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _container(path) -> str:
    """A name for the container of a file the port cannot read itself."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        head = b""
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "AVI with a compressed or non-24-bit video stream"
    if b"ftyp" in head[:12]:
        return "MP4/MOV"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "Matroska/WebM"
    return f"'{Path(str(path)).suffix or 'no suffix'}'"


def _cv2(path, writing: bool = False):
    if not writing and not os.path.exists(path):
        raise FileNotFoundError(f"no such file: {path}")
    try:
        import cv2
    except ImportError as e:
        what = (f"'{Path(str(path)).suffix}' output" if writing
                else f"{_container(path)} file")
        raise IOError(
            f"cannot {'write' if writing else 'read'} {path}: a {what} needs "
            "OpenCV (cv2), which is not installed; uncompressed 24-bit AVI "
            "(.avi) reads and writes without it") from e
    return cv2


def _open(path):
    cv2 = _cv2(path)
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    return cap


def get_video_metadata(path) -> VideoMetadata:
    info = avi.probe(path)
    if info is not None:
        with avi.AviReader(path) as r:
            n = len(r)
        fps = info.fps or 30.0
        return VideoMetadata(path=str(path), width=info.width,
                             height=info.height, fps=fps, frame_count=n,
                             duration_sec=n / fps, codec=_RAW_CODEC)
    cv2 = _cv2(path)
    cap = _open(path)
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS) or 30.0)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
        codec = "".join(chr((fourcc >> (8 * i)) & 0xFF)
                        for i in range(4)).strip()
        return VideoMetadata(
            path=str(path), width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), fps=fps,
            frame_count=n, duration_sec=(n / fps if fps else 0.0),
            codec=codec)
    finally:
        cap.release()


def read_frames(path, start: int = 0,
                count: int | None = None) -> Iterator[np.ndarray]:
    """Yield the file's frames as RGB uint8, from ``start``, at most
    ``count`` of them."""
    if avi.probe(path) is not None:
        with avi.AviReader(path) as r:
            yield from r.frames(start, count)
        return
    cv2 = _cv2(path)
    cap = _open(path)
    try:
        if start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        n = 0
        while count is None or n < count:
            ok, bgr = cap.read()
            if not ok:
                return
            n += 1
            yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def read_video(path, start: int = 0, count: int | None = None) -> np.ndarray:
    """Read frames as ``(T, H, W, 3)`` RGB uint8."""
    frames = list(read_frames(path, start, count))
    if not frames:
        raise IOError(f"no frames read from {path}")
    return np.stack(frames)


def sample_indices(frame_count: int, num_samples: int = 12) -> np.ndarray:
    """Indices of ``num_samples`` frames spread uniformly over the video,
    the router's sample (video_enhancer_tpu/io/video.py:87-92)."""
    n = max(frame_count, 1)
    return np.unique(np.linspace(0, n - 1, num_samples).astype(int))


def sample_frames(path, num_samples: int = 12) -> np.ndarray:
    """The frames at ``sample_indices`` of a file, ``(T, H, W, 3)`` RGB
    uint8."""
    meta = get_video_metadata(path)
    idxs = sample_indices(meta.frame_count, num_samples)
    if avi.probe(path) is not None:
        with avi.AviReader(path) as r:
            out = [r.frame(int(i)) for i in idxs]
    else:
        cv2 = _cv2(path)
        cap = _open(path)
        try:
            out = []
            for i in idxs:
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
                ok, bgr = cap.read()
                if ok:
                    out.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
    if not out:
        raise IOError(f"no frames sampled from {path}")
    return np.stack(out)


def _is_avi(path) -> bool:
    return Path(str(path)).suffix.lower() == ".avi"


def scratch_suffix(path) -> str:
    """The suffix of an intermediate file made from ``path``: raw AVI for an
    ``.avi``, mp4v in ``.mp4`` for the rest (the JAX package's)."""
    return ".avi" if _is_avi(path) else ".mp4"


class VideoWriter:
    """Streaming RGB frame writer: raw AVI for ``.avi``, OpenCV otherwise."""

    def __init__(self, path, size_hw: tuple[int, int], fps: float = 30.0,
                 codec: str = "mp4v"):
        h, w = size_hw
        self.path = str(path)
        self.frames_written = 0
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        if _is_avi(path):
            self._avi = avi.AviWriter(self.path, (h, w), fps)
            self._vw = None
            return
        self._avi = None
        self._cv2 = _cv2(path, writing=True)
        self._vw = self._cv2.VideoWriter(
            self.path, self._cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if not self._vw.isOpened():
            raise IOError(f"cannot open writer: {path}")

    def write(self, frame: np.ndarray) -> None:
        if self._avi is not None:
            self._avi.write(frame)
        else:
            self._vw.write(self._cv2.cvtColor(np.ascontiguousarray(frame),
                                              self._cv2.COLOR_RGB2BGR))
        self.frames_written += 1

    def close(self) -> None:
        if self._avi is not None:
            self._avi.close()
        else:
            self._vw.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_frames(path, frames: Iterable[np.ndarray], size_hw: tuple[int, int],
                 fps: float = 30.0, codec: str = "mp4v") -> int:
    """Write RGB uint8 frames of ``size_hw``; returns how many."""
    with VideoWriter(path, size_hw, fps, codec) as vw:
        for f in frames:
            vw.write(f)
    return vw.frames_written


def write_video(path, frames: np.ndarray, fps: float = 30.0,
                codec: str = "mp4v") -> str:
    """Write ``(T, H, W, 3)`` RGB uint8 frames."""
    path = str(path)
    write_frames(path, frames, frames.shape[1:3], fps, codec)
    if not os.path.getsize(path):
        raise IOError(f"writer produced empty file: {path}")
    return path


class VideoReader:
    """Streaming frame reader."""

    def __init__(self, path):
        self.meta = get_video_metadata(path)
        self._it = read_frames(path)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return next(self._it)

    def close(self) -> None:
        self._it.close()
