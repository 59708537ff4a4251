"""Sliding frame windows over a stream of frames, and a prefetching
reader of them.

Counterpart of video_enhancer_tpu/io/pipeline.py. ``iter_windows`` is its
windowing (:54-98): windows of ``window`` frames every ``stride`` frames;
a tail that does not fill a window is padded by repeating its last frame
and reports how many frames are real (``valid``). It takes any iterator of
uint8 ``(H, W, 3)`` frames and stays on the host; the handlers move each
window to the device. ``FramePipeline`` (:25-98) decodes a video file on a
producer thread into a queue of ``depth`` windows, each already float32 in
[0, 1] on the device, so that decoding and the copy of the next window
overlap the work on this one.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from .video import VideoReader

__all__ = ["Window", "iter_windows", "FramePipeline"]

_SENTINEL = object()


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


class FramePipeline:
    """Iterate the windows of the video at ``path`` as dicts of ``frames``
    (a float32 ``(window, H, W, 3)`` tensor in [0, 1] on ``device``, the
    card unless ``"cpu"`` is asked for), ``start`` and ``valid`` (as
    ``iter_windows``), decoded and moved ``depth`` windows ahead on a
    producer thread. ``transform`` maps each float32 numpy window before
    the move. A missing or unreadable file raises here; an error in the
    producer is raised in the consumer after the windows before it. The
    tail is always padded by repeating its last frame, as in the JAX
    package, whose ``pad_mode`` argument is read nowhere and so is not
    taken here."""

    def __init__(self, path, window: int = 8, stride: int | None = None,
                 depth: int = 2, *,
                 transform: Callable[[np.ndarray], np.ndarray] | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.reader = VideoReader(path)
        self.meta = self.reader.meta
        self.window = window
        self.stride = stride or window
        self.depth = depth
        self.transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for w in iter_windows(self.reader, self.window, self.stride):
                arr = w.frames.astype(np.float32) / 255.0
                if self.transform is not None:
                    arr = self.transform(arr)
                self._q.put({"frames": torch.from_numpy(
                    np.ascontiguousarray(arr)).to(self.device),
                    "start": w.start, "valid": w.valid})
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item
