"""The in-memory log ring buffer that the server's ``/logs`` reads.

The part of video_enhancer_tpu/utils/logging_config.py that the port's
server and app use (the reference's live-log panel, app.py:217-233): the
last 500 lines of the root logger, and ``setup_logging`` in the plain-text
form the one-port app asks for. The JAX module's structured formatter,
rotating files, perf logger and request context have no caller in the
port.
"""

from __future__ import annotations

import collections
import logging
import threading

__all__ = ["RingBufferHandler", "get_ring_buffer", "setup_logging"]


class RingBufferHandler(logging.Handler):
    """Last-N log lines (reference app.py:217-233, 500 lines)."""

    def __init__(self, capacity: int = 500):
        super().__init__()
        self.buffer: collections.deque[str] = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record):
        with self._lock2:
            self.buffer.append(self.format(record))

    def tail(self, n: int = 100) -> list[str]:
        with self._lock2:
            return list(self.buffer)[-n:]


_ring: RingBufferHandler | None = None


def get_ring_buffer() -> RingBufferHandler:
    global _ring
    if _ring is None:
        _ring = RingBufferHandler()
        _ring.setFormatter(logging.Formatter("%(asctime)s %(levelname)s "
                                             "%(name)s: %(message)s"))
        logging.getLogger().addHandler(_ring)
    return _ring


def setup_logging(level: int = logging.INFO) -> None:
    """The root logger at ``level``, in plain text to stderr and into the
    ring buffer (the JAX module's ``setup_logging(structured=False)``)."""
    root = logging.getLogger()
    root.setLevel(level)
    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter("%(asctime)s %(levelname)s "
                                          "%(name)s: %(message)s"))
    root.addHandler(stream)
    get_ring_buffer()
