"""Debug helpers: timed operations + contextual debug logging.

A copy of video_enhancer_tpu/utils/debug.py (plain Python). It re-creates
the reference debug logger surface (reference utils/debug_logger.py:
45-331: contextual debug formatter, per-call context stack,
``TimedOperation``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

__all__ = ["TimedOperation", "debug_context", "get_debug_logger"]

_local = threading.local()


def _stack() -> list[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


class _ContextFilter(logging.Filter):
    def filter(self, record):
        stack = _stack()
        if stack:
            record.msg = f"[{' > '.join(stack)}] {record.msg}"
        return True


_logger: logging.Logger | None = None


def get_debug_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("vetpu.debug")
        _logger.addFilter(_ContextFilter())
    return _logger


@contextlib.contextmanager
def debug_context(name: str):
    _stack().append(name)
    try:
        yield
    finally:
        _stack().pop()


class TimedOperation:
    """``with TimedOperation("decode") as t: ...; t.elapsed``."""

    def __init__(self, name: str, log_level: int = logging.DEBUG):
        self.name = name
        self.log_level = log_level
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        _stack().append(self.name)
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        _stack().pop()
        get_debug_logger().log(self.log_level, "%s took %.3fs",
                               self.name, self.elapsed)
