"""Structured logging setup and the in-memory log ring buffer.

Counterpart of video_enhancer_tpu/utils/logging_config.py (the reference's
config/logging_config.py): the JSON ``StructuredFormatter`` (:41-79),
``setup_logging`` with its stream handler and, given ``log_dir``, a
rotating file of 10 MiB x 5 in JSON (:192-308), ``PerformanceLogger`` for
processing and model-load events and the card's memory (:81-156),
``RequestContext``, which adds a request id to the records logged inside
it (:401+), and the ring buffer of the last 500 lines that the server's
``/logs`` reads (the reference's live-log panel, app.py:217-233).
"""

from __future__ import annotations

import collections
import json
import logging
import logging.handlers
import threading
import time
import uuid
from pathlib import Path

__all__ = ["StructuredFormatter", "RingBufferHandler", "setup_logging",
           "PerformanceLogger", "RequestContext", "get_ring_buffer"]


class StructuredFormatter(logging.Formatter):
    """One JSON object a record: UTC time, level, logger, message, the
    exception's traceback and the record's ``ctx`` where it has them."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "ctx", None)
        if extra:
            entry["ctx"] = extra
        return json.dumps(entry)


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


def setup_logging(log_dir: str | Path | None = None,
                  level: int = logging.INFO, structured: bool = True) -> None:
    """The root logger at ``level``: to stderr in JSON (``structured``) or
    plain text, and with ``log_dir`` also to the rotating JSON file
    ``<log_dir>/video_enhancer.log``; then the ring buffer."""
    root = logging.getLogger()
    root.setLevel(level)
    stream = logging.StreamHandler()
    stream.setFormatter(
        StructuredFormatter() if structured
        else logging.Formatter("%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s"))
    root.addHandler(stream)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(log_dir) / "video_enhancer.log",
            maxBytes=10 * 1024 * 1024, backupCount=5)
        fh.setFormatter(StructuredFormatter())
        root.addHandler(fh)
    get_ring_buffer()


class PerformanceLogger:
    """Structured perf events, each an INFO record with its ``ctx``."""

    def __init__(self, logger_name: str = "perf"):
        self.log = logging.getLogger(logger_name)

    def processing_start(self, job_id: str, model: str, **ctx):
        self.log.info("processing_start", extra={"ctx": {
            "job_id": job_id, "model": model, **ctx}})

    def processing_end(self, job_id: str, seconds: float, frames: int,
                       **ctx):
        self.log.info("processing_end", extra={"ctx": {
            "job_id": job_id, "seconds": seconds, "frames": frames,
            "fps": frames / seconds if seconds else 0, **ctx}})

    def model_load(self, model: str, seconds: float, source: str = "init"):
        self.log.info("model_load", extra={"ctx": {
            "model": model, "seconds": seconds, "source": source}})

    def device_memory(self):
        """The card's memory (utils/memory.py ``DeviceMemoryManager``)."""
        from .memory import DeviceMemoryManager

        self.log.info("device_memory",
                      extra={"ctx": DeviceMemoryManager.get_info()})


class RequestContext:
    """Within it, every record that reaches the root logger carries
    ``ctx["request_id"]`` (a fresh 8-hex id unless one is given)."""

    def __init__(self, request_id: str | None = None):
        self.request_id = request_id or uuid.uuid4().hex[:8]
        self._filter = None

    def __enter__(self):
        rid = self.request_id

        class _F(logging.Filter):
            def filter(self, record):
                record.ctx = {**getattr(record, "ctx", {}),
                              "request_id": rid}
                return True

        self._filter = _F()
        logging.getLogger().addFilter(self._filter)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeFilter(self._filter)
