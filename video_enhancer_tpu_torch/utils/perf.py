"""Performance tracking: the tracker of video_enhancer_tpu/utils/perf.py.

What the port's server, router and handlers call (the reference's
performance_monitor.py:178-335, 486-510): ``start_operation`` /
``update_operation`` / ``finish_operation``, the per-strategy aggregates
of ``get_stats`` and the ``@track_enhancement_performance(strategy)``
decorator of the handlers' file entry points, with the card's memory from
``torch.cuda`` (none without a card) and a 1 Hz host RSS sampler thread
where psutil is installed. The JAX tracker's ``profile=True`` (a
``jax.profiler`` trace), context manager and history have no caller in
the port.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
import uuid
from typing import Any

import torch

__all__ = ["PerformanceTracker", "get_tracker", "track_enhancement_performance"]


def _device_memory_stats() -> dict:
    if not torch.cuda.is_available():
        return {}
    return {"device_bytes_in_use": torch.cuda.memory_allocated(),
            "device_peak_bytes": torch.cuda.max_memory_allocated()}


@dataclasses.dataclass
class Operation:
    op_id: str
    name: str
    strategy: str
    started: float
    meta: dict = dataclasses.field(default_factory=dict)
    frames_done: int = 0
    peak_host_rss: int = 0
    finished: float | None = None
    success: bool | None = None
    error: str | None = None

    @property
    def elapsed(self) -> float:
        end = self.finished if self.finished is not None else time.time()
        return end - self.started

    @property
    def fps(self) -> float:
        return self.frames_done / self.elapsed if self.elapsed > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["elapsed_sec"] = self.elapsed
        d["fps"] = self.fps
        return d


class _HostSampler(threading.Thread):
    """1 Hz psutil RSS sampler (reference ResourceMonitor,
    performance_monitor.py:96-176)."""

    def __init__(self, tracker: "PerformanceTracker"):
        super().__init__(daemon=True)
        self.tracker = tracker
        self.stop_evt = threading.Event()

    def run(self):
        try:
            import psutil
            proc = psutil.Process()
        except ImportError:  # the card's machine may lack it
            proc = None
        while not self.stop_evt.wait(1.0):
            if proc is None:
                continue
            rss = proc.memory_info().rss
            with self.tracker._lock:
                for op in self.tracker._active.values():
                    op.peak_host_rss = max(op.peak_host_rss, rss)


class PerformanceTracker:
    def __init__(self, history: int = 10_000):
        self._lock = threading.Lock()
        self._active: dict[str, Operation] = {}
        self._history: collections.deque[Operation] = collections.deque(maxlen=history)
        self._sampler: _HostSampler | None = None

    # -- lifecycle ---------------------------------------------------------
    def start_operation(self, name: str, strategy: str = "unknown",
                        **meta: Any) -> str:
        op_id = uuid.uuid4().hex[:12]
        op = Operation(op_id=op_id, name=name, strategy=strategy,
                       started=time.time(), meta=dict(meta))
        with self._lock:
            self._active[op_id] = op
            if self._sampler is None or not self._sampler.is_alive():
                self._sampler = _HostSampler(self)
                self._sampler.start()
        return op_id

    def update_operation(self, op_id: str, frames_done: int | None = None,
                         **meta: Any) -> None:
        with self._lock:
            op = self._active.get(op_id)
            if op is None:
                return
            if frames_done is not None:
                op.frames_done = frames_done
            op.meta.update(meta)

    def finish_operation(self, op_id: str, success: bool = True,
                         error: str | None = None, **meta: Any) -> dict:
        with self._lock:
            op = self._active.pop(op_id, None)
        if op is None:
            return {}
        op.finished = time.time()
        op.success = success
        op.error = error
        op.meta.update(meta)
        op.meta.update(_device_memory_stats())
        with self._lock:
            self._history.append(op)
        return op.to_dict()

    # -- stats -------------------------------------------------------------
    def get_stats(self) -> dict:
        with self._lock:
            hist = list(self._history)
            active = len(self._active)
        by_strategy: dict[str, dict] = {}
        for op in hist:
            s = by_strategy.setdefault(
                op.strategy,
                {"count": 0, "failures": 0, "total_sec": 0.0, "total_frames": 0},
            )
            s["count"] += 1
            s["failures"] += 0 if op.success else 1
            s["total_sec"] += op.elapsed
            s["total_frames"] += op.frames_done
        for s in by_strategy.values():
            s["avg_fps"] = (
                s["total_frames"] / s["total_sec"] if s["total_sec"] else 0.0
            )
        return {
            "active_operations": active,
            "completed_operations": len(hist),
            "by_strategy": by_strategy,
            **_device_memory_stats(),
        }


_tracker: PerformanceTracker | None = None
_tracker_lock = threading.Lock()


def get_tracker() -> PerformanceTracker:
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = PerformanceTracker()
        return _tracker


def track_enhancement_performance(strategy: str):
    """Decorator of the handlers' file entry points (reference
    performance_monitor.py:486-510): the call as one operation of
    ``strategy``, with the ``frames_processed`` of its stats."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            tracker = get_tracker()
            op_id = tracker.start_operation(fn.__qualname__, strategy)
            try:
                result = fn(*args, **kwargs)
            except Exception as e:
                tracker.finish_operation(op_id, success=False, error=str(e))
                raise
            frames = (int(result.get("frames_processed", 0))
                      if isinstance(result, dict) else 0)
            tracker.update_operation(op_id, frames_done=frames)
            tracker.finish_operation(op_id, success=True)
            return result

        return wrapped

    return deco
