"""Memory management: device stats, LRU model cache, temp files, host RAM.

Counterpart of video_enhancer_tpu/utils/memory.py: ``get_memory_manager()``
and its ``get_status()`` (the card's memory from ``torch.cuda``, the host's
from psutil where it is installed, an error entry where it is not; the
model cache's keys and counts), ``routine_cleanup()`` (registered temp
files past their age), ``check_pressure()`` and ``emergency_cleanup()``
(every temp file, the model cache, and the card's cached blocks returned
with ``torch.cuda.empty_cache()``), and ``ModelCache``, an LRU of at most
three built models. The registry keeps its own handler cache; this one is
for callers that hold models themselves, as in the JAX package.
"""

from __future__ import annotations

import collections
import gc
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable

import torch

log = logging.getLogger(__name__)

__all__ = ["DeviceMemoryManager", "ModelCache", "TempFileManager",
           "MemoryManager", "get_memory_manager"]


class DeviceMemoryManager:
    """The card's memory through ``torch.cuda`` (nothing without a card)."""

    @staticmethod
    def get_info() -> dict:
        if not torch.cuda.is_available():
            return {"device": "cpu"}
        try:
            free, total = torch.cuda.mem_get_info()
            used = torch.cuda.memory_allocated()
            return {
                "device": torch.cuda.get_device_name(0),
                "bytes_in_use": used,
                "bytes_limit": total,
                "bytes_free": free,
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
                "utilization": used / total if total else 0.0,
            }
        except RuntimeError as e:
            return {"error": str(e)}

    @staticmethod
    def cleanup() -> None:
        """Collect garbage and release the card's cached, unused blocks
        (``torch.cuda.empty_cache``; nothing more on the CPU)."""
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class ModelCache:
    """LRU cache of built handlers/params, capacity 3 (reference
    memory_manager.py:172-241)."""

    def __init__(self, capacity: int = 3):
        self.capacity = capacity
        self._od: collections.OrderedDict[str, Any] = collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    def get(self, key: str, builder: Callable[[], Any] | None = None):
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                self.stats["hits"] += 1
                return self._od[key]
            self.stats["misses"] += 1
        if builder is None:
            return None
        value = builder()
        self.put(key, value)
        return value

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                evicted, _ = self._od.popitem(last=False)
                self.stats["evictions"] += 1
                log.info("model cache evicted %s", evicted)

    def clear(self) -> None:
        with self._lock:
            self._od.clear()

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._od)


class TempFileManager:
    """Track temp files; delete by age (reference memory_manager.py:336-389)."""

    def __init__(self):
        self._files: dict[str, float] = {}
        self._lock = threading.Lock()

    def register(self, path) -> str:
        with self._lock:
            self._files[str(path)] = time.time()
        return str(path)

    def cleanup(self, max_age_sec: float = 3600.0) -> int:
        now = time.time()
        removed = 0
        with self._lock:
            items = list(self._files.items())
        for path, created in items:
            if now - created > max_age_sec or not Path(path).exists():
                Path(path).unlink(missing_ok=True)
                with self._lock:
                    self._files.pop(path, None)
                removed += 1
        return removed

    def cleanup_all(self) -> int:
        return self.cleanup(max_age_sec=0.0)


class MemoryManager:
    """Facade: routine + emergency cleanup (reference memory_manager.py:
    391-486)."""

    def __init__(self, host_threshold_pct: float = 90.0):
        self.device = DeviceMemoryManager()
        self.model_cache = ModelCache()
        self.temp_files = TempFileManager()
        self.host_threshold_pct = host_threshold_pct

    def host_info(self) -> dict:
        try:
            import psutil
        except ImportError as e:
            return {"error": str(e)}
        vm = psutil.virtual_memory()
        return {"total": vm.total, "available": vm.available,
                "percent": vm.percent}

    def check_pressure(self) -> bool:
        """The host's memory at or past the threshold (False where psutil
        is missing)."""
        info = self.host_info()
        return info.get("percent", 0) >= self.host_threshold_pct

    def routine_cleanup(self) -> dict:
        removed = self.temp_files.cleanup()
        gc.collect()
        return {"temp_files_removed": removed}

    def emergency_cleanup(self) -> dict:
        removed = self.temp_files.cleanup_all()
        self.model_cache.clear()
        self.device.cleanup()
        return {"temp_files_removed": removed, "model_cache_cleared": True}

    def get_status(self) -> dict:
        return {"device": self.device.get_info(), "host": self.host_info(),
                "model_cache": {"keys": self.model_cache.keys(),
                                **self.model_cache.stats}}


_mm: MemoryManager | None = None
_mm_lock = threading.Lock()


def get_memory_manager() -> MemoryManager:
    global _mm
    with _mm_lock:
        if _mm is None:
            _mm = MemoryManager()
        return _mm
