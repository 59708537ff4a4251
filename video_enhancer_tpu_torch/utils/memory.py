"""Memory status and temp-file cleanup for the scheduler's default tasks.

The part of video_enhancer_tpu/utils/memory.py that
``runtime.scheduler.setup_default_tasks`` calls: ``get_memory_manager()``,
its ``get_status()`` (the card's memory from ``torch.cuda``, the host's
from psutil where it is installed, an error entry where it is not) and
``routine_cleanup()`` (registered temp files past their age). The JAX
package's handler LRU (``ModelCache``) has no counterpart: the port's
registry keeps its own handler cache.
"""

from __future__ import annotations

import gc
import threading
import time
from pathlib import Path

import torch

__all__ = ["DeviceMemoryManager", "TempFileManager", "MemoryManager",
           "get_memory_manager"]


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


class MemoryManager:
    """Facade: status and routine cleanup (reference memory_manager.py:391-486)."""

    def __init__(self):
        self.device = DeviceMemoryManager()
        self.temp_files = TempFileManager()

    def host_info(self) -> dict:
        try:
            import psutil
        except ImportError as e:
            return {"error": str(e)}
        vm = psutil.virtual_memory()
        return {"total": vm.total, "available": vm.available,
                "percent": vm.percent}

    def routine_cleanup(self) -> dict:
        removed = self.temp_files.cleanup()
        gc.collect()
        return {"temp_files_removed": removed}

    def get_status(self) -> dict:
        return {"device": self.device.get_info(), "host": self.host_info()}


_mm: MemoryManager | None = None
_mm_lock = threading.Lock()


def get_memory_manager() -> MemoryManager:
    global _mm
    with _mm_lock:
        if _mm is None:
            _mm = MemoryManager()
        return _mm
