"""Background task scheduler + default maintenance tasks: a copy of
video_enhancer_tpu/runtime/scheduler.py (standard library only).

Re-creates the reference scheduler (reference utils/background_scheduler.py):
add/run tasks on intervals with a poll loop (:43-200) and the default task
set — storage maintenance, health check, temp cleanup, job cleanup
(:208-390).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable

log = logging.getLogger(__name__)

__all__ = ["BackgroundScheduler", "setup_default_tasks"]


@dataclasses.dataclass
class ScheduledTask:
    name: str
    fn: Callable[[], object]
    interval_sec: float
    run_at_start: bool = False
    last_run: float | None = None
    runs: int = 0
    failures: int = 0
    last_result: object = None


class BackgroundScheduler:
    def __init__(self, poll_sec: float = 5.0):
        self.poll_sec = poll_sec
        self._tasks: dict[str, ScheduledTask] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_task(self, name: str, fn: Callable[[], object],
                 interval_sec: float, run_at_start: bool = False) -> None:
        with self._lock:
            self._tasks[name] = ScheduledTask(
                name=name, fn=fn, interval_sec=interval_sec,
                run_at_start=run_at_start,
            )

    def run_task(self, name: str) -> object:
        with self._lock:
            task = self._tasks.get(name)
        if task is None:
            raise KeyError(name)
        try:
            result = task.fn()
            task.last_result = result
            task.runs += 1
            return result
        except Exception as e:
            task.failures += 1
            task.last_result = f"error: {e}"
            log.warning("scheduled task %s failed: %s", name, e)
            return None
        finally:
            task.last_run = time.time()

    def _loop(self):
        with self._lock:
            startup = [t.name for t in self._tasks.values() if t.run_at_start]
        for name in startup:
            self.run_task(name)
        while not self._stop.wait(self.poll_sec):
            now = time.time()
            with self._lock:
                due = [
                    t.name for t in self._tasks.values()
                    if t.last_run is None or now - t.last_run >= t.interval_sec
                ]
            for name in due:
                self.run_task(name)

    def start(self) -> None:
        if self._thread and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.poll_sec * 2)

    def get_status(self) -> dict:
        with self._lock:
            return {
                name: {
                    "interval_sec": t.interval_sec,
                    "runs": t.runs,
                    "failures": t.failures,
                    "last_run_age_sec": (
                        time.time() - t.last_run if t.last_run else None
                    ),
                }
                for name, t in self._tasks.items()
            }


def setup_default_tasks(scheduler: BackgroundScheduler, job_store=None,
                        storage=None) -> None:
    """Default maintenance set (reference background_scheduler.py:208-390):
    storage maintenance daily, health check 6h (on startup), temp cleanup
    12h, job cleanup daily."""
    from ..utils.memory import get_memory_manager

    mm = get_memory_manager()

    if storage is not None:
        scheduler.add_task("storage_maintenance",
                           storage.run_maintenance, 24 * 3600)
    scheduler.add_task(
        "system_health_check",
        lambda: mm.get_status(), 6 * 3600, run_at_start=True,
    )
    scheduler.add_task("temp_cleanup", mm.routine_cleanup, 12 * 3600)
    if job_store is not None:
        scheduler.add_task(
            "job_cleanup",
            lambda: job_store.cleanup_older_than(7 * 24 * 3600), 24 * 3600,
        )
