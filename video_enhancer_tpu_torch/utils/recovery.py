"""Failure recovery: retry/backoff, circuit breaker, fallback chains.

A copy of video_enhancer_tpu/utils/recovery.py (plain Python). It
re-creates the reference recovery subsystem (reference
utils/error_recovery.py): failure-mode classification + strategy selection
with exponential backoff (:141-160), temp-resource cleanup registry
(:112-225), a ``@with_recovery`` decorator (:227-330), ``CircuitBreaker``
(5 failures / 60 s, :331-379) and ``create_fallback_chain`` (:381-409).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Sequence

log = logging.getLogger(__name__)

__all__ = ["RecoveryManager", "CircuitBreaker", "with_recovery",
           "create_fallback_chain", "CircuitOpenError"]


class CircuitOpenError(RuntimeError):
    pass


class CircuitBreaker:
    """Open after ``failure_threshold`` consecutive failures; half-open
    after ``recovery_timeout`` seconds (reference error_recovery.py:331-379).
    """

    def __init__(self, failure_threshold: int = 5,
                 recovery_timeout: float = 60.0, name: str = ""):
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.name = name
        self._failures = 0
        self._opened_at: float | None = None
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.time() - self._opened_at >= self.recovery_timeout:
                return "half-open"
            return "open"

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            state = self.state
            if state == "open":
                raise CircuitOpenError(
                    f"circuit {self.name or fn.__name__} open "
                    f"({self._failures} failures)"
                )
            try:
                result = fn(*args, **kwargs)
            except Exception:
                with self._lock:
                    self._failures += 1
                    if self._failures >= self.failure_threshold:
                        self._opened_at = time.time()
                raise
            with self._lock:
                self._failures = 0
                self._opened_at = None
            return result

        wrapped.breaker = self
        return wrapped


class RecoveryManager:
    """Retry with exponential backoff + registered temp-resource cleanup."""

    def __init__(self, max_retries: int = 3, base_delay: float = 0.5,
                 max_delay: float = 30.0):
        self.max_retries = max_retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._cleanup: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        self.stats = {"retries": 0, "recoveries": 0, "exhausted": 0}

    def register_cleanup(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._cleanup.append(fn)

    def register_temp_path(self, path) -> None:
        self.register_cleanup(lambda: Path(path).unlink(missing_ok=True))

    def run_cleanup(self) -> int:
        with self._lock:
            fns, self._cleanup = self._cleanup, []
        n = 0
        for fn in fns:
            try:
                fn()
                n += 1
            except Exception as e:
                log.warning("cleanup failed: %s", e)
        return n

    def run(self, fn: Callable, *args,
            retryable: tuple[type[BaseException], ...] = (Exception,),
            on_retry: Callable[[int, BaseException], None] | None = None,
            **kwargs) -> Any:
        delay = self.base_delay
        last: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            try:
                result = fn(*args, **kwargs)
                if attempt > 0:
                    self.stats["recoveries"] += 1
                return result
            except retryable as e:
                last = e
                if attempt == self.max_retries:
                    break
                self.stats["retries"] += 1
                if on_retry:
                    on_retry(attempt, e)
                self.run_cleanup()
                time.sleep(min(delay, self.max_delay))
                delay *= 2
        self.stats["exhausted"] += 1
        raise last  # type: ignore[misc]


def with_recovery(max_retries: int = 3, base_delay: float = 0.5,
                  retryable: tuple[type[BaseException], ...] = (Exception,)):
    """Decorator form (reference error_recovery.py:227-330)."""
    manager = RecoveryManager(max_retries=max_retries, base_delay=base_delay)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return manager.run(fn, *args, retryable=retryable, **kwargs)

        wrapped.recovery_manager = manager
        return wrapped

    return deco


def create_fallback_chain(*fns: Callable, name: str = "chain") -> Callable:
    """Try each callable in order; first success wins (reference
    error_recovery.py:381-409). Mirrors the handler fallbacks: model ->
    bicubic -> original frames (reference app.py:922-932)."""

    def chained(*args, **kwargs):
        errors = []
        for fn in fns:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                errors.append(f"{getattr(fn, '__name__', fn)}: {e}")
                log.warning("fallback chain %s: %s failed (%s)", name,
                            getattr(fn, "__name__", fn), e)
        raise RuntimeError(f"all fallbacks failed: {'; '.join(errors)}")

    return chained
