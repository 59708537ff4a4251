"""Base agent: a copy of video_enhancer_tpu/agents/base.py (standard
library only; the reference's agents/core/base_agent.py without the
agentscope dependency shim).

An agent declares capabilities (supported task types + concurrency), accepts
``TaskSpecification``s via ``process_task`` (checked by ``can_handle``), and
keeps per-agent metrics (reference base_agent.py:349-397).
"""

from __future__ import annotations

import abc
import dataclasses
import threading
import time
from typing import Any

from .task_spec import TaskSpecification, TaskType

__all__ = ["AgentCapabilities", "ProcessingResult", "BaseAgent"]


@dataclasses.dataclass
class AgentCapabilities:
    task_types: set[TaskType]
    max_concurrent_tasks: int = 1
    device_required: bool = False
    max_resolution: tuple[int, int] | None = None


@dataclasses.dataclass
class ProcessingResult:
    task_id: str
    status: str  # success | failed | rejected
    output_path: str | None = None
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    error: str | None = None
    processing_time_sec: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BaseAgent(abc.ABC):
    def __init__(self, agent_id: str, capabilities: AgentCapabilities):
        self.agent_id = agent_id
        self.capabilities = capabilities
        self._active = 0
        self._lock = threading.Lock()
        self.metrics = {
            "tasks_completed": 0,
            "tasks_failed": 0,
            "tasks_rejected": 0,
            "total_processing_time_sec": 0.0,
        }

    # -- admission (reference base_agent.py:349-380) ------------------------
    def can_handle(self, task: TaskSpecification) -> tuple[bool, str]:
        if task.task_type not in self.capabilities.task_types:
            return False, f"unsupported task type {task.task_type.value}"
        if self._active >= self.capabilities.max_concurrent_tasks:
            return False, "at max concurrency"
        if self.capabilities.max_resolution is not None:
            mh, mw = self.capabilities.max_resolution
            if (task.video_specs.height > mh or task.video_specs.width > mw):
                return False, "resolution exceeds agent capability"
        return True, "ok"

    def process_task(self, task: TaskSpecification) -> ProcessingResult:
        errors = task.validate()
        if errors:
            with self._lock:
                self.metrics["tasks_rejected"] += 1
            return ProcessingResult(
                task_id=task.task_id, status="rejected",
                error="; ".join(errors),
            )
        ok, reason = self.can_handle(task)
        if not ok:
            with self._lock:
                self.metrics["tasks_rejected"] += 1
            return ProcessingResult(task_id=task.task_id, status="rejected",
                                    error=reason)
        t0 = time.time()
        with self._lock:
            self._active += 1
        try:
            result = self._execute(task)
            result.processing_time_sec = time.time() - t0
            with self._lock:
                self.metrics["tasks_completed"] += 1
                self.metrics["total_processing_time_sec"] += \
                    result.processing_time_sec
            return result
        except Exception as e:
            with self._lock:
                self.metrics["tasks_failed"] += 1
            return ProcessingResult(
                task_id=task.task_id, status="failed", error=str(e),
                processing_time_sec=time.time() - t0,
            )
        finally:
            with self._lock:
                self._active -= 1

    @abc.abstractmethod
    def _execute(self, task: TaskSpecification) -> ProcessingResult:
        ...

    def get_status(self) -> dict:
        with self._lock:
            return {
                "agent_id": self.agent_id,
                "active_tasks": self._active,
                "task_types": sorted(t.value for t in
                                     self.capabilities.task_types),
                "metrics": dict(self.metrics),
            }
