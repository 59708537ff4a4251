"""CoordinatorAgent: the staged workflow analysis -> enhancement ->
quality assessment -> aggregation over the other agents.

Counterpart of video_enhancer_tpu/agents/coordinator.py: per-stage agent
dispatch, agent registration with the communication system, workflow
stats, and one escalation re-run with a higher-quality model (vsrm, else
seedvr2) when the quality gates fail. Every agent runs on the
coordinator's device: the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import enum
import time
import uuid
from typing import Any

import torch

from ..device import resolve_device
from .analyzer import VideoAnalyzerAgent
from .base import AgentCapabilities, BaseAgent, ProcessingResult
from .communication import AgentCommunicationSystem
from .enhancer import VideoEnhancementAgent
from .quality import QualityAssessmentAgent
from .task_spec import Priority, Quality, TaskSpecification, TaskType

__all__ = ["CoordinatorAgent", "WorkflowStage"]


class WorkflowStage(str, enum.Enum):
    ANALYSIS = "analysis"
    ENHANCEMENT = "enhancement"
    QUALITY_ASSESSMENT = "quality_assessment"
    AGGREGATION = "aggregation"


@dataclasses.dataclass
class WorkflowState:
    workflow_id: str
    request: dict
    stage: WorkflowStage = WorkflowStage.ANALYSIS
    results: dict[str, Any] = dataclasses.field(default_factory=dict)
    started: float = dataclasses.field(default_factory=time.time)
    status: str = "running"


class CoordinatorAgent(BaseAgent):
    def __init__(self, agent_id: str = "coordinator", policy=None,
                 device: str | torch.device | None = None):
        super().__init__(
            agent_id,
            AgentCapabilities(task_types={TaskType.VIDEO_ENHANCEMENT},
                              max_concurrent_tasks=4),
        )
        self.device = resolve_device(device)
        self.comm = AgentCommunicationSystem()
        self.analyzer = VideoAnalyzerAgent(policy=policy, device=self.device)
        self.enhancer = VideoEnhancementAgent(policy=policy,
                                              device=self.device)
        self.assessor = QualityAssessmentAgent(policy=policy,
                                               device=self.device)
        for agent in (self.analyzer, self.enhancer, self.assessor):
            self.comm.register_agent(agent.agent_id, agent)
        self.workflows: dict[str, WorkflowState] = {}
        self.stats = {"completed": 0, "failed": 0, "escalated": 0}

    def _execute(self, task: TaskSpecification) -> ProcessingResult:
        wf = self.run_workflow(task.input_path, task.output_path,
                               quality=task.quality.value)
        ok = wf.status == "completed"
        return ProcessingResult(
            task_id=task.task_id,
            status="success" if ok else "failed",
            output_path=task.output_path if ok else None,
            metrics={"workflow": wf.results, "workflow_id": wf.workflow_id},
            error=None if ok else wf.results.get("error"),
        )

    # -- the 4-stage sequential workflow ------------------------------------
    def run_workflow(self, input_path: str, output_path: str,
                     quality: str = "balanced",
                     assess_quality: bool = True) -> WorkflowState:
        wf = WorkflowState(workflow_id=uuid.uuid4().hex[:12],
                           request={"input": input_path, "output": output_path})
        self.workflows[wf.workflow_id] = wf
        try:
            # 1. analysis
            wf.stage = WorkflowStage.ANALYSIS
            a_task = TaskSpecification(
                task_type=TaskType.VIDEO_ANALYSIS, input_path=input_path,
            )
            a_res = self.analyzer.process_task(a_task)
            wf.results["analysis"] = a_res.metrics.get("analysis", {})

            # 2. enhancement
            wf.stage = WorkflowStage.ENHANCEMENT
            e_task = TaskSpecification(
                task_type=TaskType.VIDEO_ENHANCEMENT,
                input_path=input_path, output_path=output_path,
                quality=Quality(quality), priority=Priority.NORMAL,
                params={"analysis": wf.results["analysis"]},
            )
            e_res = self.enhancer.process_task(e_task)
            wf.results["enhancement"] = e_res.to_dict()
            if e_res.status != "success":
                raise RuntimeError(e_res.error or "enhancement failed")

            # 3. quality assessment (+ one gated escalation)
            if assess_quality:
                wf.stage = WorkflowStage.QUALITY_ASSESSMENT
                q_task = TaskSpecification(
                    task_type=TaskType.QUALITY_ASSESSMENT,
                    input_path=input_path, output_path=output_path,
                )
                q_res = self.assessor.process_task(q_task)
                wf.results["quality"] = q_res.metrics
                if q_res.metrics.get("needs_reprocessing") and \
                        self.enhancer.available & {"vsrm", "seedvr2"}:
                    self.stats["escalated"] += 1
                    e_task.model_preference = (
                        "vsrm" if "vsrm" in self.enhancer.available
                        else "seedvr2"
                    )
                    e_res2 = self.enhancer.process_task(e_task)
                    wf.results["escalation"] = e_res2.to_dict()

            # 4. aggregation
            wf.stage = WorkflowStage.AGGREGATION
            wf.results["summary"] = {
                "model_used": e_res.metrics.get("model_used"),
                "frames": e_res.metrics.get("frames_processed"),
                "total_time_sec": time.time() - wf.started,
            }
            wf.status = "completed"
            self.stats["completed"] += 1
        except Exception as e:
            wf.status = "failed"
            wf.results["error"] = str(e)
            self.stats["failed"] += 1
        return wf

    def get_workflow_stats(self) -> dict:
        return {
            **self.stats,
            "active": sum(1 for w in self.workflows.values()
                          if w.status == "running"),
            "total": len(self.workflows),
        }
