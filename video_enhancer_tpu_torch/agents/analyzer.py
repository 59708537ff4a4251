"""VideoAnalyzerAgent: the router's degradation analysis of a file, with
processing recommendations and a resource estimate.

Counterpart of video_enhancer_tpu/agents/analyzer.py, on the port's
``DegradationRouter`` (scoring on the agent's device).
"""

from __future__ import annotations

import torch

from ..analysis import DegradationRouter
from ..device import resolve_device
from .base import AgentCapabilities, BaseAgent, ProcessingResult
from .task_spec import TaskSpecification, TaskType

__all__ = ["VideoAnalyzerAgent"]


class VideoAnalyzerAgent(BaseAgent):
    def __init__(self, agent_id: str = "video_analyzer", policy=None,
                 device: str | torch.device | None = None):
        super().__init__(
            agent_id,
            AgentCapabilities(task_types={TaskType.VIDEO_ANALYSIS},
                              max_concurrent_tasks=4),
        )
        self.router = DegradationRouter(policy)
        self.device = resolve_device(device)

    def _execute(self, task: TaskSpecification) -> ProcessingResult:
        plan = self.router.analyze_and_route(
            task.input_path,
            latency_class=task.constraints.latency_class,
            device=self.device,
        )
        return ProcessingResult(
            task_id=task.task_id,
            status="success",
            metrics={
                "analysis": plan,
                "recommendations": self._recommend(plan),
                "resource_estimate": self._estimate_resources(task, plan),
            },
        )

    def _recommend(self, plan: dict) -> list[str]:
        deg = plan.get("degradations", {})
        recs = []
        if deg.get("noise", 0) > 0.4:
            recs.append("apply denoising expert before enhancement")
        if deg.get("compression", 0) > 0.6:
            recs.append("apply compression cleanup; prefer seedvr2")
        if deg.get("low_light", 0) > 0.6:
            recs.append("apply low-light boost")
        if deg.get("temporal_inconsistency", 0) > 0.5:
            recs.append("enable temporal smoothing")
        if plan.get("content_analysis", {}).get("face_prominence", 0) > 0.03:
            recs.append("enable face restoration expert")
        if not recs:
            recs.append("video quality acceptable; standard enhancement")
        return recs

    def _estimate_resources(self, task: TaskSpecification, plan: dict) -> dict:
        content = plan.get("content_analysis", {})
        frames = content.get("frame_count", task.video_specs.frame_count) or 1
        h, w = content.get("resolution", [task.video_specs.height or 720,
                                          task.video_specs.width or 1280])
        primary = plan.get("expert_routing", {}).get("primary_model", "vsrm")
        # seconds per minute of video
        per_min = {"vsrm": 120, "seedvr2": 180, "ditvr": 150,
                   "fast_mamba_vsr": 60}.get(primary, 90)
        fps = content.get("fps", 24.0) or 24.0
        minutes = frames / fps / 60.0
        mem_gb = min(2.0 + (h * w) / (1920 * 1080) * 4.0, 24.0)
        return {
            "estimated_time_sec": max(per_min * minutes, 1.0),
            "estimated_device_memory_gb": mem_gb,
            "primary_model": primary,
        }
