"""VideoEnhancementAgent: task dispatch onto the port's handlers.

Counterpart of video_enhancer_tpu/agents/enhancer.py: the task kinds it
takes, the model-selection tree (``select_model``, unchanged), per-model
usage counts and a small synthetic timing (``benchmark_models``, in torch on
the agent's device). ``_execute`` runs ``build_handler(model, policy,
device).enhance_video``, or ``RIFEHandler.interpolate_video`` for frame
interpolation, on the card unless the agent was made with ``device="cpu"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.registry import build_handler, probe_available
from .base import AgentCapabilities, BaseAgent, ProcessingResult
from .task_spec import Quality, TaskSpecification, TaskType

__all__ = ["VideoEnhancementAgent"]

_TASKS = {
    TaskType.VIDEO_ENHANCEMENT,
    TaskType.QUALITY_RESTORATION,
    TaskType.ZERO_SHOT_ENHANCEMENT,
    TaskType.FAST_ENHANCEMENT,
    TaskType.FRAME_INTERPOLATION,
}


class VideoEnhancementAgent(BaseAgent):
    def __init__(self, agent_id: str = "video_enhancer_sota", policy=None,
                 device: str | torch.device | None = None):
        super().__init__(
            agent_id,
            AgentCapabilities(task_types=set(_TASKS), max_concurrent_tasks=2),
        )
        self.policy = policy
        self.device = resolve_device(device)
        self.available = probe_available(policy)
        self.model_usage: dict[str, int] = {}

    # -- model selection (reference video_enhancer_sota.py:276-314) --------
    def select_model(self, task: TaskSpecification,
                     analysis: dict | None = None) -> str:
        deg = (analysis or {}).get("degradations", {})
        content = (analysis or {}).get("content_analysis", {})

        def ok(n):
            return n in self.available

        # Explicit preference bypasses quality qualification (but not
        # enabled/importable probing): qualification gates automatic
        # dispatch, never user intent (runtime/qualification.py).
        if task.model_preference and (
                ok(task.model_preference)
                or task.model_preference in probe_available(
                    self.policy, include_disqualified=True)):
            return task.model_preference
        if task.task_type == TaskType.FAST_ENHANCEMENT or \
                task.quality == Quality.FAST:
            if ok("fast_mamba_vsr"):
                return "fast_mamba_vsr"
        if task.task_type == TaskType.FRAME_INTERPOLATION:
            return "rife"
        if task.task_type == TaskType.QUALITY_RESTORATION and ok("seedvr2"):
            return "seedvr2"
        if task.task_type == TaskType.ZERO_SHOT_ENHANCEMENT and ok("ditvr"):
            return "ditvr"
        if deg.get("unknown", 0) > 0.6 and ok("ditvr"):
            return "ditvr"
        if content.get("motion_complexity", 0) > 0.7 and ok("vsrm"):
            return "vsrm"
        if task.requires_upscaling() and ok("realesrgan") and \
                task.video_specs.frame_count <= 1:
            return "realesrgan"
        # Default (the reference defaults to realesrgan,
        # video_enhancer_sota.py:313-314; ours prefers the temporal model).
        for cand in ("vsrm", "fast_mamba_vsr", "realesrgan", "cnn_upscaler",
                     "bicubic"):
            if ok(cand):
                return cand
        return "bicubic"

    def _execute(self, task: TaskSpecification) -> ProcessingResult:
        analysis = task.params.get("analysis")
        model = self.select_model(task, analysis)
        self.model_usage[model] = self.model_usage.get(model, 0) + 1

        if task.task_type == TaskType.FRAME_INTERPOLATION:
            from ..runtime.rife_handler import RIFEHandler

            stats = RIFEHandler(device=self.device).interpolate_video(
                task.input_path, task.output_path,
                interpolation_factor=int(task.params.get(
                    "interpolation_factor", 2)),
            )
        else:
            handler = build_handler(model, self.policy, device=self.device)
            stats = handler.enhance_video(task.input_path, task.output_path)
        return ProcessingResult(
            task_id=task.task_id,
            status="success" if stats.get("status") == "success" else "failed",
            output_path=stats.get("output_path"),
            metrics={**stats, "model_used": model},
        )

    @torch.inference_mode()
    def benchmark_models(self, size_hw=(64, 64), frames: int = 4) -> dict:
        """Tiny synthetic per-model timing (reference
        video_enhancer_sota.py:388-398), on the agent's device."""
        results = {}
        clip = torch.from_numpy(np.random.default_rng(0).random(
            (frames, *size_hw, 3), np.float32)).to(self.device)
        for name in sorted(self.available):
            if name in ("rife",):
                continue
            try:
                h = build_handler(name, self.policy, device=self.device)
                t0 = time.time()
                if hasattr(h, "process_clip"):
                    h.process_clip(clip)
                else:
                    h.process_frames(clip)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                results[name] = {"sec": time.time() - t0, "ok": True}
            except Exception as e:
                results[name] = {"ok": False, "error": str(e)}
        return results
