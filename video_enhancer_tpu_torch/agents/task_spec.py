"""Task specification: a copy of video_enhancer_tpu/agents/task_spec.py
(standard library only).

Same vocabulary as the reference's agents/core/task_specification.py: TaskType (8 kinds, reference task_specification.py:34-43),
Priority/Quality enums, VideoSpecs, ProcessingConstraints, validation,
complexity estimation (:191-234) and dict round-tripping (:236-295).
"""

from __future__ import annotations

import dataclasses
import enum
import time
import uuid
from typing import Any


class TaskType(str, enum.Enum):
    VIDEO_ENHANCEMENT = "video_enhancement"
    VIDEO_ANALYSIS = "video_analysis"
    QUALITY_ASSESSMENT = "quality_assessment"
    QUALITY_RESTORATION = "quality_restoration"
    ZERO_SHOT_ENHANCEMENT = "zero_shot_enhancement"
    FAST_ENHANCEMENT = "fast_enhancement"
    FRAME_INTERPOLATION = "frame_interpolation"
    FACE_RESTORATION = "face_restoration"


class Priority(int, enum.Enum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    URGENT = 3


class Quality(str, enum.Enum):
    FAST = "fast"
    BALANCED = "balanced"
    HIGH = "high"
    ULTRA = "ultra"


@dataclasses.dataclass
class VideoSpecs:
    width: int = 0
    height: int = 0
    fps: float = 0.0
    frame_count: int = 0
    duration_sec: float = 0.0
    codec: str = ""

    @property
    def resolution_class(self) -> str:
        pixels = self.width * self.height
        if pixels >= 3840 * 2160:
            return "4k+"
        if pixels >= 1920 * 1080:
            return "1080p"
        if pixels >= 1280 * 720:
            return "720p"
        return "sd"


@dataclasses.dataclass
class ProcessingConstraints:
    max_memory_gb: float | None = None
    max_time_sec: float | None = None
    device_required: bool = False
    precision: str = "bfloat16"
    tile_size: int | None = None
    overlap: int | None = None
    latency_class: str = "standard"


@dataclasses.dataclass
class TaskSpecification:
    task_type: TaskType = TaskType.VIDEO_ENHANCEMENT
    input_path: str = ""
    output_path: str = ""
    task_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    priority: Priority = Priority.NORMAL
    quality: Quality = Quality.BALANCED
    video_specs: VideoSpecs = dataclasses.field(default_factory=VideoSpecs)
    constraints: ProcessingConstraints = dataclasses.field(
        default_factory=ProcessingConstraints
    )
    target_fps: float | None = None
    target_resolution: tuple[int, int] | None = None  # (H, W)
    scale_factor: int | None = None
    model_preference: str | None = None
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)

    # -- validation (reference task_specification.py:127-167) --------------
    def validate(self) -> list[str]:
        errors = []
        if not self.input_path:
            errors.append("input_path is required")
        if self.task_type in (TaskType.VIDEO_ENHANCEMENT,
                              TaskType.QUALITY_RESTORATION,
                              TaskType.FAST_ENHANCEMENT,
                              TaskType.ZERO_SHOT_ENHANCEMENT) \
                and not self.output_path:
            errors.append(f"output_path required for {self.task_type.value}")
        if self.scale_factor is not None and self.scale_factor not in (1, 2, 4, 8):
            errors.append(f"invalid scale_factor {self.scale_factor}")
        if self.target_fps is not None and not (0 < self.target_fps <= 240):
            errors.append(f"invalid target_fps {self.target_fps}")
        return errors

    # -- derived (reference :169-234) --------------------------------------
    def get_scale_factor(self) -> int:
        if self.scale_factor:
            return self.scale_factor
        if self.target_resolution and self.video_specs.height:
            ratio = self.target_resolution[0] / self.video_specs.height
            for s in (8, 4, 2):
                if ratio >= s * 0.75:
                    return s
        return 2

    def requires_upscaling(self) -> bool:
        return self.get_scale_factor() > 1

    def estimate_complexity(self) -> float:
        """0..1 score combining pixels, frames, quality tier (reference
        task_specification.py:191-234)."""
        px = self.video_specs.width * self.video_specs.height
        px_score = min(px / (3840 * 2160), 1.0)
        frames_score = min(self.video_specs.frame_count / 3600.0, 1.0)
        q_score = {"fast": 0.2, "balanced": 0.5, "high": 0.8, "ultra": 1.0}[
            self.quality.value
        ]
        s_score = min(self.get_scale_factor() / 8.0, 1.0)
        return min(
            0.35 * px_score + 0.25 * frames_score + 0.25 * q_score
            + 0.15 * s_score,
            1.0,
        )

    # -- serialization (reference :236-295) --------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["task_type"] = self.task_type.value
        d["priority"] = self.priority.value
        d["quality"] = self.quality.value
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TaskSpecification":
        d = dict(d)
        if "task_type" in d:
            d["task_type"] = TaskType(d["task_type"])
        if "priority" in d:
            d["priority"] = Priority(d["priority"])
        if "quality" in d:
            d["quality"] = Quality(d["quality"])
        if isinstance(d.get("video_specs"), dict):
            d["video_specs"] = VideoSpecs(**d["video_specs"])
        if isinstance(d.get("constraints"), dict):
            d["constraints"] = ProcessingConstraints(**d["constraints"])
        if isinstance(d.get("target_resolution"), list):
            d["target_resolution"] = tuple(d["target_resolution"])
        return cls(**d)
