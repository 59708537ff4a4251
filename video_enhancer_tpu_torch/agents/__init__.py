"""Agent layer of the port: the task vocabulary, the base agent and the
enhancement agent the REST job server drives (counterpart of
video_enhancer_tpu/agents/; its analyzer, quality, coordinator and
communication agents are not ported yet)."""

from .task_spec import (  # noqa: F401
    Priority,
    ProcessingConstraints,
    Quality,
    TaskSpecification,
    TaskType,
    VideoSpecs,
)
from .base import AgentCapabilities, BaseAgent, ProcessingResult  # noqa: F401
from .enhancer import VideoEnhancementAgent  # noqa: F401
