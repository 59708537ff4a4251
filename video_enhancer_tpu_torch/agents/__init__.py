"""Agent layer of the port (counterpart of video_enhancer_tpu/agents/):
the task vocabulary, the base agent, and the enhancement, analysis,
quality-assessment and coordinator agents over the asyncio message broker
with its heartbeat registry. Every agent that touches frames runs on the
card unless it is made with ``device="cpu"``."""

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
from .analyzer import VideoAnalyzerAgent  # noqa: F401
from .quality import QualityAssessmentAgent  # noqa: F401
from .coordinator import CoordinatorAgent  # noqa: F401
from .communication import (  # noqa: F401
    AgentCommunicationSystem,
    AgentRegistry,
    MessageBroker,
)
