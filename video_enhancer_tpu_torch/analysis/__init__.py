"""Analysis and routing of the port (counterpart of video_enhancer_tpu.analysis)."""

from .router import DegradationRouter

__all__ = ["DegradationRouter"]
