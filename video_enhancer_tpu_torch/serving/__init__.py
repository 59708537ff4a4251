"""Serving layer of the port: the REST job server over stdlib HTTP
(counterpart of video_enhancer_tpu/serving/; its UI is not ported yet)."""

from .http import Request, Response, Router  # noqa: F401
