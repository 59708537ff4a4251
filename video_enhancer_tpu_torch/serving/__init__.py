"""Serving layer of the port: the REST job server over stdlib HTTP and its
UI page (counterpart of video_enhancer_tpu/serving/)."""

from .http import Request, Response, Router  # noqa: F401
