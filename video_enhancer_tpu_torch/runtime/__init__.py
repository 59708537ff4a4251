"""Serving runtime of the port (counterparts of video_enhancer_tpu.runtime)."""
