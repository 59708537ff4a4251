"""Tensor ops of the port (counterparts of video_enhancer_tpu.ops)."""
