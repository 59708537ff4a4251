"""Frame IO of the port (counterparts of video_enhancer_tpu.io)."""
