"""The time axis on ``torch.distributed``: the exact T-sharded scans and
model inference (counterpart of video_enhancer_tpu.parallel)."""
