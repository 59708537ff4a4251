"""PyTorch/CUDA port of video_enhancer_tpu for an NVIDIA H100.

A package of its own beside the JAX package, which stays the reference:
the port imports ``torch`` and never ``jax`` or anything of
``video_enhancer_tpu``; it reads that package's bundled weights and
qualification report as data files. Its entry points run on the card unless
the caller passes ``device="cpu"``:

- ``runtime.pipeline.run_auto_frames`` (frames in memory) and
  ``run_auto_pipeline`` (file to file): the standard-latency auto route,
  degradation scoring -> router -> preprocessing -> primary model (vsrm,
  ditvr, cnn_upscaler or bicubic) -> bicubic on failure;
- ``runtime.registry.build_handler(name)``: one model's serving handler.

The TPU's Pallas kernels on these paths are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use (kernels.py). Each has a plain
PyTorch version beside its wrapper (ops/ssd.py, ops/scan.py,
ops/attention.py).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
