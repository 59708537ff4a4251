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

import torch

from .device import resolve_device

__all__ = ["resolve_device"]

# torch's CPU exp, tanh, log and their kin call MKL's vector math (VML),
# which sets itself up on its first call. When that first call comes from
# several OpenMP threads at once (one op over more than 2048 elements),
# some threads' chunks can come back off by up to ~1e-4 relative. One call
# below the parallel grain, at import, makes the set-up happen on one
# thread before any op of the port runs on the CPU.
torch.exp(torch.zeros(1))
