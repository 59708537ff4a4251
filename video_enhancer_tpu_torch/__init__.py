"""PyTorch/CUDA port of video_enhancer_tpu for an NVIDIA H100.

A package of its own beside the JAX package, which stays the reference:
the port imports ``torch`` and never ``jax`` or anything of
``video_enhancer_tpu``; it reads that package's bundled weights as data
files. Its entry point is ``runtime.registry.build_handler("vsrm")``; it
runs on the card unless the caller passes ``device="cpu"``.

The TPU's Pallas kernels on this path are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use (kernels.py). Each has a plain
PyTorch version beside its wrapper (ops/ssd.py, ops/scan.py).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
