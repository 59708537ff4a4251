"""Device resolution for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the CPU
with ``device="cpu"``, as the tests do, or ``$VETPU_PLATFORM`` does (the
variable the JAX package's entry points read, video_enhancer_tpu/utils/
jaxenv.py:23): ``cpu`` means the CPU, ``gpu`` or ``cuda`` the card, any
other value raises. A device the caller names wins over the variable.
Without a card they raise: nothing carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["resolve_device", "platform_device", "full_fp32"]


_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def platform_device(platform: str) -> str:
    """The device of a platform name as the JAX package's entry points take
    it (``--platform``, ``$VETPU_PLATFORM``): ``cpu`` or ``cuda`` for
    ``gpu`` / ``cuda``; any other name (``tpu`` among them) raises."""
    if platform.lower() not in _PLATFORMS:
        raise ValueError(f"platform {platform!r}: the port runs on 'cpu' or "
                         f"'gpu' / 'cuda'")
    return _PLATFORMS[platform.lower()]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``$VETPU_PLATFORM``'s device when it is set, else
    ``cuda``; a CUDA device without a card raises."""
    if device is None:
        platform = os.environ.get("VETPU_PLATFORM")
        device = platform_device(platform) if platform else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_fp32():
    """cuDNN's convs and cuBLAS's products in full fp32 within, not TF32
    (cuDNN's convs take TF32 at PyTorch's default): the face nets run in
    fp32, as in the JAX package. The two flags are restored after."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
