"""Device resolution for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the CPU
with ``device="cpu"``, as the tests do. Without a card they raise: nothing
carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_fp32"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
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
