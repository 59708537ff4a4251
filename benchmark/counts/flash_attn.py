"""Softmax attention without a mask or bias (the program's
``csrc/flash_attn.cu``). Shape ``(B, H, Lq, Dh, Lk)``.

Operations: the two products, 4 B H Lq Lk Dh (the JAX package's count,
frozen here); in half precision on the tensor cores.

Bytes: q read and o written, k and v read, each once, in the served dtype.
"""

NAMES = ("flash_fwd",)


def rate(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def flops(shape) -> float:
    B, H, Lq, Dh, Lk = shape
    return 4.0 * B * H * Lq * Lk * Dh


def bytes(shape, itemsize: int) -> float:
    B, H, Lq, Dh, Lk = shape
    return 2.0 * B * H * (Lq + Lk) * Dh * itemsize
