"""The fused bidirectional shared-stream SSM of the temporal mixer (the
program's ``csrc/fused_bissm.cu``). Shape ``(B, L, D, N, K, dt_rank)``.

Operations: the JAX package's count of one call, frozen here: two
selective scans (9 a step and state, 2 a step for the D skip), the
depthwise conv of K taps, x_proj to dt_rank + 2N, dt_proj and the SiLU and
gate epilogue. The kernel runs them on the CUDA cores in float32.

Bytes: the two inputs read and the output written in the served dtype,
and the weights read once.
"""

NAMES = ("fused_bissm_kernel",)


def rate(itemsize: int) -> str:
    return "fp32"


def flops(shape) -> float:
    B, L, D, N, K, dt_rank = shape
    scans = 2 * (9.0 * B * L * D * N + 2.0 * B * L * D)
    R = dt_rank + 2 * N
    return (scans + 2.0 * B * L * D * K + 2.0 * B * L * D * R
            + 2.0 * B * L * dt_rank * D + 8.0 * B * L * D)


def bytes(shape, itemsize: int) -> float:
    B, L, D, N, K, dt_rank = shape
    weights = D * (K + dt_rank + 2 * N + dt_rank + 7 + 2 * N)
    return 3.0 * B * L * D * itemsize + weights * itemsize
