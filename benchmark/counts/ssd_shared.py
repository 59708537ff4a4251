"""The SSD scan with B/C shared by the heads (the program's
``csrc/ssd_shared.cu``). Shape ``(b, L, H, P, N, chunk)``.

Operations: the JAX package's count of one call, frozen here, in chunks of
``Q = min(chunk, largest power of two <= min(L, chunk))``: per (batch,
chunk) the C B^T product (2 Q^2 N, shared by the heads), per head the
intra-chunk product (2 Q^2 P), the cumulative decays (2 Q^2) and the
inter-chunk state product and update (4 Q N P). In half precision the
kernel runs them on the tensor cores.

Bytes: x read and y written in the served dtype, B and C read in it, dt
read in float32, each once.
"""

NAMES = ("ssd_run_kernel", "ssd_state_pass_kernel", "ssd_chunk_state_kernel",
         "ssd_chunk_output_kernel")


def rate(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def flops(shape) -> float:
    b, L, H, P, N, chunk = shape
    q = 1
    while q * 2 <= min(L, chunk):
        q *= 2
    Q = min(chunk, q)
    K = -(-L // Q)
    return b * K * (2.0 * Q * Q * N + H * (2.0 * Q * Q * (P + 1)
                                           + 4.0 * Q * N * P))


def bytes(shape, itemsize: int) -> float:
    b, L, H, P, N, _ = shape
    return b * L * (2 * H * P * itemsize + 2 * N * itemsize + H * 4)
