"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W limit): the yardstick of every
share of a roofline or of the peak."""

FLOPS = {
    "bf16": 989e12,       # tensor cores, bf16 / fp16 operands
    "fp32": 67e12,        # CUDA cores, float32
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, rate: str) -> float:
    """The least time a call could take: the larger of its operations over
    the peak at ``rate`` and its bytes over the memory bandwidth."""
    return max(flops / FLOPS[rate], nbytes / HBM_BYTES_PER_S)
