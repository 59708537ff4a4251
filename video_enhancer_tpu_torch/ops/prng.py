"""JAX's normal draw, ``jax.random.normal(jax.random.PRNGKey(seed), shape,
dtype)``, in torch ops.

seedvr2 adds noise drawn this way to every window (the JAX package's
models/seedvr2.py:252-262 and models/diffusion.py:117). The replica follows
JAX 0.9.0 with ``jax_threefry_partitionable`` on:

- the key of ``PRNGKey(seed)`` is the pair (0, seed);
- element i of the row-major flat array hashes the pair (i >> 32, i & M)
  with Threefry-2x32 (20 rounds, jax/_src/prng.py:883-932); its bits are
  the two words xor-ed (:1184-1201), and for bf16, whose 7 mantissa bits
  are fewer than 8, their low byte (random.py:455-459);
- the uniform on [nextafter(-1, 0), 1) takes the top mantissa bits under
  the exponent of 1.0, subtracts 1, scales and shifts, each op rounded in
  the target dtype (jax/_src/random.py:435-477);
- the normal is sqrt(2) erfinv(u) (:867-872), erfinv by XLA's
  single-precision polynomial (Giles, "Approximating the erfinv
  function"), in fp32 for every dtype and rounded once to the target.

The hash runs on int64 lanes masked to 32 bits, so it needs no unsigned
dtype and runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry_bits", "uniform", "normal"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_BITS_DTYPE = {32: torch.int32, 16: torch.int16}   # a float's bits, viewed
_WIDTHS = (32, 8)

# XLA's erfinv coefficients, highest power first, for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1: Cephes' rational, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's logf (Cephes, as Eigen's plog): the polynomial on [sqrt(1/2) - 1,
# sqrt(2) - 1] and ln 2 in two parts
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4


def _f32(c: float) -> float:
    return float(np.float32(c))


def _mad(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in fp32 with one rounding, as a fused multiply-add:
    the product of two fp32 values is exact in fp64."""
    return (a.double() * (b.double() if torch.is_tensor(b) else b)
            + (c.double() if torch.is_tensor(c) else c)).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _mad(p, x, _f32(c))
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's fp32 log of a positive value: split off the exponent, fold
    the mantissa to [sqrt(1/2), sqrt(2)), a degree-8 polynomial."""
    x = torch.clamp(x, min=torch.finfo(torch.float32).tiny)
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    P = [_f32(c) for c in _LOG_P]
    y = _mad(_mad(torch.full_like(m, P[0]), m, P[1]), m, P[2])
    y1 = _mad(_mad(torch.full_like(m, P[3]), m, P[4]), m, P[5])
    y2 = _mad(_mad(torch.full_like(m, P[6]), m, P[7]), m, P[8])
    y = _mad(_mad(y, x3, y1), x3, y2) * x3
    y = _mad(e, _f32(_LN2_LO), y)
    m = _mad(x2, -0.5, m) + y
    return _mad(e, _LN2_HI, m)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 log1p: Cephes' rational below sqrt(2) - 1 in magnitude,
    log(1 + x) above."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_NUM)
                                        / _horner(x, _LOG1P_DEN)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _log(x + 1.0))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry_bits(seed: int, shape, bits: int = 32,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.bits``' words for ``PRNGKey(seed)`` as an int64 tensor of
    ``shape`` holding values below 2 ** ``bits`` (32 or 8)."""
    if bits not in _WIDTHS:
        raise ValueError(f"bits must be one of {_WIDTHS}, got {bits}")
    k0, k1 = 0, int(seed) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0 = ((idx >> 32) + ks[0]) & _M32
    x1 = ((idx & _M32) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    out = (x0 ^ x1) & ((1 << bits) - 1)
    return out.reshape(tuple(shape))


def uniform(seed: int, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape, dtype, minval, maxval)``
    for fp32 and bf16."""
    nbits = torch.finfo(dtype).bits
    nmant = {torch.float32: 23, torch.bfloat16: 7}.get(dtype)
    if nmant is None:
        raise ValueError(f"uniform takes float32 or bfloat16, got {dtype}")
    rng_bits = 8 if nmant < 8 else nbits               # bf16 draws 8 bits
    one = int(np.array(1.0, np.float32).view(np.int32)) >> (32 - nbits)
    raw = threefry_bits(seed, shape, rng_bits, device)
    fbits = (raw >> (rng_bits - nmant)) | one
    floats = fbits.to(_BITS_DTYPE[nbits]).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 erfinv: w = -log1p(-x^2); a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    w = -_log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _f32(_ERFINV_SMALL[0]), _f32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _mad(p, w, torch.where(small, _f32(cs), _f32(cl)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(seed: int, shape, dtype: torch.dtype = torch.float32,
           device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape, dtype)`` for fp32 and
    bf16."""
    lo = -(1.0 - torch.finfo(dtype).eps / 2)     # nextafter(-1, 0)
    u = uniform(seed, shape, dtype, lo, 1.0, device)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=dtype, device=device)
    return sqrt2 * _erfinv(u.float()).to(dtype)
