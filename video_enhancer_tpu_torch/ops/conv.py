"""Convolutions in the JAX package's channels-last layouts.

Counterpart of the plain parts of video_enhancer_tpu/ops/conv.py. Layouts
at the public functions stay those of the JAX package: frames ``(B, H, W,
C)``, clips ``(B, T, H, W, C)``, sequences ``(B, L, C)``. Weights are in
PyTorch's layout (runtime/weights.py converts the bundled checkpoints).
Padding is XLA's SAME (``depthwise_conv1d`` also takes explicit padding):
at stride s an axis of n gives ceil(n / s) outputs and is padded by
``total = max((ceil(n / s) - 1) s + k - n, 0)``, ``lo = total // 2``,
``hi = total - lo``. At stride 1 that is ``lo = (k - 1) // 2``; at k 3,
stride 2 and an even n it is (0, 1), which torch's symmetric ``padding``
cannot give, so such axes are padded explicitly.

``conv2d`` also takes a stride with explicit padding ``((lo, hi), (lo,
hi))`` (the official IFNet's stride-2 convs pad (1, 1) as torch does, not
SAME). ``conv_transpose2d`` is torch's ``ConvTranspose2d(stride,
padding)`` on a weight in its own layout ``(Cin, Cout, kh, kw)``, which is
what video_enhancer_tpu/models/official_arch.py:133-151 computes from the
same checkpoint.

``conv_transpose3d`` is ``lax.conv_transpose`` with "SAME" (the kernel not
flipped): a conv over the input dilated by the stride, padded ``(k - 1, 1)``
at stride 2 and ``(k // 2, k // 2)`` at stride 1 (k 3).

``depthwise_conv1d_silu`` is SiLU of the SAME depthwise conv in one pass:
for a CUDA tensor it launches the port's kernel (csrc/dwconv_silu.cu, the
counterpart of TPU kernel ``_dwconv_silu_kernel``), for a CPU tensor it
takes ``depthwise_conv1d_silu_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .vjp import kernel_vjp

__all__ = ["conv2d", "conv3d", "conv_transpose2d", "conv_transpose3d",
           "depthwise_conv2d", "depthwise_conv1d",
           "depthwise_conv1d_silu", "depthwise_conv1d_silu_plain"]


def _same(k: int, n: int = 0, s: int = 1) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0) if s > 1 else k - 1
    return total // 2, total - total // 2


def _triple(v) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding="SAME", groups: int = 1) -> torch.Tensor:
    """``x (B, H, W, Cin)``, ``w (Cout, Cin / groups, kh, kw)`` -> ``(B, H',
    W', Cout)``: SAME padding (at stride 2 and k 3 on an even side, (0, 1)),
    or ``padding`` ``((lo, hi), (lo, hi))``, at any stride."""
    if stride == 1 and padding == "SAME":
        return conv3d(x[:, None], w[:, :, None], b, groups=groups)[:, 0]
    if padding == "SAME":
        padding = [_same(k, n, stride) for k, n in zip(w.shape[2:],
                                                       x.shape[1:3])]
    (t, bo), (le, ri) = padding
    xi = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo))
    out = F.conv2d(xi, w.to(x.dtype), None if b is None else b.to(x.dtype),
                   stride=stride, groups=groups)
    return out.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 1,
                     padding="SAME") -> torch.Tensor:
    """One filter per channel: ``x (B, H, W, C)``, ``w (C, 1, kh, kw)``
    (the JAX package's ``(kh, kw, 1, C)`` in Conv2d's layout,
    ops/conv.py:116-124 there)."""
    return conv2d(x, w, b, stride, padding, groups=x.shape[-1])


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """Torch's ``ConvTranspose2d(Cin, Cout, k, stride, padding)``: ``x (B, H,
    W, Cin)``, ``w (Cin, Cout, kh, kw)`` -> ``(B, H', W', Cout)``."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                             None if b is None else b.to(x.dtype),
                             stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           groups: int = 1, stride=1) -> torch.Tensor:
    """``x (B, T, H, W, Cin)``, ``w (Cout, Cin / groups, kt, kh, kw)`` ->
    ``(B, T, H, W, Cout)`` (H, W divided by the stride, rounded up). A
    temporal kernel of 1 at stride 1 makes it a 2-D conv over the B*T
    frames: the channels-last input is handed to cuDNN as an NCHW view with
    channels-last strides, so no transpose is materialised. A ``(kt, 1,
    1)`` kernel at stride 1 (fast_mamba_vsr's temporal residual, seedvr2's
    fuse) is ``_temporal_conv``; any other kernel or stride is
    ``_conv3d``."""
    stride = _triple(stride)
    kt, kh, kw = w.shape[2:]
    if stride != (1, 1, 1) or (kt != 1 and (kh, kw) != (1, 1)):
        return _conv3d(x, w, b, groups, stride)
    if kt != 1:
        if groups != 1:
            raise ValueError(f"a (kt, 1, 1) conv takes no groups, got "
                             f"{groups}")
        return _temporal_conv(x, w, b)
    B, T, H, W, C = x.shape
    kh, kw = w.shape[3], w.shape[4]
    xi = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = _same(kh), _same(kw)
    if ph0 == ph1 and pw0 == pw1:
        pad = (ph0, pw0)
    else:
        xi = F.pad(xi, (pw0, pw1, ph0, ph1))
        pad = (0, 0)
    out = F.conv2d(xi, w[:, :, 0].to(x.dtype),
                   None if b is None else b.to(x.dtype), padding=pad,
                   groups=groups)
    return out.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


def _conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            groups: int, stride: tuple[int, int, int]) -> torch.Tensor:
    """The general case through ``F.conv3d`` on an NCDHW view of the
    channels-last clip, XLA's SAME padding (explicit where it is not
    symmetric)."""
    pads = [_same(k, n, s) for k, n, s in zip(w.shape[2:], x.shape[1:4],
                                               stride)]
    xi = x.permute(0, 4, 1, 2, 3)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xi = F.pad(xi, [p for lo_hi in reversed(pads) for p in lo_hi])
        pad = (0, 0, 0)
    out = F.conv3d(xi, w.to(x.dtype), None if b is None else b.to(x.dtype),
                   stride=stride, padding=pad, groups=groups)
    return out.permute(0, 2, 3, 4, 1)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None,
                     stride=(1, 2, 2)) -> torch.Tensor:
    """``lax.conv_transpose(x, w, stride, "SAME")`` of the JAX package
    (ops/conv.py:152-170) for k 3 and strides of 1 or 2: ``x (B, T, H, W,
    Cin)``, ``w (Cout, Cin, 3, 3, 3)`` (the checkpoint's DHWIO kernel in
    Conv3d's layout, not flipped) -> ``(B, s T, s H, s W, Cout)``. Torch's
    ``conv_transpose3d`` flips the kernel and pads both ends alike, so it
    takes the kernel flipped with in and out swapped and no padding at
    stride 2, and each stride-2 axis keeps its first ``2 n`` outputs (of ``2
    n + 1``)."""
    stride = _triple(stride)
    if tuple(w.shape[2:]) != (3, 3, 3) or not set(stride) <= {1, 2}:
        raise ValueError(f"conv_transpose3d takes a 3x3x3 kernel and "
                         f"strides of 1 or 2, got {tuple(w.shape)}, {stride}")
    wt = w.flip(2, 3, 4).transpose(0, 1).to(x.dtype)   # (Cin, Cout, k...)
    out = F.conv_transpose3d(
        x.permute(0, 4, 1, 2, 3), wt, None if b is None else b.to(x.dtype),
        stride=stride, padding=tuple(1 if s == 1 else 0 for s in stride))
    T, H, W = (s * n for s, n in zip(stride, x.shape[1:4]))
    return out[:, :, :T, :H, :W].permute(0, 2, 3, 4, 1)


def _temporal_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """A ``(kt, 1, 1)`` conv over the frames, SAME (zero) padding: per tap,
    a channel product of the shifted clip, summed in fp32 and cast back, as
    the JAX package's ``_tiny_temporal_conv3d`` (ops/conv.py:80-113)."""
    kt, t = w.shape[2], x.shape[1]
    lo, hi = _same(kt)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, 0, lo, hi))
    wf = w[:, :, :, 0, 0].float()                        # (Cout, Cin, kt)
    acc = 0.0 if b is None else b.float()
    for k in range(kt):
        acc = acc + torch.einsum("bthwc,dc->bthwd", xf[:, k:k + t], wf[..., k])
    return acc.to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None,
                     padding="SAME") -> torch.Tensor:
    """Depthwise conv over a sequence: ``x (B, L, C)``, ``w (C, 1, k)``.
    ``padding`` is ``"SAME"`` or the JAX package's explicit ``((lo, hi),)``
    (ssm's causal ``((k - 1, 0),)`` and anti-causal ``((0, k - 1),)``).
    Computed in fp32 and cast back to ``x``'s dtype, as the JAX package's
    conv accumulates in fp32 (ops/conv.py:126-149). The result is
    contiguous in every dtype: a half-precision cast makes it so in one
    pass, and for fp32 input, where the cast copies nothing, the trailing
    ``contiguous()`` copies the transposed view (the SSD kernel reads rows
    in place)."""
    C, k = w.shape[0], w.shape[2]
    (lo, hi), = [_same(k)] if padding == "SAME" else padding
    xi = F.pad(x.float().transpose(1, 2), (lo, hi))
    out = F.conv1d(xi, w.float(), None if b is None else b.float(), groups=C)
    return out.transpose(1, 2).to(
        x.dtype, memory_format=torch.contiguous_format).contiguous()


def depthwise_conv1d_silu_plain(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """``silu(depthwise_conv1d(x, w, b, SAME))`` with the conv and the SiLU
    in fp32 and one cast to x's dtype, as the JAX package's
    ``_dwconv_silu_ref`` (ops/conv.py:246-249). (bissd's grouped path casts
    the conv to x's dtype before the SiLU, so in bf16 the two differ by a
    rounding, as they do in JAX.)"""
    return F.silu(depthwise_conv1d(x.float(), w.float(), b)).to(x.dtype)


# The conv kernel's launch arithmetic (csrc/dwconv_silu.cu), pure Python so
# that the CPU tests reach it.
_DW_MAX_K = 8              # most taps (compiled: 4, 5 exactly; 8 with a bound)
_DW_RUN = 16               # output rows a thread computes
_DW_STAGES = 3             # input tiles in the ring
_DW_OUTS = 2               # output tiles
_DW_MAX_UNITS = 256        # threads a row of a slab (VEC channels each)
_DW_MAX_THREADS = 320      # two blocks an SM at up to 96 registers
_DW_MAX_RUNS = 16          # so that a tile is at most 256 rows
_SMEM_BLOCK = 232448       # dynamic shared memory a block may use (H100)
_SMEM_SM = 233472          # shared memory of an SM; each block takes 1 KB more


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dwconv_smem(item: int, ct: int, K: int, runs: int) -> int:
    """Bytes of dynamic shared memory of a block (csrc/dwconv_silu.cu
    ``smem_bytes``): three input tiles of ``runs * 16 + kt - 1`` staged rows
    (kt the taps compiled: 4 or 5, else 8) and two output tiles of ``runs *
    16`` rows, each row the 16-byte chunks that cover a slab's ``ct *
    item`` bytes from any start."""
    kt = K if K in (4, 5) else _DW_MAX_K
    rows = runs * _DW_RUN
    return ((_DW_STAGES * (rows + kt - 1) + _DW_OUTS * rows)
            * _up(ct * item + 16 - item, 16))


def _dwconv_plan(B: int, L: int, C: int, K: int, ld: int, item: int,
                 ptr: int, sms: int) -> dict:
    """The conv kernel's launch for x ``(B, L, C)`` with row stride ``ld``
    (elements) at address ``ptr``: VEC, 2 channels a thread when bf16/fp16
    rows allow 4-byte reads (C, ld even, x on 4 bytes), else 1; slabs of at
    most 256 threads' channels, balanced; the runs of 16 rows a tile (the
    fewest that give whole warps and at least 256 threads, else the best
    warp fill, at most 320 threads); blocks an SM by shared memory and
    threads; one wave of blocks, each a contiguous range of tiles. Raises
    ValueError for what the kernel does not take."""
    if min(B, L, C, K) < 1 or K > _DW_MAX_K:
        raise ValueError(f"kernel takes K <= {_DW_MAX_K}, got B={B} L={L} "
                         f"C={C} K={K}")
    vec = 2 if (item == 2 and C % 2 == 0 and ld % 2 == 0
                and ptr % 4 == 0) else 1
    slabs = -(-(C // vec) // _DW_MAX_UNITS)
    units = -(-(C // vec) // slabs)
    cands = range(1, min(_DW_MAX_RUNS, _DW_MAX_THREADS // units) + 1)
    whole = [r for r in cands if units * r % 32 == 0 and units * r >= 256]
    runs = whole[0] if whole else max(
        cands, key=lambda r: (units * r / _up(units * r, 32), r))
    ct = units * vec
    smem = _dwconv_smem(item, ct, K, runs)
    threads = units * runs
    per_sm = min(_SMEM_SM // (smem + 1024), 2048 // threads, 32)
    rows = runs * _DW_RUN
    tiles = B * -(-L // rows) * -(-C // ct)
    if tiles >= 2 ** 31:
        raise ValueError(f"kernel takes fewer than 2**31 tiles of {rows} "
                         f"rows, got B={B} L={L} C={C}")
    return {"vec": vec, "kt": K if K in (4, 5) else _DW_MAX_K, "ct": ct,
            "slabs": -(-C // ct), "runs": runs, "rows": rows,
            "threads": threads, "smem": smem, "blocks_per_sm": per_sm,
            "tiles": tiles, "grid": min(tiles, per_sm * sms)}


def _dwconv_silu_cuda(x, w, b):
    if x.ndim != 3:
        raise ValueError(f"x must be (B, L, C), got {tuple(x.shape)}")
    Bsz, L, C = x.shape
    K = w.shape[-1]
    if tuple(w.shape) != (C, 1, K) or tuple(b.shape) != (C,):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} must be "
                         f"({C}, 1, K) and ({C},)")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on one device")
    lib = kernels.library()
    if K > lib.vetk_dwconv_silu_max_k():
        raise ValueError(f"kernel takes K <= {lib.vetk_dwconv_silu_max_k()}, "
                         f"got {K}")
    ld = kernels.row_stride(x, "x")
    code = kernels.dtype_code(x)
    plan = _dwconv_plan(Bsz, L, C, K, ld, x.element_size(), x.data_ptr(),
                        kernels.sm_count(x.device))
    w32 = w.float().reshape(C, K).contiguous()
    b32 = b.float().contiguous()
    y = torch.empty((Bsz, L, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vetk_dwconv_silu(
            code, x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            Bsz, L, C, K, ld, plan["vec"], plan["ct"], plan["runs"],
            plan["grid"], kernels.stream_of(x))
        kernels.launch_counts["dwconv_silu"] += 1
    kernels.check(err, "dwconv_silu")
    return y


def depthwise_conv1d_silu(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """``silu(depthwise_conv1d(x, w, b, SAME))`` in one pass (TPU kernel
    ``_dwconv_silu_kernel``): x ``(B, L, C)`` with any row stride (a column
    slice of a wider projection is read in place), w ``(C, 1, K)``, b
    ``(C,)``; y in x's dtype. Launches the CUDA kernel for a CUDA tensor
    (K <= 8); the plain version for a CPU tensor. Differentiable in x, w
    and b through the plain version (JAX's ``_dwconv_silu_diffable``,
    ops/conv.py:252-268)."""
    return kernel_vjp("depthwise_conv1d_silu", _dwconv_silu_cuda,
                      depthwise_conv1d_silu_plain, x, w, b)
