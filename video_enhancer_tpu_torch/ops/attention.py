"""Attention: the plain form, the flash kernel's wrapper, the dispatcher,
and per-site short-sequence attention.

Counterpart of video_enhancer_tpu/ops/attention.py:

- ``attention_ref``: logits and softmax in fp32, the probabilities cast to
  ``q``'s dtype, the product with V accumulated in fp32 (:33-46). It is the
  flash kernel's plain version.
- ``flash_attention``: the wrapper of the hand-written CUDA kernel
  (csrc/flash_attn.cu), which replaces the TPU's ``_flash_kernel``. It
  launches the kernel for a CUDA tensor and takes ``attention_ref`` only for
  a tensor on the CPU. No bias, no causal mask.
- ``attention``: the dispatcher (:185-192). It takes the kernel for an
  unbiased CUDA tensor with Lq, Lk >= 256, where the JAX package takes the
  Pallas kernel on the TPU, and ``attention_ref`` otherwise.
- ``window_attention``: the wrapper of the hand-written CUDA kernel
  (csrc/window_attn.cu) that replaces the TPU's ``_window_kernel``
  (:200-303): many short windows ``(nW, H, N, Dh)`` with a per-head bias
  ``(H, N, N)`` shared by every window. ``window_attention_plain`` is its
  plain version, ``attention_ref(..., bias=bias[None])``, the form rvrt
  runs off the TPU (models/rvrt.py:135).
- ``site_attention_ref``: the broadcast form of the JAX package's
  per-site attention (:306-324; it has no kernel): ``q (N, T, C)``, ``k/v
  (N, Tg, C)`` -> ``(N, T, C)``, heads of ``C // heads`` channels.
  ``site_attention`` is it, as in the JAX package (:327-340).

Layout of the first three: ``q (B, H, Lq, Dh)``, ``k/v (B, H, Lk, Dh)``.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..utils.flops import record as flop_record
from .vjp import kernel_vjp

__all__ = ["attention", "attention_ref", "flash_attention", "site_attention",
           "site_attention_ref", "window_attention", "window_attention_plain"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Plain attention; ``bias`` broadcastable to ``(B, H, Lq, Lk)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


# bf16/fp16 kernel (csrc/flash_attn.cu flash_fwd_wgmma): 128 query rows and
# three warpgroups a block, keys in tiles of 128 through a ring of three
# stages, tiles of 64 columns in TMA's 128-byte swizzle
_FLASH_TQ, _FLASH_TK, _FLASH_STAGES, _FLASH_CHUNK = 128, 128, 3, 64
# fp32 kernel (flash_fwd_simt): 64 query rows and 256 threads a block
_SIMT_BQ, _SIMT_BK, _SIMT_THREADS = 64, 64, 256


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _flash_smem(dhp: int, itemsize: int) -> int:
    """Dynamic shared memory of a block (csrc/flash_attn.cu HopSmem::ALLOC
    and smem_bytes)."""
    if itemsize == 4:
        kt_rows = max(dhp, _SIMT_BQ)
        return 4 * (dhp * _SIMT_BQ + kt_rows * (_SIMT_BK + 4) + _SIMT_BK * dhp)
    tile = (dhp // _FLASH_CHUNK) * 128 * 128
    return tile + 2 * _FLASH_STAGES * tile + 8 * (1 + 3 * _FLASH_STAGES) + 1024


def _tma_operand(ptr: int, itemsize: int, Dh: int, extents, strides) -> dict:
    """How TMA reads a (B, H, rows, Dh) operand with a dense last dim:
    ``extents`` and ``strides`` (elements) are (rows, heads, batches). A
    dimension of extent 1 takes a stride past the others (it is never
    stepped). The map's dimensions 1-3 are these in the order of their
    strides (``perm``, 2 bits a dimension: 0 rows, 1 heads, 2 batches).
    ``copy`` when TMA cannot describe it: a base not 16-byte aligned, or a
    stride that is not a positive multiple of 16 bytes."""
    span = max([Dh] + [e * s for e, s in zip(extents, strides) if e > 1])
    span = _up(span, 16 // itemsize)
    st = [s if e > 1 else span for e, s in zip(extents, strides)]
    order = sorted(range(3), key=lambda i: (st[i], i))
    copy = ptr % 16 != 0 or any(
        s <= 0 or (s * itemsize) % 16 for e, s in zip(extents, st) if e > 1)
    return {"copy": copy, "strides": tuple(st),
            "perm": sum(w << (2 * pos) for pos, w in enumerate(order)),
            "dims": (Dh, *(extents[w] for w in order)),
            "stride_bytes": tuple(st[w] * itemsize for w in order)}


def _flash_plan(B: int, H: int, Lq: int, Lk: int, Dh: int, itemsize: int,
                operands: dict) -> dict:
    """The flash kernel's launch. ``operands`` maps q, k, v and o to
    (data_ptr, (batch, head, row) strides in elements). Gives the padded
    head width, the grid, the threads and shared memory of a block, and for
    the bf16/fp16 kernel each operand's TMA map (``tma``: dimension order,
    dims, byte strides, box) and the operands to copy once to a contiguous
    tensor (``copy``). Raises ValueError for what the kernel does not
    take."""
    if Dh % 16 or not 16 <= Dh <= 128:
        raise ValueError(f"kernel takes a head dim that is a multiple of 16 "
                         f"up to 128, got {Dh}")
    if Lq < 1 or Lk < 1 or B * H > 65535:
        raise ValueError(f"kernel takes Lq, Lk >= 1 and B*H <= 65535, got "
                         f"{(B, H, Lq, Lk)}")
    if itemsize == 4:
        dhp = 32 if Dh <= 32 else (64 if Dh <= 64 else 128)
        return {"dhp": dhp, "grid": (-(-Lq // _SIMT_BQ), B * H),
                "threads": _SIMT_THREADS, "smem": _flash_smem(dhp, 4),
                "copy": (), "perms": 0,
                "strides": {n: tuple(st) for n, (_, st) in operands.items()}}
    dhp = 64 if Dh <= 64 else 128
    rows = {"q": Lq, "k": Lk, "v": Lk, "o": Lq}
    box = {"q": _FLASH_TQ, "k": _FLASH_TK, "v": _FLASH_TK, "o": 64}
    tma, perms = {}, 0
    for i, name in enumerate(("q", "k", "v", "o")):
        ptr, (sb, sh, sl) = operands[name]
        t = _tma_operand(ptr, itemsize, Dh, (rows[name], H, B), (sl, sh, sb))
        order = [(t["perm"] >> (2 * pos)) & 3 for pos in range(3)]
        t["box"] = (_FLASH_CHUNK, *(box[name] if w == 0 else 1 for w in order))
        tma[name] = t
        perms |= t["perm"] << (6 * i)
    return {"dhp": dhp, "grid": (-(-Lq // _FLASH_TQ), B * H),
            "threads": 3 * 128, "smem": _flash_smem(dhp, itemsize),
            "stages": _FLASH_STAGES, "tma": tma, "perms": perms,
            "copy": tuple(n for n in ("q", "k", "v", "o") if tma[n]["copy"]),
            "strides": {n: tuple(reversed(tma[n]["strides"])) for n in tma}}


def _flash_operands(**named) -> dict:
    return {n: (t.data_ptr(), tuple(t.stride()[:3])) for n, t in named.items()}


def _flash_cuda(q, k, v, scale: float) -> torch.Tensor:
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be dense, got "
                             f"strides {t.stride()}")
    code = kernels.dtype_code(q)
    # (B, Lq, H, Dh) storage: the caller's transpose back to tokens is free
    o = torch.empty((B, Lq, H, Dh), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    plan = _flash_plan(B, H, Lq, Lk, Dh, q.element_size(),
                       _flash_operands(q=q, k=k, v=v, o=o))
    if plan["copy"]:
        # an operand TMA cannot describe is copied once to a new dense
        # tensor (``contiguous`` would return a misaligned view of one row)
        q, k, v = (t.clone(memory_format=torch.contiguous_format)
                   if n in plan["copy"] else t
                   for n, t in (("q", q), ("k", k), ("v", v)))
        plan = _flash_plan(B, H, Lq, Lk, Dh, q.element_size(),
                           _flash_operands(q=q, k=k, v=v, o=o))
        if plan["copy"]:
            raise RuntimeError(f"flash_attention: {plan['copy']} still "
                               f"need a copy after one")
    strides = [s for n in ("q", "k", "v", "o") for s in plan["strides"][n]]
    lib = kernels.library()
    with torch.cuda.device(q.device):
        err = lib.vetk_flash_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, H, Lq, Lk, Dh, float(scale), *strides,
            plan["perms"], kernels.stream_of(q))
        kernels.launch_counts["flash_attention"] += 1
    kernels.check(err, "flash_attention")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Blockwise attention with an online softmax: the CUDA kernel for a
    CUDA tensor (any strides with a dense head dim), ``attention_ref`` for
    a CPU tensor. ``scale`` defaults to ``Dh ** -0.5``. In bf16 and fp16 the
    kernel reads q, k and v in place through TMA, which needs 16-byte
    aligned bases and strides of multiples of 8 elements (the views of a
    split qkv projection have them); an operand without them is first
    copied once to a contiguous tensor. Records 4 B H Lq Lk Dh FLOPs, the
    JAX package's count. Differentiable in q, k and v through
    ``attention_ref`` (JAX's ``_flash_diffable``, ops/attention.py:165-182).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Lq, Dh = q.shape
    flop_record(4.0 * B * H * Lq * k.shape[2] * Dh)
    return kernel_vjp("flash_attention", _flash_cuda, attention_ref, q, k, v,
                      scale=scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None, scale: float | None = None,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Dispatch: the flash kernel when unbiased and long, else the plain
    form. ``use_kernel=None`` means "on the card"; ``False`` always takes
    the plain form (the reference the kernel is held against)."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    long_seq = q.shape[2] >= 256 and k.shape[2] >= 256
    if bias is None and long_seq and use_kernel:
        return flash_attention(q, k, v, scale=scale)
    return attention_ref(q, k, v, bias=bias, scale=scale)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """Plain windowed attention: ``q/k/v (nW, H, N, Dh)``, ``bias (H, N,
    N)`` added to every window's logits."""
    return attention_ref(q, k, v, bias=bias[None], scale=scale)


_WIN_ROWS = 128                # rows of a window tile (csrc/window_attn.cu ROWS)
_SMEM_SM = 233472              # shared memory of an H100 SM; 1 KB more a block


def _window_smem(dp: int) -> int:
    """Dynamic shared memory of a block of the tensor-core kernel
    (csrc/window_attn.cu ``mma_smem_bytes``): the head's fp32 bias, then
    two ring stages of Q, K and V tiles of (128, dp + 8) half values."""
    return _WIN_ROWS * _WIN_ROWS * 4 + 2 * 3 * _WIN_ROWS * (dp + 8) * 2


def _window_plan(nW: int, H: int, Dh: int, sms: int) -> dict:
    """The half-type kernel's launch: the padded head width (16, 32 or 64),
    its shared memory, the blocks an SM holds by it (2 at Dh <= 16, 1
    above, at most 2 by the kernel's launch bounds), and the windows a
    block (``wpb``), which it stages its head's bias once for: one wave of
    blocks (56 windows a block at rvrt's shape, the fastest of those tried,
    PERF.md). The fp32 kernel takes one window a block and ignores it."""
    dp = 16 if Dh <= 16 else (32 if Dh <= 32 else 64)
    smem = _window_smem(dp)
    per_sm = min(2, _SMEM_SM // (smem + 1024))
    wpb = max(1, -(-nW * H // (per_sm * sms)))
    return {"dp": dp, "smem": smem, "blocks_per_sm": per_sm, "wpb": wpb,
            "grid": (-(-nW // wpb), H)}


def _window_cuda(q, k, v, bias, scale: float) -> torch.Tensor:
    nW, H, N, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias must be (H, N, N) = {(H, N, N)}, got "
                         f"{tuple(bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("q, k, v and bias must be on one device")
    if not (1 <= N <= 128 and 1 <= Dh <= 64 and nW >= 1 and H <= 65535):
        raise ValueError(f"kernel takes N <= 128, Dh <= 64 and H <= 65535, "
                         f"got (nW, H, N, Dh) = {(nW, H, N, Dh)}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    b32 = bias.float().contiguous()
    # (nW, N, H, Dh) storage: the caller's transpose back to tokens is free
    o = torch.empty((nW, N, H, Dh), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    # 16-byte tile loads need aligned operands, strides of 8 elements and
    # whole chunks of 8 in the head dim
    vec = Dh % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
        for t in (q, k, v))
    lib = kernels.library()
    with torch.cuda.device(q.device):
        err = lib.vetk_window_attention(
            kernels.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b32.data_ptr(), o.data_ptr(), nW, H, N, Dh, float(scale),
            *strides, _window_plan(nW, H, Dh, kernels.sm_count(q.device))[
                "wpb"], int(vec),
            kernels.stream_of(q))
        kernels.launch_counts["window_attention"] += 1
    kernels.check(err, "window_attention")
    return o


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Attention over many short windows with a per-head bias shared by all
    of them: the CUDA kernel for a CUDA tensor (strided views with a dense
    head dim are read in place), the plain version for a CPU tensor.
    ``scale`` defaults to ``Dh ** -0.5``. Records 4 nW H N^2 Dh FLOPs, the
    JAX package's count. Differentiable in q, k, v and the bias (rvrt's
    relative-position table is learned) through the plain version (JAX's
    ``window_attention_diffable``, ops/attention.py:282-303)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    nW, H, N, Dh = q.shape
    flop_record(4.0 * nW * H * N * N * Dh)
    return kernel_vjp("window_attention", _window_cuda,
                      window_attention_plain, q, k, v, bias, scale=scale)


def site_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    return site_attention_ref(q, k, v, heads)


def site_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    n, t, c = q.shape
    tg = k.shape[1]
    dh = c // heads
    prod = (q[:, :, None, :] * k[:, None, :, :]).reshape(n, t, tg, heads, dh)
    scores = prod.sum(-1).float()                            # (N,T,Tg,h)
    probs = torch.softmax(scores / math.sqrt(dh), dim=2).to(v.dtype)
    pc = probs.repeat_interleave(dh, dim=-1)                 # (N,T,Tg,C)
    return (pc * v[:, None, :, :]).sum(dim=2)
