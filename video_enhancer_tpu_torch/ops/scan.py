"""Selective scans (Mamba-1, per-channel decay) and the fused bidirectional
shared-stream SSM.

Counterpart of video_enhancer_tpu/ops/scan.py. The recurrence, per sequence
b, channel d and state n:

    h_t = exp(dt_t * A[d, n]) * h_{t-1} + dt_t * B_t[n] * x_t
    y_t = sum_n C_t[n] * h_t[n] + D[d] * x_t

Shapes: x, dt ``(B, L, D)``; A ``(D, N)``; Bmat, C ``(B, L, N)``; D
``(D,)``; states h0, h_last ``(B, D, N)`` fp32; y in x's dtype. Names,
argument order and ``impl`` strings are the JAX package's:

- ``selective_scan_plain`` / ``selective_scan_ref``: the sequential scan in
  fp32 (JAX's ``lax.scan`` ground truth), also the plain version of the
  short-sequence kernels;
- ``selective_scan_assoc``: the log-depth Hillis-Steele scan in torch ops,
  the plain version of the long-sequence kernel (JAX's choice off the TPU
  for L > 32);
- ``selective_scan_pallas_short`` (TPU kernels ``_scan_short_kernel`` and
  ``_scan_short_kernel_nostate``), ``selective_scan_pallas`` (``_scan_kernel``)
  and ``selective_scan_bidir`` (``_scan_bidir_kernel``): for a CUDA tensor
  each launches the port's CUDA kernel (csrc/selective_scan.cu); for a CPU
  tensor each takes its plain version;
- ``selective_scan``: the JAX dispatch rule (ops/scan.py:615-624) with "on
  the TPU" read as "a CUDA tensor";
- ``chunked_selective_scan``;
- ``selective_scan_bidir_shared``: the forward and reverse scans over
  shared u/B/C, summed; its ``impl="bmajor"`` is TPU kernel
  ``_scan_bidir_shared_kernel`` (csrc/selective_scan.cu for a CUDA tensor,
  ``selective_scan_bidir_shared_plain`` for a CPU tensor).

``fused_bidir_ssm`` is the whole bissm interior (csrc/fused_bissm.cu):
depthwise conv (SAME, bias), SiLU, x_proj (D -> dt_rank + 2N), dt_proj with
bias, softplus with a dt bias per direction, a forward and a reverse
selective scan over the shared u/B/C streams with their own A and D skip,
their sum, times SiLU(gate). ``fused_bidir_ssm_plain`` is the composed form
in fp32 (the counterpart of ``_fused_bissm_ref``). Its shapes: u_pre, gate
``(B, L, D)``; cw ``(D, 1, K)``; cb, bdt, dtbf, dtbb, Df, Db ``(D,)``; wx
``(dt_rank + 2N, D)``; wdt ``(D, dt_rank)`` (PyTorch's Conv1d/Linear
layouts); Af, Ab ``(D, N)`` negative.

Each wrapper whose JAX counterpart records its analytic FLOPs records the
same count (``scan_flops`` of its streams, ``fused_flops``) for
``utils.flops.accounting``, on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.flops import record as flop_record
from .conv import depthwise_conv1d
from .vjp import kernel_vjp, wants_grad

__all__ = ["selective_scan_plain", "selective_scan_ref",
           "selective_scan_assoc", "selective_scan_pallas_short",
           "selective_scan_pallas", "selective_scan",
           "chunked_selective_scan", "selective_scan_bidir",
           "selective_scan_bidir_plain", "selective_scan_bidir_shared",
           "selective_scan_bidir_shared_plain",
           "scan_flops", "fused_flops", "fused_bidir_ssm",
           "fused_bidir_ssm_plain", "fused_bidir_ssm_kernel"]

_MAX_N = 16                     # the kernels keep N states in registers


def scan_flops(B: int, L: int, D: int, N: int, streams: int = 1) -> float:
    """Operations of ``streams`` selective scans, the JAX package's count
    (ops/scan.py:41-45): ~9 a (b, l, d, n) step plus the D skip."""
    return streams * (9.0 * B * L * D * N + 2.0 * B * L * D)


def fused_flops(B: int, L: int, D: int, N: int, K: int, dt_rank: int) -> float:
    """The JAX package's count of one ``fused_bidir_ssm`` (ops/scan.py:
    1029-1033): both scans, the depthwise conv, x_proj, dt_proj and the
    SiLU / gate epilogue."""
    R = dt_rank + 2 * N
    return (scan_flops(B, L, D, N, streams=2) + 2.0 * B * L * D * K
            + 2.0 * B * L * D * R + 2.0 * B * L * dt_rank * D
            + 8.0 * B * L * D)


def selective_scan_plain(x, dt, A, Bmat, C, D, h0=None,
                         reverse: bool = False):
    """Sequential scan in fp32 over ``L`` from ``h0`` (zero when None).
    ``reverse`` walks the steps back to front (the JAX package's flip, scan,
    flip). Returns ``(y, h_last)``: y in x's dtype, h_last the fp32 state
    after the last step walked."""
    Bsz, L, Dd = x.shape
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, Bmat, C, A))
    h = (torch.zeros((Bsz, Dd, A.shape[1]), device=x.device)
         if h0 is None else h0.float())
    ys: list[torch.Tensor | None] = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        dtt = dtf[:, t, :, None]
        h = torch.exp(dtt * Af) * h + dtt * Bf[:, t, None, :] * xf[:, t, :, None]
        ys[t] = (h * Cf[:, t, None, :]).sum(-1)
    y = torch.stack(ys, dim=1) + xf * D.float()
    return y.to(x.dtype), h


# JAX's lax.scan ground truth: the sequential scan, forward.
selective_scan_ref = selective_scan_plain


def selective_scan_assoc(x, dt, A, Bmat, C, D, h0=None):
    """Log-depth scan over L on (decay, drive) pairs: Hillis-Steele
    doubling in torch ops, the counterpart of JAX's
    ``lax.associative_scan``. Materialises the (B, L, D, N) fp32 decay and
    drive and updates them in place (peak about four such tensors).
    Returns ``(y, h_last)``."""
    L = x.shape[1]
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf[..., None] * A.float())                 # (B,L,D,N)
    b = dtf[..., None] * Bmat.float()[:, :, None, :] * xf[..., None]
    shift = 1
    while shift < L:
        # (a_l, b_l) then (a_r, b_r) -> (a_r a_l, a_r b_l + b_r)
        nb = torch.addcmul(b[:, shift:], a[:, shift:], b[:, :-shift])
        na = a[:, shift:] * a[:, :-shift]
        b[:, shift:] = nb
        a[:, shift:] = na
        del nb, na
        shift *= 2
    if h0 is not None:
        b.addcmul_(a, h0.float()[:, None])
    del a
    Bsz, _, Dd, N = b.shape
    y = torch.bmm(b.reshape(Bsz * L, Dd, N),
                  C.float().reshape(Bsz * L, N, 1)).reshape(Bsz, L, Dd)
    y = y + xf * D.float()
    return y.to(x.dtype), b[:, -1].clone()


def _check_stream(x, dt, A, Bmat, C, D):
    """Checks one direction's operands for the kernels; returns the batch
    and step strides of x, dt, B and C for the C interface."""
    Bsz, L, Dd = x.shape
    N = A.shape[1] if A.ndim == 2 else -1
    if dt.shape != x.shape or A.shape != (Dd, N) or D.shape != (Dd,):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} do not match x {tuple(x.shape)}")
    if Bmat.shape != (Bsz, L, N) or C.shape != (Bsz, L, N):
        raise ValueError(f"B {tuple(Bmat.shape)} and C {tuple(C.shape)} must "
                         f"be ({Bsz}, {L}, {N})")
    if not (dt.dtype == Bmat.dtype == C.dtype == x.dtype):
        raise TypeError("x, dt, B and C must share one dtype")
    if N > _MAX_N:
        raise ValueError(f"kernel takes N <= {_MAX_N}, got {N}")
    for t in (dt, A, Bmat, C, D):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
    return kernels.seq_strides((x, "x"), (dt, "dt"), (Bmat, "B"), (C, "C"))


def _state_in(h0, x, N):
    Bsz, _, Dd = x.shape
    if h0.shape != (Bsz, Dd, N) or h0.device != x.device:
        raise ValueError(f"h0 must be ({Bsz}, {Dd}, {N}) on {x.device}, got "
                         f"{tuple(h0.shape)} on {h0.device}")
    return h0.float().contiguous()


# The short scan's launch arithmetic (csrc/selective_scan.cu, rows 7 and 8),
# pure Python so that the CPU tests reach it.
_TILE_THREADS = 256        # threads a block of the tile kernel
_TILE_MAX_L = 32           # longest L it takes (compile-time bounds 16, 32)
_TILE_MAX_N = 8            # largest N it takes (compile-time bounds 4, 8)
_WALK_MAX_THREADS = 256    # channels a block of the walking kernel


def _tile_nmax(N: int) -> int:
    """The N bound of the tile kernels' instance for N: 4, 8, or (row 8's
    scan_short_n16_kernel) 16."""
    return 4 if N <= 4 else _TILE_MAX_N if N <= _TILE_MAX_N else _MAX_N


_BC_RAW = 80               # bytes of a B or C row's 16-byte chunks (row 8)


def _tile_smem(L: int, D: int, N: int, itemsize: int, seqs: int) -> int:
    """Bytes of dynamic shared memory of the tile kernels
    (csrc/selective_scan.cu ``tile_smem``): per sequence x and dt (L rows
    of D rounded up to 8) and B and C as fp32 (L rows of twice the N
    bound). At N > 8 (row 8's ``scan_short_n16_kernel``, ``n16_smem``):
    two stages, each x and dt and every row's B and C as their 16-byte
    chunks (80 bytes each), then B and C as fp32, 32 wide."""
    if N > _TILE_MAX_N:
        stage = seqs * L * (2 * _up(D, 8) * itemsize + 2 * _BC_RAW)
        return 2 * stage + seqs * L * 2 * _MAX_N * 4
    return seqs * (2 * L * _up(D, 8) * itemsize + L * 2 * _tile_nmax(N) * 4)


def _short_scan_plan(B: int, L: int, D: int, N: int, itemsize: int,
                     aligned: bool, state: bool = True,
                     sms: int = 132) -> dict:
    """Rows 7 (``state``) and 8. For L <= 32 when the 16-byte copies of x
    and dt can run (``aligned``: both start on 16 bytes and their batch and
    step strides are multiples of 16 bytes; D too): at N <= 8 and D <= 512
    the tile kernel (route "tile"; L bound 16 or 32, N bound 4 or 8), two
    channels a thread; row 8 at 8 < N <= 16 and D <= 256 its sibling with
    one channel a thread (route "tile_n16"); either way the fewest
    sequences a block that fill whole warps (else the best fill, at most
    256 threads and B) whose shared memory fits, a block per such group
    ("tile") or, for "tile_n16", one wave of persistent blocks over the
    groups on ``sms`` SMs (blocks an SM by its 64 registers a thread,
    threads and shared memory). The kernel that walks any L, a block a
    sequence, otherwise. Raises ValueError for what none takes."""
    if min(B, L, D, N) < 1 or N > _MAX_N:
        raise ValueError(f"kernel takes N <= {_MAX_N}, got B={B} L={L} D={D} "
                         f"N={N}")
    wide = not state and N > _TILE_MAX_N
    tps = D if wide else -(-D // 2)
    threads = min(_up(D, 32), _WALK_MAX_THREADS)
    walk = {"route": "walk", "seqs": 0, "threads": threads,
            "grid": (B, -(-D // threads)), "smem": 0}
    if (L > _TILE_MAX_L or (N > _TILE_MAX_N and not wide)
            or tps > _TILE_THREADS or not aligned or D * itemsize % 16):
        return walk
    cands = range(1, min(_TILE_THREADS // tps, B) + 1)
    order = ([c for c in cands if c * tps % 32 == 0]
             + sorted(cands, key=lambda c: (-c * tps / _up(c * tps, 32), -c)))
    fits = [c for c in order
            if _tile_smem(L, D, N, itemsize, c) <= _SMEM_BLOCK]
    if not fits:
        return walk
    seqs = fits[0]
    plan = {"route": "tile", "seqs": seqs, "threads": seqs * tps,
            "grid": (-(-B // seqs),), "lmax": 16 if L <= 16 else _TILE_MAX_L,
            "nmax": _tile_nmax(N), "smem": _tile_smem(L, D, N, itemsize, seqs)}
    if wide:
        warps = -(-plan["threads"] // 32)
        per_sm = min(65536 // (64 * 32 * warps), 64 // warps,
                     _SMEM_SM // (plan["smem"] + 1024), 32)
        plan.update(route="tile_n16", blocks_per_sm=per_sm,
                    grid=(min(plan["grid"][0], per_sm * sms),))
    return plan


def _scan_short_cuda(x, dt, A, Bmat, C, D, h0, need_state):
    strides = _check_stream(x, dt, A, Bmat, C, D)
    Bsz, L, Dd = x.shape
    N = A.shape[1]
    stateful = h0 is not None or need_state
    lib = kernels.library()
    code = kernels.dtype_code(x)
    item = x.element_size()
    plan = _short_scan_plan(Bsz, L, Dd, N, item, _on_16_byte_grid(x, dt),
                            state=stateful, sms=kernels.sm_count(x.device))
    if stateful:
        h0 = (torch.zeros((Bsz, Dd, N), device=x.device) if h0 is None
              else _state_in(h0, x, N))
    h_last = (torch.empty((Bsz, Dd, N), device=x.device) if stateful
              else None)
    y = torch.empty((Bsz, L, Dd), dtype=x.dtype, device=x.device)
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    key = "selective_scan_short" if stateful else "selective_scan_short_nostate"
    with torch.cuda.device(x.device):
        err = lib.vetk_selective_scan_short(
            code, x.data_ptr(), dt.data_ptr(),
            A32.data_ptr(), Bmat.data_ptr(), C.data_ptr(), D32.data_ptr(),
            h0.data_ptr() if stateful else None, y.data_ptr(),
            h_last.data_ptr() if stateful else None, Bsz, L, Dd, N, strides,
            plan["seqs"], plan["grid"][0], kernels.stream_of(x))
        kernels.launch_counts[key] += 1
    kernels.check(err, key)
    return y, h_last


def selective_scan_pallas_short(x, dt, A, Bmat, C, D, h0=None,
                                need_state: bool = True):
    """Batched short-sequence scan (TPU kernels ``_scan_short_kernel`` and,
    with ``h0=None`` and ``need_state=False``, ``_scan_short_kernel_nostate``).
    Returns ``(y, h_last)``, h_last None for the stateless form. Launches
    the CUDA kernel for a CUDA tensor; the sequential plain version for a
    CPU tensor. The stateless form is differentiable (its backward
    recomputes the sequential scan: JAX's ``_short_nostate_diffable``,
    ops/scan.py:278-298); the form with state has no VJP in the JAX package
    and raises under grad on a CUDA tensor."""
    flop_record(scan_flops(*x.shape, A.shape[1]))
    if h0 is None and not need_state:
        return kernel_vjp("selective_scan_pallas_short",
                          _scan_short_nostate_cuda, _scan_nostate_plain, x,
                          dt, A, Bmat, C, D), None
    if x.device.type == "cuda":
        _no_vjp(7, "selective_scan_pallas_short with a state",
                "_selective_scan_pallas_short_impl", x, dt, A, Bmat, C, D, h0)
        return _scan_short_cuda(x, dt, A, Bmat, C, D, h0, need_state)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, A, Bmat, C, D, h0)
    raise ValueError(f"selective_scan_pallas_short: no kernel for {x.device}")


def _scan_nostate_plain(x, dt, A, Bmat, C, D):
    return selective_scan_plain(x, dt, A, Bmat, C, D)[0]


def _scan_short_nostate_cuda(x, dt, A, Bmat, C, D):
    return _scan_short_cuda(x, dt, A, Bmat, C, D, None, False)[0]


def _no_vjp(row: int, what: str, jax_name: str, *args) -> None:
    """Rows 7 and 9 have no VJP in the JAX package (JAX cannot
    differentiate through them either): under grad mode with an input that
    requires grad, a launch would return an output with no gradient, so
    they raise instead."""
    if wants_grad(*args):
        raise RuntimeError(
            f"{what} (TPU kernel row {row}, {jax_name}) has no VJP in the JAX "
            f"package and no backward here: call it under torch.no_grad() or "
            f"torch.inference_mode(), or differentiate the plain scan")


def _scan_long_cuda(x, dt, A, Bmat, C, D, h0):
    strides = _check_stream(x, dt, A, Bmat, C, D)
    Bsz, L, Dd = x.shape
    N = A.shape[1]
    if h0 is not None:
        h0 = _state_in(h0, x, N)
    lib = kernels.library()
    K = -(-L // lib.vetk_selective_scan_chunk())
    if Bsz > 65535 or K > 65535:
        raise ValueError(f"kernel takes B and L / chunk <= 65535, got B={Bsz} "
                         f"chunks={K}")
    y = torch.empty((Bsz, L, Dd), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bsz, Dd, N), device=x.device)
    states = torch.empty((Bsz, K, Dd, N), device=x.device)
    sumdt = torch.empty((Bsz, K, Dd), device=x.device)
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    with torch.cuda.device(x.device):
        err = lib.vetk_selective_scan_long(
            kernels.dtype_code(x), x.data_ptr(), dt.data_ptr(),
            A32.data_ptr(), Bmat.data_ptr(), C.data_ptr(), D32.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), states.data_ptr(), sumdt.data_ptr(), Bsz, L,
            Dd, N, strides, kernels.stream_of(x))
        kernels.launch_counts["selective_scan_long"] += 1
    kernels.check(err, "selective_scan_long")
    return y, h_last


def selective_scan_pallas(x, dt, A, Bmat, C, D, h0=None):
    """Long-sequence scan (TPU kernel ``_scan_kernel``). Returns ``(y,
    h_last)``. Launches the CUDA kernel (chunked, three phases) for a CUDA
    tensor; ``selective_scan_assoc`` for a CPU tensor. No VJP (as in the JAX
    package): raises under grad on a CUDA tensor."""
    flop_record(scan_flops(*x.shape, A.shape[1]))
    if x.device.type == "cuda":
        _no_vjp(9, "selective_scan_pallas", "_selective_scan_pallas_impl",
                x, dt, A, Bmat, C, D, h0)
        return _scan_long_cuda(x, dt, A, Bmat, C, D, h0)
    if x.device.type == "cpu":
        return selective_scan_assoc(x, dt, A, Bmat, C, D, h0)
    raise ValueError(f"selective_scan_pallas: no kernel for {x.device}")


def _auto_impl(B: int, L: int, on_card: bool) -> str:
    if L <= 32:
        return "pallas_short" if (on_card and B >= 1024) else "ref"
    return "pallas" if on_card else "assoc"


def selective_scan(x, dt, A, Bmat, C, D, h0=None, impl: str | None = None,
                   need_state: bool = True):
    """Dispatching entry point; impl: ref | assoc | pallas | pallas_short |
    None (auto). Auto keeps the JAX package's rule with "on the TPU" read as
    "a CUDA tensor": L <= 32 takes the short kernel on the card when B >=
    1024 and the sequential scan otherwise (with B < 1024 that is the
    reference's own choice, its ``lax.scan``, not a fallback); L > 32 takes
    the long kernel on the card and the associative scan elsewhere.
    ``need_state=False`` lets the short kernel skip the state (h_last comes
    back as None)."""
    if impl is None:
        impl = _auto_impl(x.shape[0], x.shape[1], x.device.type == "cuda")
    if impl == "pallas_short":
        return selective_scan_pallas_short(x, dt, A, Bmat, C, D, h0,
                                           need_state=need_state)
    fn = {"ref": selective_scan_ref, "assoc": selective_scan_assoc,
          "pallas": selective_scan_pallas}[impl]
    return fn(x, dt, A, Bmat, C, D, h0)


def chunked_selective_scan(x, dt, A, Bmat, C, D, chunk: int,
                           impl: str | None = None):
    """A long sequence in chunks of ``chunk`` steps, threading the state:
    the same result as one full scan. Returns ``(y, h_last)``."""
    Bsz, L, Dd = x.shape
    h = torch.zeros((Bsz, Dd, A.shape[1]), device=x.device)
    ys = []
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        y, h = selective_scan(x[:, s:e], dt[:, s:e], A, Bmat[:, s:e],
                              C[:, s:e], D, h0=h, impl=impl)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def selective_scan_bidir_plain(xf, dtf, Af, Bf, Cf, Df,
                               xb, dtb, Ab, Bb, Cb, Db):
    """Two sequential scans: the forward stream l = 0..L-1, the backward
    stream l = L-1..0. Returns ``(y_forward, y_backward)``."""
    yf, _ = selective_scan_plain(xf, dtf, Af, Bf, Cf, Df)
    yb, _ = selective_scan_plain(xb, dtb, Ab, Bb, Cb, Db, reverse=True)
    return yf, yb


def _bidir_smem(L: int, D: int, N: int, itemsize: int, seqs: int,
                shared: bool, summed: bool = False) -> int:
    """Bytes of dynamic shared memory of the tile kernels of rows 6 and 10
    (csrc/selective_scan.cu ``bidir_smem``): per sequence the x tiles (one
    when the streams share x) and both dt tiles (L rows of D rounded up to
    8), then B and C as fp32 (L rows of twice the N bound; one set when
    shared), then with ``summed`` (row 10) an fp32 tile of L rows of D
    rounded up to 8."""
    nmax = 4 if N <= 4 else _TILE_MAX_N
    tiles, bcs = (3, 1) if shared else (4, 2)
    return seqs * (tiles * L * _up(D, 8) * itemsize + bcs * L * 2 * nmax * 4
                   + (L * _up(D, 8) * 4 if summed else 0))


def _bidir_plan(B: int, L: int, D: int, N: int, itemsize: int,
                aligned: bool, shared: bool, summed: bool = False) -> dict:
    """Row 6 (and, ``summed``, row 10's tile kernel, whose shared memory
    holds an fp32 tile more). The tile kernel for L <= 32, N <= 8 and D <=
    512 when the 16-byte copies of both streams' x and dt can run
    (``aligned``: each starts on 16 bytes with batch and step strides that
    are multiples of 16 bytes; D too), reading x, B and C once when
    ``shared`` (the streams' are one): its instance (L bound 8, 16 or 32; N
    bound 4 or 8), two channels a thread, the fewest sequences a block that
    fill whole warps and at least 128 threads (96 for row 10, whose
    three-warp blocks read 0.629 against 0.678 ms for six at
    fast_mamba_vsr's shape on an H100; else whole warps, else the best
    fill; at most 256 threads and B) whose shared memory fits, a block per
    such group. The kernel that walks any L, a block a sequence,
    otherwise. Raises ValueError for what neither takes."""
    if min(B, L, D, N) < 1 or N > _MAX_N:
        raise ValueError(f"kernel takes N <= {_MAX_N}, got B={B} L={L} D={D} "
                         f"N={N}")
    tps = -(-D // 2)
    threads = min(_up(D, 32), _WALK_MAX_THREADS)
    walk = {"route": "walk", "seqs": 0, "threads": threads,
            "grid": (B, -(-D // threads)), "smem": 0, "shared": False}
    if (L > _TILE_MAX_L or N > _TILE_MAX_N or tps > _TILE_THREADS
            or not aligned or D * itemsize % 16):
        return walk
    cands = range(1, min(_TILE_THREADS // tps, B) + 1)
    whole = [c for c in cands if c * tps % 32 == 0]
    floor = 96 if summed else 128
    order = ([c for c in whole if c * tps >= floor] + whole
             + sorted(cands, key=lambda c: (-c * tps / _up(c * tps, 32), -c)))
    fits = [c for c in order
            if _bidir_smem(L, D, N, itemsize, c, shared, summed)
            <= _SMEM_BLOCK]
    if not fits:
        return walk
    seqs = fits[0]
    return {"route": "tile", "seqs": seqs, "threads": seqs * tps,
            "grid": (-(-B // seqs),),
            "lmax": 8 if L <= 8 else 16 if L <= 16 else _TILE_MAX_L,
            "nmax": 4 if N <= 4 else _TILE_MAX_N, "shared": shared,
            "smem": _bidir_smem(L, D, N, itemsize, seqs, shared, summed)}


def _shared_scan_plan(B: int, L: int, D: int, N: int, itemsize: int,
                      aligned: bool) -> dict:
    """Row 10 (``selective_scan_bidir_shared(impl="bmajor")``). Where row
    6's tile kernel would take the streams shared, its instance with the
    directions in turn and a summing epilogue (route "tile_sum",
    csrc/selective_scan.cu ``scan_bidir_sum_kernel``; ``aligned``: u and
    both dt on the 16-byte grid), with the sequences a block of
    ``_bidir_plan`` and the fp32 tile in its shared memory; otherwise the
    register kernel for L <= 32 ("register") and the workspace kernel
    beyond ("workspace"), a block a sequence. Raises ValueError for what
    none takes."""
    plan = _bidir_plan(B, L, D, N, itemsize, aligned, True, summed=True)
    if plan["route"] == "tile":
        # one instance an N bound: its loops are rolled, any L <= 32
        plan.pop("lmax")
        return dict(plan, route="tile_sum")
    return dict(plan, route="register" if L <= _TILE_MAX_L else "workspace")


def _on_16_byte_grid(*ts) -> bool:
    """Each operand starts on 16 bytes and steps its batch and time by
    multiples of 16 bytes (what the tile kernels' 16-byte copies need)."""
    return all(t.data_ptr() % 16 == 0
               and t.stride(0) * t.element_size() % 16 == 0
               and t.stride(1) * t.element_size() % 16 == 0 for t in ts)


def _same_view(a, b) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _scan_bidir_cuda(xf, dtf, Af, Bf, Cf, Df, xb, dtb, Ab, Bb, Cb, Db):
    sf = _check_stream(xf, dtf, Af, Bf, Cf, Df)
    sb = _check_stream(xb, dtb, Ab, Bb, Cb, Db)
    if xb.shape != xf.shape or Ab.shape != Af.shape or xb.dtype != xf.dtype:
        raise ValueError("the two streams must match in shape and dtype")
    Bsz, L, Dd = xf.shape
    N = Af.shape[1]
    plan = _bidir_plan(
        Bsz, L, Dd, N, xf.element_size(),
        aligned=_on_16_byte_grid(xf, dtf, xb, dtb),
        shared=all(_same_view(f, b) for f, b in ((xf, xb), (Bf, Bb),
                                                 (Cf, Cb))))
    yf = torch.empty((Bsz, L, Dd), dtype=xf.dtype, device=xf.device)
    yb = torch.empty_like(yf)
    w = [t.float().contiguous() for t in (Af, Df, Ab, Db)]
    lib = kernels.library()
    with torch.cuda.device(xf.device):
        err = lib.vetk_selective_scan_bidir(
            kernels.dtype_code(xf), xf.data_ptr(), dtf.data_ptr(),
            w[0].data_ptr(), Bf.data_ptr(), Cf.data_ptr(), w[1].data_ptr(),
            xb.data_ptr(), dtb.data_ptr(), w[2].data_ptr(), Bb.data_ptr(),
            Cb.data_ptr(), w[3].data_ptr(), yf.data_ptr(), yb.data_ptr(),
            Bsz, L, Dd, N, sf, sb, plan["seqs"], int(plan["shared"]),
            kernels.stream_of(xf))
        kernels.launch_counts["selective_scan_bidir"] += 1
    kernels.check(err, "selective_scan_bidir")
    return yf, yb


def selective_scan_bidir(xf, dtf, Af, Bf, Cf, Df, xb, dtb, Ab, Bb, Cb, Db):
    """A forward and a time-reversed stateless scan over the same sequence
    axis (TPU kernel ``_scan_bidir_kernel``): the forward stream walks l =
    0..L-1, the backward one l = L-1..0, both in one kernel with no flips.
    Returns ``(y_forward, y_backward)`` in natural order. Launches the CUDA
    kernel for a CUDA tensor; two sequential scans for a CPU tensor.
    Differentiable through those two scans (JAX's ``_bidir_diffable``,
    ops/scan.py:479-504)."""
    flop_record(scan_flops(*xf.shape, Af.shape[1], streams=2))
    return kernel_vjp("selective_scan_bidir", _scan_bidir_cuda,
                      selective_scan_bidir_plain, xf, dtf, Af, Bf, Cf, Df,
                      xb, dtb, Ab, Bb, Cb, Db)


def selective_scan_bidir_shared_plain(u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db):
    """A forward and a back-to-front sequential scan over the shared u, B
    and C, each cast to u's dtype, summed: the JAX package's
    ``_bidir_shared_ref`` (ops/scan.py:756-760)."""
    yf, _ = selective_scan_plain(u, dtf, Af, Bm, Cm, Df)
    yb, _ = selective_scan_plain(u, dtb, Ab, Bm, Cm, Db, reverse=True)
    return yf + yb


def _scan_bidir_shared_cuda(u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db):
    _check_stream(u, dtf, Af, Bm, Cm, Df)
    _check_stream(u, dtb, Ab, Bm, Cm, Db)
    Bsz, L, Dd = u.shape
    N = Af.shape[1]
    strides = kernels.seq_strides((u, "u"), (dtf, "dtf"), (dtb, "dtb"),
                                  (Bm, "B"), (Cm, "C"))
    plan = _shared_scan_plan(Bsz, L, Dd, N, u.element_size(),
                             _on_16_byte_grid(u, dtf, dtb))
    lib = kernels.library()
    y = torch.empty((Bsz, L, Dd), dtype=u.dtype, device=u.device)
    ws = (torch.empty((Bsz, L, Dd), device=u.device)
          if L > lib.vetk_selective_scan_shared_max_l() else None)
    w = [t.float().contiguous() for t in (Af, Ab, Df, Db)]
    with torch.cuda.device(u.device):
        err = lib.vetk_selective_scan_bidir_shared(
            kernels.dtype_code(u), u.data_ptr(), dtf.data_ptr(),
            dtb.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), w[2].data_ptr(), w[3].data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), Bsz, L, Dd, N, strides,
            plan["seqs"], kernels.stream_of(u))
        kernels.launch_counts["selective_scan_bidir_shared"] += 1
    kernels.check(err, "selective_scan_bidir_shared")
    return y


def selective_scan_bidir_shared(u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db,
                                impl: str = "bidir"):
    """Sum of a forward and a time-reversed scan over SHARED u/B/C streams
    (the directions differ in dt, A and D). ``impl="bidir"`` runs
    ``selective_scan_bidir`` with u, B and C passed for both streams and
    sums its two outputs. ``impl="bmajor"`` is the counterpart of TPU
    kernel ``_scan_bidir_shared_kernel``, which the JAX package keeps behind
    this switch for A/B runs: for a CUDA tensor one kernel
    (csrc/selective_scan.cu) reads u, B and C once, holds the forward
    output in fp32 and casts the sum once; for a CPU tensor
    ``selective_scan_bidir_shared_plain``, which is also the backward of
    either device (JAX's ``_bidir_shared_diffable``, ops/scan.py:764-787)."""
    if impl == "bidir":
        yf, yb = selective_scan_bidir(u, dtf, Af, Bm, Cm, Df,
                                      u, dtb, Ab, Bm, Cm, Db)
        return yf + yb
    if impl != "bmajor":
        raise ValueError(f"unknown impl {impl!r}")
    flop_record(scan_flops(*u.shape, Af.shape[1], streams=2))
    return kernel_vjp("selective_scan_bidir_shared", _scan_bidir_shared_cuda,
                      selective_scan_bidir_shared_plain, u, dtf, dtb, Af, Ab,
                      Bm, Cm, Df, Db)


def fused_bidir_ssm_plain(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb,
                          Af, Ab, Df, Db, dt_rank: int) -> torch.Tensor:
    """The exact op sequence the kernel fuses, in fp32 throughout."""
    f32 = [t.float() for t in (cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab,
                               Df, Db)]
    cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db = f32
    N = Af.shape[1]
    u = F.silu(depthwise_conv1d(u_pre.float(), cw, cb))
    proj = u @ wx.t()
    dt_raw = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + N]
    Cm = proj[..., dt_rank + N:]
    dtp = dt_raw @ wdt.t() + bdt
    dt_f = F.softplus(dtp + dtbf)
    dt_b = F.softplus(dtp + dtbb)
    y = (selective_scan_plain(u, dt_f, Af, Bm, Cm, Df)[0]
         + selective_scan_plain(u, dt_b, Ab, Bm, Cm, Db, reverse=True)[0])
    return (y * F.silu(gate.float())).to(u_pre.dtype)


# The fused kernel's instances, in the order of csrc/fused_bissm.cu's
# instance indices: (name, N, K, dt_rank, channels a lane, bound on L); the
# first two run at exactly their N, K and dt_rank, the last at the bounds
# with runtime counts.
_FUSED_INSTANCES = (("vsrm", 4, 5, 4, 4, 8), ("fast_mamba_vsr", 8, 5, 3, 3, 16),
                    ("generic", 16, 8, 16, 8, 32))
_FUSED_GENERIC = len(_FUSED_INSTANCES) - 1
_FUSED_MAX_WARPS = (16, 16, 4)   # warps a block, by instance
_SMEM_BLOCK = 232448           # dynamic shared memory a block may use (H100)
_SMEM_SM = 233472              # shared memory of an SM; each block takes 1 KB more


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fused_smem(instance: int, L: int, D: int, itemsize: int,
                warps: int) -> int:
    """Bytes of dynamic shared memory (csrc/fused_bissm.cu ``smem_bytes``):
    the weights staged in fp32 (x_proj's transposed, its rows padded so
    that four outputs are one 16-byte read), then per warp the u tile, the
    gate tile, the x stash and the projections."""
    _, N, K, rank, _, _ = _FUSED_INSTANCES[instance]
    rs = _up(rank + 2 * N, 4)
    rs += 0 if rs // 4 % 2 else 4
    ps = _up(rank, 4) + 2 * _up(N, 4)
    rows = rs + 2 * N + rank + 5 + (K if instance == _FUSED_GENERIC else 0)
    warp = 2 * _up(L * D * itemsize, 16) + _up(L * D * 4, 16) + _up(L * ps * 4, 16)
    return _up(rows * D * 4, 16) + warps * warp


def _fused_instance(N: int, K: int, dt_rank: int, D: int, L: int) -> int:
    """Index of the instance that takes these sizes (the specialised ones
    at exactly their N, K and dt_rank, their channels a lane and up to
    their bound on L; else the one at the bounds). Raises ValueError for
    what the kernel does not take."""
    if L > 32 or D > 256 or N > 16 or K > 8 or dt_rank > 16:
        raise ValueError(f"kernel takes L <= 32, D <= 256, N <= 16, K <= 8, "
                         f"dt_rank <= 16; got L={L} D={D} N={N} K={K} "
                         f"dt_rank={dt_rank}")
    for i, (_, n, k, r, cpl, lmax) in enumerate(_FUSED_INSTANCES[:-1]):
        if ((N, K, dt_rank) == (n, k, r) and 32 * (cpl - 1) < D <= 32 * cpl
                and L <= lmax):
            return i
    return _FUSED_GENERIC


def _fused_bissm_plan(B: int, L: int, D: int, N: int, K: int, dt_rank: int,
                      itemsize: int, sms: int, regs: int | None = None) -> dict:
    """The fused kernel's launch: the instance, the sequences in flight a
    block (one a warp, each with one u and one gate tile that its next
    sequence refills as soon as they are spent), the shared memory and the
    grid. The warps a block keep the most warps resident on an SM (by
    shared memory, threads and, given the kernel's ``regs`` a thread,
    registers; the larger block on a tie, as each stages the weights once);
    at most one wave of blocks, each warp walking a strided list of
    sequences. Raises ValueError for what the kernel does not take."""
    index = _fused_instance(N, K, dt_rank, D, L)
    best = None
    for warps in range(1, _FUSED_MAX_WARPS[index] + 1):
        smem = _fused_smem(index, L, D, itemsize, warps)
        if smem > _SMEM_BLOCK:
            break
        per_sm = min(_SMEM_SM // (smem + 1024), 2048 // (32 * warps), 32)
        if regs:
            # 256-register units a warp; warps by registers in fours
            by_regs = 65536 // (32 * _up(regs, 8)) // 4 * 4
            per_sm = min(per_sm, by_regs // warps)
        if best is None or per_sm * warps >= best[0]:
            best = (per_sm * warps, warps, per_sm, smem)
    _, warps, per_sm, smem = best
    return {"instance": _FUSED_INSTANCES[index][0], "index": index,
            "warps": warps, "threads": 32 * warps, "smem": smem,
            "blocks_per_sm": per_sm,
            "grid": max(1, min(-(-B // warps), per_sm * sms))}


_fused_regs: dict[tuple[int, int], int] = {}


def _fused_kernel_regs(lib, dtype_code: int, index: int) -> int:
    """Registers a thread of an instance's kernel, asked once."""
    key = (dtype_code, index)
    if key not in _fused_regs:
        regs = lib.vetk_fused_bissm_regs(dtype_code, index)
        if regs <= 0:
            kernels.check(-regs, "fused_bidir_ssm")
        _fused_regs[key] = regs
    return _fused_regs[key]


def _fused_bidir_ssm_cuda(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb,
                          Af, Ab, Df, Db, dt_rank):
    B, L, D = u_pre.shape
    N = Af.shape[1]
    K = cw.shape[-1]
    R = dt_rank + 2 * N
    if gate.shape != (B, L, D) or gate.dtype != u_pre.dtype:
        raise ValueError("gate must match u_pre in shape and dtype")
    expected = {"cw": (D, 1, K), "cb": (D,), "wx": (R, D),
                "wdt": (D, dt_rank), "bdt": (D,), "dtbf": (D,), "dtbb": (D,),
                "Af": (D, N), "Ab": (D, N), "Df": (D,), "Db": (D,)}
    weights = dict(cw=cw, cb=cb, wx=wx, wdt=wdt, bdt=bdt, dtbf=dtbf,
                   dtbb=dtbb, Af=Af, Ab=Ab, Df=Df, Db=Db)
    for name, shape in expected.items():
        t = weights[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
        if t.device != u_pre.device:
            raise ValueError(f"{name} is on {t.device}, u_pre on {u_pre.device}")
    ldu = kernels.row_stride(u_pre, "u_pre")
    ldg = kernels.row_stride(gate, "gate")
    index = _fused_instance(N, K, dt_rank, D, L)
    lib = kernels.library()
    code = kernels.dtype_code(u_pre)
    plan = _fused_bissm_plan(B, L, D, N, K, dt_rank, u_pre.element_size(),
                             kernels.sm_count(u_pre.device),
                             regs=_fused_kernel_regs(lib, code, index))
    # the weights in their own dtype (fp32, bf16 or fp16; another is cast to
    # fp32), which the kernel casts on load
    w = [t.contiguous() if t.dtype in kernels.KERNEL_DTYPES
         else t.float().contiguous() for t in (weights[n] for n in expected)]
    wcodes = sum(kernels.dtype_code(t) << (2 * i) for i, t in enumerate(w))
    y = torch.empty((B, L, D), dtype=u_pre.dtype, device=u_pre.device)
    with torch.cuda.device(u_pre.device):
        err = lib.vetk_fused_bissm(
            code, u_pre.data_ptr(), gate.data_ptr(),
            *(t.data_ptr() for t in w), y.data_ptr(), B, L, D, N, K,
            dt_rank, ldu, ldg, wcodes, plan["index"], plan["warps"],
            plan["grid"], kernels.stream_of(u_pre))
        kernels.launch_counts["fused_bidir_ssm"] += 1
    kernels.check(err, "fused_bidir_ssm")
    return y


def fused_bidir_ssm_kernel(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb,
                           Af, Ab, Df, Db, dt_rank: int) -> torch.Tensor:
    """Wrapper of the CUDA kernel: launches it for a CUDA tensor, takes the
    plain version for a CPU tensor. Records ``fused_flops``.
    Differentiable in all 13 tensors through ``fused_bidir_ssm_plain``
    (JAX's ``_fused_bissm_diffable``, ops/scan.py:998-1017)."""
    flop_record(fused_flops(*u_pre.shape, Af.shape[1], cw.shape[-1],
                            dt_rank))
    return kernel_vjp("fused_bidir_ssm", _fused_bidir_ssm_cuda,
                      fused_bidir_ssm_plain, u_pre, gate, cw, cb, wx, wdt,
                      bdt, dtbf, dtbb, Af, Ab, Df, Db, dt_rank=dt_rank)


def fused_bidir_ssm(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab,
                    Df, Db, dt_rank: int, use_kernel: bool = True):
    """The whole bissm interior. The kernel serves every call, as the JAX
    package uses its kernel whenever it runs on the TPU (ops/scan.py:
    988-995); ``use_kernel=False`` takes the plain version."""
    fn = fused_bidir_ssm_kernel if use_kernel else fused_bidir_ssm_plain
    return fn(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db,
              dt_rank)
