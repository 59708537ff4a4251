"""SSD (state-space dual / Mamba-2) scan with B/C shared across heads.

Counterpart of video_enhancer_tpu/ops/ssd.py ``ssd_shared``. Within a chunk
of length Q, with g the running sum of dt*A (all exponents <= 0):

    Y_intra = ((C B^T) o exp(g_t - g_s) o causal_mask) @ (dt * x)
    S_chunk = (B o exp(g_Q - g_s))^T @ (dt * x)
    S_k     = exp(g_Q) S_{k-1} + S_chunk_k
    Y_inter = (C o exp(g_t)) @ S_{k-1}

``ssd_shared_plain`` is that chunked form in PyTorch (the counterpart of
the JAX package's ``_ssd_shared_jnp``). ``ssd_shared_kernel`` is the wrapper
of the hand-written CUDA kernel (csrc/ssd_shared.cu): it launches the kernel
for a CUDA tensor and takes the plain version only for a tensor on the CPU.

Shapes: x ``(B, L, H, P)``; dt ``(B, L, H)``; A ``(H,)`` negative decay
rates; Bm, Cm ``(B, L, N)``. Returns y ``(B, L, H, P)`` (the caller adds
any D*x skip).
"""

from __future__ import annotations

import functools

import torch

from .. import kernels

__all__ = ["ssd_chunk_size", "ssd_shared", "ssd_shared_plain",
           "ssd_shared_kernel"]

_HALF = (torch.bfloat16, torch.float16)


def ssd_chunk_size(L: int, target: int = 128) -> int:
    """Largest power of two <= min(L, target)."""
    c = 1
    while c * 2 <= min(L, target):
        c *= 2
    return c


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of (possibly half-precision) operands accumulated in fp32."""
    return torch.matmul(a.float(), b.float())


def _ssd_forward_plain(x, dt, A, Bm, Cm, chunk):
    b, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, ssd_chunk_size(L, chunk))
    pad = (-L) % Q
    if pad:
        # dt = 0 -> decay 1, drive 0: pure passthrough steps.
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    K = (L + pad) // Q
    cdt = x.dtype if x.dtype in _HALF else torch.float32

    # Head-major chunks: (b, K, H, Q, ...); B/C stay (b, K, 1, Q, N).
    xc = x.reshape(b, K, Q, H, P).transpose(2, 3).to(cdt)
    dtc = dt.reshape(b, K, Q, H).transpose(2, 3).float()
    Bc = Bm.reshape(b, K, 1, Q, N).to(cdt)
    Cc = Cm.reshape(b, K, 1, Q, N).to(cdt)

    g = torch.cumsum(dtc * A.float()[:, None], dim=3)        # (b,K,H,Q)
    G = g[..., -1]                                           # (b,K,H)
    xdt = (xc.float() * dtc[..., None]).to(cdt)              # (b,K,H,Q,P)

    # intra-chunk: ((C B^T) o decay o mask) @ (dt x)
    CB = _mm32(Cc, Bc.transpose(-1, -2))                     # (b,K,1,Q,Q)
    ldiff = g[..., :, None] - g[..., None, :]                # (b,K,H,Q,Q)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    W = (CB * torch.exp(ldiff.masked_fill(~mask, float("-inf")))).to(cdt)
    y = _mm32(W, xdt)                                        # (b,K,H,Q,P)

    # chunk states and the recurrence across chunks
    to_end = torch.exp(G[..., None] - g)                     # (b,K,H,Q)
    Bg = (Bc.float() * to_end[..., None]).to(cdt)            # (b,K,H,Q,N)
    S_chunk = _mm32(Bg.transpose(-1, -2), xdt)               # (b,K,H,N,P)
    decay = torch.exp(G)                                     # (b,K,H)
    run = torch.zeros_like(S_chunk[:, 0])
    S_prev = []
    for k in range(K):
        S_prev.append(run)
        run = decay[:, k, :, None, None] * run + S_chunk[:, k]
    S_prev = torch.stack(S_prev, dim=1)                      # (b,K,H,N,P)

    # inter-chunk: (C o exp(g)) @ S_prev
    Cg = (Cc.float() * torch.exp(g)[..., None]).to(cdt)      # (b,K,H,Q,N)
    y = y + _mm32(Cg, S_prev.to(cdt))
    y = y.transpose(2, 3).reshape(b, K * Q, H, P)[:, :L]
    return y.to(x.dtype)


def ssd_shared_plain(x, dt, A, Bm, Cm, chunk: int = 256,
                     reverse: bool = False) -> torch.Tensor:
    """The chunked form in PyTorch; ``reverse`` scans anti-causally (by
    flipping the sequence, as the JAX package's plain form does)."""
    if reverse:
        def flip(t):
            return torch.flip(t, dims=(1,))
        return flip(_ssd_forward_plain(flip(x), flip(dt), A, flip(Bm),
                                       flip(Cm), chunk))
    return _ssd_forward_plain(x, dt, A, Bm, Cm, chunk)


# The CUDA kernel's launch arithmetic (csrc/ssd_shared.cu), pure Python so
# that the CPU tests reach it.
_SSD_Q = 64                  # chunk length of both CUDA paths
_SSD_TC_THREADS = 128        # four warps a block of the tensor-core path
_SSD_TC_MIN_BLOCKS = 3       # its __launch_bounds__: blocks an SM by registers
_SSD_TC_MAX_HP = 128         # H * P a block of it holds
_SSD_SIMT_THREADS = 256
_SMEM_BLOCK = 232448         # dynamic shared memory a block may use (H100)
_SMEM_SM = 233472            # shared memory of an SM; each block takes 1 KB more


def _ssd_smem(H: int, P: int) -> int:
    """Bytes of dynamic shared memory of the tensor-core kernels
    (csrc/ssd_shared.cu ``tc_layout``): two stages of x (rows of H*P + 8),
    B and C (rows of 24) and dt (fp32), then B o e^(G-g) and C o e^g per
    head, the entering state (16 rows of P + 8) per head, 16 rows of y for
    each of the four warps and the log decays."""
    q, bc = _SSD_Q, 24
    stage = q * (H * P + 8) * 2 + 2 * q * bc * 2 + q * H * 4
    total = (2 * stage + 2 * H * q * bc * 2 + (H + 4) * 16 * (P + 8) * 2
             + (H * q + 2 * H) * 4)
    return -(-total // 16) * 16


def _ssd_simt_smem(P: int, N: int) -> int:
    """Bytes of dynamic shared memory of the CUDA-core output kernel, the
    larger of that path's two."""
    q = _SSD_Q
    return 4 * (2 * q + 2 * q * N + q * (q + N) + (q + N) * P)


def _ssd_route(dtype: torch.dtype, H: int, P: int, N: int) -> str:
    """``"mma"`` (the tensor-core path) for bf16 / fp16 with P a multiple
    of 16 up to 64, H * P <= 128 and N <= 16; ``"simt"`` (the CUDA-core
    path) otherwise."""
    if (dtype in _HALF and P % 16 == 0 and 16 <= P <= 64
            and H * P <= _SSD_TC_MAX_HP and N <= 16):
        return "mma"
    return "simt"


@functools.lru_cache(maxsize=64)
def _ssd_plan(b: int, L: int, H: int, P: int, N: int, dtype: torch.dtype,
              sms: int) -> dict:
    """The kernel's launches: the route (the kernel takes the same from
    dtype and shape), the K chunks of 64 steps, and on the tensor-core
    path the R chunks a block walks (a run) and the M = ceil(K / R) runs,
    with R the least that puts the b * M blocks in one wave of the card
    (blocks an SM by shared memory, capped by what the kernel's launch
    bound guarantees by registers). Raises ValueError for what the kernel
    does not take."""
    if min(b, L, H, P, N) < 1 or P > 64 or N > 128 or b > 65535:
        raise ValueError(f"kernel takes P <= 64, N <= 128 and b <= 65535, "
                         f"got b={b} L={L} H={H} P={P} N={N}")
    K = -(-L // _SSD_Q)
    if _ssd_route(dtype, H, P, N) == "simt":
        if H > 65535:
            raise ValueError(f"kernel takes H <= 65535, got H={H}")
        return {"route": "simt", "chunk": _SSD_Q, "chunks": K, "run": 1,
                "runs": K, "grid": (K, H, b), "threads": _SSD_SIMT_THREADS,
                "smem": _ssd_simt_smem(P, N)}
    smem = _ssd_smem(H, P)
    per_sm = min(_SSD_TC_MIN_BLOCKS, _SMEM_SM // (smem + 1024))
    slots = per_sm * sms
    run = min(K, max(1, -(-b * K // slots)))
    while run < K and b * -(-K // run) > slots:
        run += 1
    runs = -(-K // run)
    return {"route": "mma", "chunk": _SSD_Q, "chunks": K, "run": run,
            "runs": runs, "grid": (runs, b), "threads": _SSD_TC_THREADS,
            "smem": smem, "blocks_per_sm": per_sm}


def _ssd_shared_cuda(x, dt, A, Bm, Cm, reverse):
    b, L, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (b, L, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if Bm.shape != (b, L, N) or Cm.shape != (b, L, N):
        raise ValueError("Bm and Cm must both be (b, L, N)")
    if not (Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError("x, Bm and Cm must share one dtype")
    if P > 64 or N > 128:
        raise ValueError(f"kernel takes P <= 64 and N <= 128, got P={P} N={N}")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"x: heads must be dense, got strides {x.stride()}")
    for t in (dt, A, Bm, Cm):
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
    ldx = kernels.row_stride(x.flatten(2), "x")
    ldb, ldc = kernels.row_stride(Bm, "Bm"), kernels.row_stride(Cm, "Cm")
    plan = _ssd_plan(b, L, H, P, N, x.dtype, kernels.sm_count(x.device))
    dt32 = dt.float().contiguous()
    A32 = A.float().contiguous()
    lib = kernels.library()
    M = plan["runs"]
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    states = torch.empty((b, H, M, N, P), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, H, M), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vetk_ssd_shared(
            kernels.dtype_code(x), x.data_ptr(), dt32.data_ptr(),
            A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            states.data_ptr(), decay.data_ptr(), b, L, H, P, N, ldx, ldb, ldc,
            int(reverse), plan["run"], kernels.stream_of(x))
        kernels.launch_counts["ssd_shared"] += 1
    kernels.check(err, "ssd_shared")
    return y


def ssd_shared_kernel(x, dt, A, Bm, Cm, chunk: int = 256,
                      reverse: bool = False) -> torch.Tensor:
    """Wrapper of the CUDA kernel: launches it for a CUDA tensor, takes the
    plain version for a CPU tensor (``chunk`` only affects the latter; the
    kernel's own chunk length gives the same result up to rounding)."""
    if x.device.type == "cuda":
        return _ssd_shared_cuda(x, dt, A, Bm, Cm, reverse)
    if x.device.type == "cpu":
        return ssd_shared_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                reverse=reverse)
    raise ValueError(f"ssd_shared: no kernel for device {x.device}")


def ssd_shared(x, dt, A, Bm, Cm, chunk: int = 256, reverse: bool = False,
               use_kernel: bool | None = None) -> torch.Tensor:
    """SSD scan with B/C shared across heads (groups=1).

    ``use_kernel=None`` keeps the JAX package's rule (ops/ssd.py:454-463):
    the kernel for half-precision input (the serving path), the plain
    chunked form for fp32."""
    if use_kernel is None:
        use_kernel = x.dtype in _HALF
    if use_kernel:
        return ssd_shared_kernel(x, dt, A, Bm, Cm, chunk=chunk,
                                 reverse=reverse)
    return ssd_shared_plain(x, dt, A, Bm, Cm, chunk=chunk, reverse=reverse)
