"""The fused bidirectional shared-stream SSM (the whole bissm interior).

Counterpart of video_enhancer_tpu/ops/scan.py ``fused_bidir_ssm``:
depthwise conv (SAME, bias), SiLU, x_proj (D -> dt_rank + 2N), dt_proj with
bias, softplus with a dt bias per direction, a forward and a reverse
selective scan over the shared u/B/C streams with their own A and D skip,
their sum, times SiLU(gate).

``fused_bidir_ssm_plain`` is the composed form in fp32 (the counterpart of
``_fused_bissm_ref``, whose scans are ``_bidir_shared_ref``).
``fused_bidir_ssm_kernel`` is the wrapper of the hand-written CUDA kernel
(csrc/fused_bissm.cu): it launches the kernel for a CUDA tensor and takes
the plain version only for a tensor on the CPU.

Shapes: u_pre, gate ``(B, L, D)``; cw ``(D, 1, K)``; cb, bdt, dtbf, dtbb,
Df, Db ``(D,)``; wx ``(dt_rank + 2N, D)``; wdt ``(D, dt_rank)`` (PyTorch's
Conv1d/Linear layouts); Af, Ab ``(D, N)`` negative.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .conv import depthwise_conv1d

__all__ = ["selective_scan_plain", "fused_bidir_ssm",
           "fused_bidir_ssm_plain", "fused_bidir_ssm_kernel"]


def selective_scan_plain(x, dt, A, Bm, Cm, D, reverse: bool = False):
    """Sequential Mamba-1 scan in fp32 over ``L``: h_t = exp(dt_t A) h +
    dt_t B_t x_t; y_t = C_t . h_t + D x_t. x, dt ``(B, L, D)``; A ``(D,
    N)``; Bm, Cm ``(B, L, N)``. ``reverse`` walks the steps back to front
    (the JAX package's flip, scan, flip)."""
    Bsz, L, Dd = x.shape
    h = x.new_zeros(Bsz, Dd, A.shape[1])
    ys: list[torch.Tensor | None] = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        dtt = dt[:, t, :, None]
        h = torch.exp(dtt * A) * h + dtt * Bm[:, t, None, :] * x[:, t, :, None]
        ys[t] = (h * Cm[:, t, None, :]).sum(-1)
    return torch.stack(ys, dim=1) + x * D


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
    y = (selective_scan_plain(u, dt_f, Af, Bm, Cm, Df)
         + selective_scan_plain(u, dt_b, Ab, Bm, Cm, Db, reverse=True))
    return (y * F.silu(gate.float())).to(u_pre.dtype)


def _blocks_for(device: torch.device, B: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(B, 8 * sms))


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
    if L > 32 or D > 256 or N > 16 or K > 8 or dt_rank > 16:
        raise ValueError(f"kernel takes L <= 32, D <= 256, N <= 16, K <= 8, "
                         f"dt_rank <= 16; got L={L} D={D} N={N} K={K} "
                         f"dt_rank={dt_rank}")
    ldu = kernels.row_stride(u_pre, "u_pre")
    ldg = kernels.row_stride(gate, "gate")
    w32 = [weights[n].float().contiguous() for n in expected]
    y = torch.empty((B, L, D), dtype=u_pre.dtype, device=u_pre.device)
    lib = kernels.library()
    with torch.cuda.device(u_pre.device):
        err = lib.vetk_fused_bissm(
            kernels.dtype_code(u_pre), u_pre.data_ptr(), gate.data_ptr(),
            *(t.data_ptr() for t in w32), y.data_ptr(), B, L, D, N, K,
            dt_rank, ldu, ldg, _blocks_for(u_pre.device, B),
            kernels.stream_of(u_pre))
        kernels.launch_counts["fused_bidir_ssm"] += 1
    kernels.check(err, "fused_bidir_ssm")
    return y


def fused_bidir_ssm_kernel(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb,
                           Af, Ab, Df, Db, dt_rank: int) -> torch.Tensor:
    """Wrapper of the CUDA kernel: launches it for a CUDA tensor, takes the
    plain version for a CPU tensor."""
    args = (u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db,
            dt_rank)
    if u_pre.device.type == "cuda":
        return _fused_bidir_ssm_cuda(*args)
    if u_pre.device.type == "cpu":
        return fused_bidir_ssm_plain(*args)
    raise ValueError(f"fused_bidir_ssm: no kernel for device {u_pre.device}")


def fused_bidir_ssm(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab,
                    Df, Db, dt_rank: int, use_kernel: bool = True):
    """The whole bissm interior. The kernel serves every call, as the JAX
    package uses its kernel whenever it runs on the TPU (ops/scan.py:
    988-995); ``use_kernel=False`` takes the plain version."""
    fn = fused_bidir_ssm_kernel if use_kernel else fused_bidir_ssm_plain
    return fn(u_pre, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db,
              dt_rank)
