"""Selective-SSM layers: Mamba-1 (``ssm``, ``bimamba``), Mamba-2
(``mamba2``, ``bimamba2``), the shared-stream bidirectional Mamba-1 of the
video models' temporal axis (``bissm``), the bidirectional SSD of vsrm's
spatial mixer (``bissd``) and vsrm's attentive spatial mixer
(``attentive_ssm``).

Counterparts of video_enhancer_tpu/nn/ssm.py ``ssm_init``/``ssm_apply``
(:34-114), ``bimamba_init``/``bimamba_apply`` (:117-125, 560-581), their
T-sharded forms ``bimamba_apply_sharded`` (:128-169) and
``bissm_apply_sharded`` (:495-541), ``mamba2_init``/``mamba2_apply``
(:172-254), ``bimamba2_init``/``bimamba2_apply`` (:544-557),
``bissd_init``/``bissd_apply`` (:257-352), its T-sharded form
``bissd_apply_sharded`` (:355-410), ``bissm_init``/``bissm_apply``
(:414-492) and ``attentive_ssm_init``/``attentive_ssm_apply`` (:584-646).
Sequence layout ``(batch, L, dim)`` (the attentive mixer takes frames
``(B, H, W, C)``); parameters in PyTorch's layouts (depthwise ``conv_w (C,
1, K)``, dense ``w (out, in)``, conv2d ``w (Cout, Cin / groups, kh, kw)``).
The sharded forms take the local shard of a sequence split over a time
axis (parallel/mesh.py ``TimeAxis``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.conv import depthwise_conv1d, depthwise_conv1d_silu
from ..ops.scan import (fused_bidir_ssm, selective_scan,
                        selective_scan_bidir, selective_scan_bidir_shared)
from ..ops.ssd import ssd_shared
from ..parallel.temporal import (halo_exchange_time, ssd_parallel_scan,
                                 temporal_parallel_scan)
from .core import (conv2d_apply, conv2d_init, dense_apply, dense_init,
                   layer_norm_apply, layer_norm_init, rms_norm_apply)

__all__ = ["ssm_init", "ssm_apply", "bimamba_init", "bimamba_apply",
           "bimamba_apply_sharded", "mamba2_init", "mamba2_apply",
           "bimamba2_init", "bimamba2_apply", "bissd_init", "bissd_apply",
           "bissd_apply_sharded",
           "bissm_init", "bissm_apply", "bissm_apply_sharded",
           "attentive_ssm_init", "attentive_ssm_apply"]


def _dt_bias(gen: torch.Generator, n: int) -> torch.Tensor:
    """Inverse softplus of dt drawn log-uniformly in [1e-3, 1e-1]."""
    u = torch.rand(n, generator=gen)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return torch.log(torch.exp(dt) - 1.0 + 1e-9)


def ssm_init(gen: torch.Generator, dim: int, state_dim: int = 16,
             expand: int = 2, conv_kernel: int = 4,
             dt_rank: int | None = None) -> dict:
    """Mamba-1: in_proj -> (u, gate); causal depthwise conv; SiLU; x_proj ->
    (dt_raw, B, C); dt = softplus(dt_proj(dt_raw) + dt_bias); selective scan;
    times SiLU(gate); out_proj. A is S4D-real: A_log = log(1..N)."""
    inner = dim * expand
    dt_rank = dt_rank or max(dim // 16, 1)
    return {
        "in_proj": dense_init(gen, dim, 2 * inner, bias=False),
        "conv_w": torch.randn((inner, 1, conv_kernel), generator=gen)
        / math.sqrt(conv_kernel),
        "conv_b": torch.zeros(inner),
        "x_proj": dense_init(gen, inner, dt_rank + 2 * state_dim, bias=False),
        "dt_proj": dense_init(gen, dt_rank, inner),
        "dt_bias": _dt_bias(gen, inner),
        "A_log": torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32)
                           ).repeat(inner, 1),
        "D": torch.ones(inner),
        "out_proj": dense_init(gen, inner, dim, bias=False),
    }


def _ssm_streams(p: dict, x: torch.Tensor, reverse: bool):
    """Projection, conv and dt streams in natural sequence order. The
    reverse direction's flip, causal conv, flip is an anti-causal conv with
    the taps reversed."""
    state_dim = p["A_log"].shape[1]
    dt_rank = p["x_proj"]["w"].shape[0] - 2 * state_dim
    u, gate = dense_apply(p["in_proj"], x).chunk(2, dim=-1)
    k = p["conv_w"].shape[-1]
    w = p["conv_w"].to(u.dtype)
    if reverse:
        u = depthwise_conv1d(u, torch.flip(w, dims=(-1,)), p["conv_b"],
                             padding=((0, k - 1),))
    else:
        u = depthwise_conv1d(u, w, p["conv_b"], padding=((k - 1, 0),))
    u = F.silu(u)
    proj = dense_apply(p["x_proj"], u)
    dt_raw = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + state_dim]
    Cm = proj[..., dt_rank + state_dim:]
    dt = F.softplus(dense_apply(p["dt_proj"], dt_raw) + p["dt_bias"])
    return u, gate, dt, Bm, Cm


def _flip(t: torch.Tensor) -> torch.Tensor:
    return torch.flip(t, dims=(1,))


def ssm_apply(p: dict, x: torch.Tensor, reverse: bool = False,
              impl: str | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``. The scan takes the stateless
    short kernel, the long kernel or a plain scan by ``selective_scan``'s
    rule; ``reverse`` scans the flipped streams."""
    u, gate, dt, Bm, Cm = _ssm_streams(p, x, reverse=reverse)
    A = -torch.exp(p["A_log"])
    if reverse:
        y, _ = selective_scan(_flip(u), _flip(dt), A, _flip(Bm), _flip(Cm),
                              p["D"], impl=impl, need_state=False)
        y = _flip(y)
    else:
        y, _ = selective_scan(u, dt, A, Bm, Cm, p["D"], impl=impl,
                              need_state=False)
    return dense_apply(p["out_proj"], y * F.silu(gate))


def bimamba_init(gen: torch.Generator, dim: int, **kw) -> dict:
    """Bidirectional Mamba-1: a forward and a reversed ``ssm``, their
    outputs concatenated and fused by a dense layer."""
    return {"fwd": ssm_init(gen, dim, **kw), "bwd": ssm_init(gen, dim, **kw),
            "fuse": dense_init(gen, 2 * dim, dim)}


def bimamba_apply(p: dict, x: torch.Tensor,
                  impl: str | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``. On the card with L <= 32 and
    B >= 1024 (and ``impl`` None or ``"pallas_short"``) both directions run
    in one bidirectional kernel launch, as the JAX package does on the TPU;
    otherwise each direction is an ``ssm_apply``."""
    Bsz, L = x.shape[0], x.shape[1]
    if (impl in (None, "pallas_short") and L <= 32 and Bsz >= 1024
            and x.device.type == "cuda"):
        uf, gf, dtf, Bf, Cf = _ssm_streams(p["fwd"], x, reverse=False)
        ub, gb, dtb, Bb, Cb = _ssm_streams(p["bwd"], x, reverse=True)
        yf, yb = selective_scan_bidir(
            uf, dtf, -torch.exp(p["fwd"]["A_log"]), Bf, Cf, p["fwd"]["D"],
            ub, dtb, -torch.exp(p["bwd"]["A_log"]), Bb, Cb, p["bwd"]["D"])
        yf = dense_apply(p["fwd"]["out_proj"], yf * F.silu(gf))
        yb = dense_apply(p["bwd"]["out_proj"], yb * F.silu(gb))
    else:
        yf = ssm_apply(p["fwd"], x, impl=impl)
        yb = ssm_apply(p["bwd"], x, reverse=True, impl=impl)
    return dense_apply(p["fuse"], torch.cat([yf, yb], dim=-1))


def bimamba_apply_sharded(p: dict, x: torch.Tensor, axis,
                          impl: str | None = None) -> torch.Tensor:
    """Exact ``bimamba_apply`` over a sequence split across ``axis``. x:
    this rank's shard ``(B, L_loc, dim)``. The causal convs see k-1 halo
    steps from the neighbours (zeroed at the global edges, where the
    unsharded conv zero-pads); the scans run the distributed
    prefix-combine (parallel/temporal.py)."""
    halo = p["fwd"]["conv_w"].shape[-1] - 1
    if x.shape[1] < halo:
        raise ValueError(
            f"local T shard ({x.shape[1]} frames) smaller than the conv "
            f"halo ({halo}); use fewer time shards or longer clips")
    xh = halo_exchange_time(x, halo, axis)
    end = xh.shape[1]
    if axis.index == 0:
        xh[:, :halo] = 0
    if axis.index == axis.size - 1:
        xh[:, end - halo:] = 0

    def trim(a):
        return a[:, halo:a.shape[1] - halo]

    outs = []
    for name, reverse in (("fwd", False), ("bwd", True)):
        u, gate, dt, Bm, Cm = _ssm_streams(p[name], xh, reverse=reverse)
        y = temporal_parallel_scan(
            trim(u), trim(dt), -torch.exp(p[name]["A_log"]), trim(Bm),
            trim(Cm), p[name]["D"], axis, impl=impl, reverse=reverse)
        outs.append(dense_apply(p[name]["out_proj"],
                                y * F.silu(trim(gate))))
    return dense_apply(p["fuse"], torch.cat(outs, dim=-1))


def mamba2_init(gen: torch.Generator, dim: int, state_dim: int = 32,
                expand: int = 2, head_dim: int = 64,
                conv_kernel: int = 4) -> dict:
    """Mamba-2: in_proj -> (gate z, values x, B and C shared by the heads,
    dt a head); a causal depthwise conv over (x, B, C); SiLU; the SSD scan
    with a scalar decay a head; D skip; gated RMS norm; out_proj. When
    ``head_dim`` does not divide the inner width, one head takes all of it.
    A = -exp(A_log) with exp(A_log) uniform on [1, 16]."""
    inner = dim * expand
    if inner % head_dim:
        head_dim = inner
    heads = inner // head_dim
    conv_dim = inner + 2 * state_dim
    return {
        "in_proj": dense_init(gen, dim, 2 * inner + 2 * state_dim + heads,
                              bias=False),
        "conv_w": torch.randn((conv_dim, 1, conv_kernel), generator=gen)
        / math.sqrt(conv_kernel),
        "conv_b": torch.zeros(conv_dim),
        "dt_bias": _dt_bias(gen, heads),
        "A_log": torch.rand(heads, generator=gen) * math.log(16.0),
        "D": torch.ones(inner),
        "norm_scale": torch.ones(inner),
        "out_proj": dense_init(gen, inner, dim, bias=False),
    }


def mamba2_apply(p: dict, x: torch.Tensor, reverse: bool = False,
                 chunk: int = 256,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``. ``reverse`` scans
    anti-causally: the conv is anti-causal with its taps reversed (explicit
    padding ``(0, k - 1)``) and the SSD runs with ``reverse=True``, which
    the kernel takes without a flip. ``use_kernel`` is passed to
    ``ssd_shared`` (None keeps its dtype rule: the kernel for bf16 / fp16).
    The gated RMS norm runs in fp32 (eps 1e-6) and is cast back."""
    heads = p["A_log"].shape[0]
    inner = p["D"].shape[0]
    state_dim = (p["conv_w"].shape[0] - inner) // 2
    P = inner // heads

    zxbcdt = dense_apply(p["in_proj"], x)
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * state_dim]
    dt_raw = zxbcdt[..., -heads:]
    k = p["conv_w"].shape[-1]
    w = p["conv_w"].to(xbc.dtype)
    if reverse:
        xbc = depthwise_conv1d(xbc, torch.flip(w, dims=(-1,)), p["conv_b"],
                               padding=((0, k - 1),))
    else:
        xbc = depthwise_conv1d(xbc, w, p["conv_b"], padding=((k - 1, 0),))
    xbc = F.silu(xbc)
    u = xbc[..., :inner]
    Bm = xbc[..., inner:inner + state_dim]
    Cm = xbc[..., inner + state_dim:]

    b, L, _ = x.shape
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    y = ssd_shared(u.reshape(b, L, heads, P), dt, -torch.exp(p["A_log"]), Bm,
                   Cm, chunk=chunk, reverse=reverse, use_kernel=use_kernel)
    y = y.reshape(b, L, inner) + u * p["D"].to(u.dtype)
    y = rms_norm_apply({"scale": p["norm_scale"]}, y * F.silu(z))
    return dense_apply(p["out_proj"], y)


def bimamba2_init(gen: torch.Generator, dim: int, **kw) -> dict:
    """Bidirectional Mamba-2: a forward and a reversed ``mamba2``, their
    outputs concatenated and fused by a dense layer."""
    return {"fwd": mamba2_init(gen, dim, **kw),
            "bwd": mamba2_init(gen, dim, **kw),
            "fuse": dense_init(gen, 2 * dim, dim)}


def bimamba2_apply(p: dict, x: torch.Tensor, chunk: int = 256,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``: two SSD scans, forward and
    reverse (two ``ssd_shared`` launches on the card)."""
    yf = mamba2_apply(p["fwd"], x, chunk=chunk, use_kernel=use_kernel)
    yb = mamba2_apply(p["bwd"], x, reverse=True, chunk=chunk,
                      use_kernel=use_kernel)
    return dense_apply(p["fuse"], torch.cat([yf, yb], dim=-1))


def bissd_init(gen: torch.Generator, dim: int, state_dim: int = 32,
               expand: int = 2, head_dim: int = 64,
               conv_kernel: int = 5) -> dict:
    inner = dim * expand
    if inner % head_dim:
        head_dim = inner
    heads = inner // head_dim
    conv_dim = inner + 2 * state_dim
    return {
        "in_proj": dense_init(gen, dim, 2 * inner + 2 * state_dim + heads,
                              bias=False),
        "conv_w": torch.randn((conv_dim, 1, conv_kernel), generator=gen)
        / math.sqrt(conv_kernel),
        "conv_b": torch.zeros(conv_dim),
        "A_log_f": torch.rand(heads, generator=gen) * math.log(16.0),
        "A_log_b": torch.rand(heads, generator=gen) * math.log(16.0),
        "dt_bias_f": _dt_bias(gen, heads),
        "dt_bias_b": _dt_bias(gen, heads),
        "D": torch.ones(inner),
        "norm_scale": torch.ones(inner),
        "out_proj": dense_init(gen, inner, dim, bias=False),
    }


def bissd_apply(p: dict, x: torch.Tensor, chunk: int = 256,
                conv_impl: str = "grouped",
                use_kernel: bool | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``: one in_proj and one SAME
    depthwise conv feed a forward and a reverse SSD scan (their own decays
    and dt biases), summed, D skip, gated RMS norm (eps 1e-6), out_proj.
    ``conv_impl``, with the JAX package's values: ``"grouped"`` (the
    default) runs the conv and then the SiLU as PyTorch ops; ``"pallas"``
    runs both as ``depthwise_conv1d_silu``, the counterpart of the TPU
    kernel ``_dwconv_silu_kernel`` (csrc/dwconv_silu.cu for a CUDA tensor),
    which the JAX package keeps behind this switch for A/B runs.
    ``use_kernel`` is passed to ``ssd_shared`` (None keeps its dtype rule)."""
    heads = p["A_log_f"].shape[0]
    inner = p["D"].shape[0]
    state_dim = (p["conv_w"].shape[0] - inner) // 2
    P = inner // heads

    zxbcdt = dense_apply(p["in_proj"], x)
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * state_dim]
    dt_raw = zxbcdt[..., -heads:].float()
    if conv_impl == "pallas":
        xbc = depthwise_conv1d_silu(xbc, p["conv_w"].to(xbc.dtype),
                                    p["conv_b"])
    elif conv_impl == "grouped":
        xbc = F.silu(depthwise_conv1d(xbc, p["conv_w"].to(xbc.dtype),
                                      p["conv_b"]))
    else:
        raise ValueError(f"unknown conv_impl {conv_impl!r}")
    u = xbc[..., :inner]
    Bm = xbc[..., inner:inner + state_dim]
    Cm = xbc[..., inner + state_dim:]

    b, L, _ = x.shape
    uh = u.reshape(b, L, heads, P)
    dt_f = F.softplus(dt_raw + p["dt_bias_f"].float())
    dt_b = F.softplus(dt_raw + p["dt_bias_b"].float())
    y = (ssd_shared(uh, dt_f, -torch.exp(p["A_log_f"]), Bm, Cm, chunk=chunk,
                    use_kernel=use_kernel)
         + ssd_shared(uh, dt_b, -torch.exp(p["A_log_b"]), Bm, Cm,
                      chunk=chunk, reverse=True, use_kernel=use_kernel))
    y = y.reshape(b, L, inner) + u * p["D"].to(u.dtype)

    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
         * p["norm_scale"].float()).to(x.dtype)
    return dense_apply(p["out_proj"], y)


def bissd_apply_sharded(p: dict, x: torch.Tensor, axis, chunk: int = 64,
                        use_kernel: bool | None = None) -> torch.Tensor:
    """Exact ``bissd_apply`` over a sequence split across ``axis``. x: this
    rank's shard ``(B, L_loc, dim)``. The centred SAME conv sees a halo of
    ``k // 2`` steps (zero steps at the global edges: in_proj has no bias,
    so they stay the zeros the unsharded padding gives), run as the plain
    depthwise conv and SiLU, then trimmed; both directions run the
    distributed SSD scan (parallel/temporal.py ``ssd_parallel_scan``, its
    local scans on the SSD kernel by ``ssd_shared``'s rule or
    ``use_kernel``); D skip, gated RMS norm, out_proj as unsharded."""
    heads = p["A_log_f"].shape[0]
    inner = p["D"].shape[0]
    state_dim = (p["conv_w"].shape[0] - inner) // 2
    P = inner // heads
    halo = p["conv_w"].shape[-1] // 2
    if x.shape[1] < halo:
        raise ValueError(
            f"local T shard ({x.shape[1]}) smaller than conv halo ({halo})")

    zxbcdt = dense_apply(p["in_proj"],
                         halo_exchange_time(x, halo, axis, edge="zero"))
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * state_dim]
    dt_raw = zxbcdt[..., -heads:].float()
    xbc = F.silu(depthwise_conv1d(xbc, p["conv_w"].to(xbc.dtype),
                                  p["conv_b"]))

    def trim(a):
        return a[:, halo:a.shape[1] - halo]

    # the SSD kernel reads x, B and C as evenly strided rows: one copy
    z, xbc, dt_raw = trim(z), trim(xbc).contiguous(), trim(dt_raw)
    u = xbc[..., :inner]
    Bm = xbc[..., inner:inner + state_dim]
    Cm = xbc[..., inner + state_dim:]

    b, L, _ = u.shape
    uh = u.reshape(b, L, heads, P)
    dt_f = F.softplus(dt_raw + p["dt_bias_f"].float())
    dt_b = F.softplus(dt_raw + p["dt_bias_b"].float())
    y = (ssd_parallel_scan(uh, dt_f, -torch.exp(p["A_log_f"]), Bm, Cm, axis,
                           chunk=chunk, use_kernel=use_kernel)
         + ssd_parallel_scan(uh, dt_b, -torch.exp(p["A_log_b"]), Bm, Cm,
                             axis, chunk=chunk, reverse=True,
                             use_kernel=use_kernel))
    y = y.reshape(b, L, inner) + u * p["D"].to(u.dtype)

    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
         * p["norm_scale"].float()).to(x.dtype)
    return dense_apply(p["out_proj"], y)


def bissm_init(gen: torch.Generator, dim: int, state_dim: int = 4,
               expand: int = 2, conv_kernel: int = 5,
               dt_rank: int | None = None) -> dict:
    inner = dim * expand
    dt_rank = dt_rank or max(dim // 16, 1)
    a_log = torch.log(torch.arange(1, state_dim + 1, dtype=torch.float32)
                      ).repeat(inner, 1)
    return {
        "in_proj": dense_init(gen, dim, 2 * inner, bias=False),
        "conv_w": torch.randn((inner, 1, conv_kernel), generator=gen)
        / math.sqrt(conv_kernel),
        "conv_b": torch.zeros(inner),
        "x_proj": dense_init(gen, inner, dt_rank + 2 * state_dim, bias=False),
        "dt_proj": dense_init(gen, dt_rank, inner),
        "dt_bias_f": _dt_bias(gen, inner),
        "dt_bias_b": _dt_bias(gen, inner),
        "A_log_f": a_log.clone(),
        "A_log_b": a_log.clone(),
        "D_f": torch.ones(inner),
        "D_b": torch.ones(inner),
        "out_proj": dense_init(gen, inner, dim, bias=False),
    }


def _bissm_conv(p: dict, u: torch.Tensor) -> torch.Tensor:
    return F.silu(depthwise_conv1d(u, p["conv_w"].to(u.dtype), p["conv_b"]))


def _bissm_streams(p: dict, u: torch.Tensor):
    """x_proj and dt_proj of the conv's output: (dt_f, dt_b, B, C)."""
    state_dim = p["A_log_f"].shape[1]
    dt_rank = p["x_proj"]["w"].shape[0] - 2 * state_dim
    proj = dense_apply(p["x_proj"], u)
    Bm = proj[..., dt_rank:dt_rank + state_dim]
    Cm = proj[..., dt_rank + state_dim:]
    dtp = dense_apply(p["dt_proj"], proj[..., :dt_rank])
    return (F.softplus(dtp + p["dt_bias_f"]),
            F.softplus(dtp + p["dt_bias_b"]), Bm, Cm)


def bissm_apply(p: dict, x: torch.Tensor, impl: str = "fused") -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)`` for small L: in_proj, the
    interior, out_proj. ``impl="fused"`` runs the interior as one kernel
    (``fused_bidir_ssm``, csrc/fused_bissm.cu, for a CUDA tensor);
    ``"composed"`` as separate ops around one bidirectional scan
    (``selective_scan_bidir_shared``, csrc/selective_scan.cu, for a CUDA
    tensor); ``"plain"`` as the fused kernel's plain version, in fp32, the
    reference both are held against."""
    state_dim = p["A_log_f"].shape[1]
    dt_rank = p["x_proj"]["w"].shape[0] - 2 * state_dim
    u, gate = dense_apply(p["in_proj"], x).chunk(2, dim=-1)
    Af, Ab = -torch.exp(p["A_log_f"]), -torch.exp(p["A_log_b"])
    if impl in ("fused", "plain"):
        y = fused_bidir_ssm(
            u, gate, p["conv_w"], p["conv_b"], p["x_proj"]["w"],
            p["dt_proj"]["w"], p["dt_proj"]["b"], p["dt_bias_f"],
            p["dt_bias_b"], Af, Ab, p["D_f"], p["D_b"], dt_rank,
            use_kernel=impl == "fused")
        return dense_apply(p["out_proj"], y)
    if impl != "composed":
        raise ValueError(f"unknown impl {impl!r}")
    u = _bissm_conv(p, u)
    dt_f, dt_b, Bm, Cm = _bissm_streams(p, u)
    y = selective_scan_bidir_shared(u, dt_f, dt_b, Af, Ab, Bm, Cm, p["D_f"],
                                    p["D_b"], impl="bidir")
    return dense_apply(p["out_proj"], y * F.silu(gate))


def bissm_apply_sharded(p: dict, x: torch.Tensor, axis,
                        impl: str | None = None) -> torch.Tensor:
    """Exact ``bissm_apply`` over a sequence split across ``axis``. x: this
    rank's shard ``(B, L_loc, dim)``. The centred conv sees a halo of
    max((k-1)//2, k//2) steps (zero steps at the global edges, the unsharded
    SAME padding); both directions run the distributed prefix-combine
    (parallel/temporal.py), whose scans ``impl`` selects (None: the
    dispatch rule, the short kernel with state on the card)."""
    k = p["conv_w"].shape[-1]
    halo = max((k - 1) // 2, k // 2)
    if x.shape[1] < halo:
        raise ValueError(
            f"local T shard ({x.shape[1]}) smaller than conv halo ({halo})")
    xh = halo_exchange_time(x, halo, axis, edge="zero")
    u, gate = dense_apply(p["in_proj"], xh).chunk(2, dim=-1)

    def trim(a):
        return a[:, halo:a.shape[1] - halo]

    # in_proj has no bias, so the zero halo steps stay zero into the conv
    u = trim(_bissm_conv(p, u))
    gate = trim(gate)
    dt_f, dt_b, Bm, Cm = _bissm_streams(p, u)
    yf = temporal_parallel_scan(u, dt_f, -torch.exp(p["A_log_f"]), Bm, Cm,
                                p["D_f"], axis, impl=impl)
    yb = temporal_parallel_scan(u, dt_b, -torch.exp(p["A_log_b"]), Bm, Cm,
                                p["D_b"], axis, impl=impl, reverse=True)
    return dense_apply(p["out_proj"], (yf + yb) * F.silu(gate))


def _attentive_heads(inner: int) -> int:
    """Heads of 64 channels, at most 8, dividing ``inner``."""
    heads = max(1, min(8, inner // 64))
    while inner % heads:
        heads -= 1
    return heads


def attentive_ssm_init(gen: torch.Generator, dim: int, expand: int = 2,
                       conv_kernel: int = 3) -> dict:
    """vsrm's MambaIRv2-style attentive spatial mixer: in_proj -> (x, z);
    a depthwise 2-D conv of x; full self-attention over the frame's H*W
    tokens with heads of 64 (``_attentive_heads``) and a residual LayerNorm;
    SiLU of that times SiLU(z); out_proj."""
    inner = dim * expand
    return {
        "in_proj": dense_init(gen, dim, 2 * inner, bias=False),
        "conv": conv2d_init(gen, conv_kernel, conv_kernel, inner, inner,
                            groups=inner),
        "qkv": dense_init(gen, inner, 3 * inner, bias=False),
        "attn_out": dense_init(gen, inner, inner),
        "attn_norm": layer_norm_init(inner),
        "out_proj": dense_init(gen, inner, dim, bias=False),
    }


def attentive_ssm_apply(p: dict, x: torch.Tensor,
                        use_kernel: bool | None = None) -> torch.Tensor:
    """Frames ``(B, H, W, C)`` -> ``(B, H, W, C)``. The attention goes
    through ``ops.attention.attention``: the flash kernel (csrc/
    flash_attn.cu) for a CUDA tensor with H*W >= 256 tokens, the plain
    form otherwise, as the JAX package's dispatch; ``use_kernel=False``
    always takes the plain form."""
    b, h, w, _ = x.shape
    xs, z = dense_apply(p["in_proj"], x).chunk(2, dim=-1)
    inner = xs.shape[-1]
    heads = _attentive_heads(inner)
    dh = inner // heads
    xs = conv2d_apply(p["conv"], xs, groups=inner)

    seq = xs.reshape(b, h * w, inner)
    q, k, v = dense_apply(p["qkv"], seq).chunk(3, dim=-1)

    def to_heads(a):
        return a.reshape(b, h * w, heads, dh).transpose(1, 2)

    att = attention(to_heads(q), to_heads(k), to_heads(v),
                    use_kernel=use_kernel)
    att = att.transpose(1, 2).reshape(b, h * w, inner)
    seq = seq + layer_norm_apply(p["attn_norm"],
                                 dense_apply(p["attn_out"], att))
    y = F.silu(seq.reshape(b, h, w, inner)) * F.silu(z)
    return dense_apply(p["out_proj"], y)
