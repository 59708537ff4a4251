"""The two SSM mixers of VSRM: bidirectional SSD (spatial) and the shared-
stream bidirectional Mamba-1 (temporal), fused path only.

Counterparts of video_enhancer_tpu/nn/ssm.py ``bissd_init``/``bissd_apply``
(:257-352) and ``bissm_init``/``bissm_apply`` (:414-477). Sequence layout
``(batch, L, dim)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.conv import depthwise_conv1d
from ..ops.scan import fused_bidir_ssm
from ..ops.ssd import ssd_shared
from .core import dense_apply, dense_init

__all__ = ["bissd_init", "bissd_apply", "bissm_init", "bissm_apply"]


def _dt_bias(gen: torch.Generator, n: int) -> torch.Tensor:
    """Inverse softplus of dt drawn log-uniformly in [1e-3, 1e-1]."""
    u = torch.rand(n, generator=gen)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return torch.log(torch.exp(dt) - 1.0 + 1e-9)


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
                use_kernel: bool | None = None) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)``: one in_proj and one SAME
    depthwise conv feed a forward and a reverse SSD scan (their own decays
    and dt biases), summed, D skip, gated RMS norm (eps 1e-6), out_proj.
    ``use_kernel`` is passed to ``ssd_shared`` (None keeps its dtype rule)."""
    heads = p["A_log_f"].shape[0]
    inner = p["D"].shape[0]
    state_dim = (p["conv_w"].shape[0] - inner) // 2
    P = inner // heads

    zxbcdt = dense_apply(p["in_proj"], x)
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * state_dim]
    dt_raw = zxbcdt[..., -heads:].float()
    xbc = F.silu(depthwise_conv1d(xbc, p["conv_w"], p["conv_b"]))
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


def bissm_apply(p: dict, x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """x ``(B, L, dim)`` -> ``(B, L, dim)`` for small L: in_proj, the fused
    interior (ops/scan.py), out_proj."""
    state_dim = p["A_log_f"].shape[1]
    dt_rank = p["x_proj"]["w"].shape[0] - 2 * state_dim
    u, gate = dense_apply(p["in_proj"], x).chunk(2, dim=-1)
    y = fused_bidir_ssm(
        u, gate, p["conv_w"], p["conv_b"], p["x_proj"]["w"],
        p["dt_proj"]["w"], p["dt_proj"]["b"], p["dt_bias_f"], p["dt_bias_b"],
        -torch.exp(p["A_log_f"]), -torch.exp(p["A_log_b"]), p["D_f"],
        p["D_b"], dt_rank, use_kernel=use_kernel)
    return dense_apply(p["out_proj"], y)
