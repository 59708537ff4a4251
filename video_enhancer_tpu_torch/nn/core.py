"""Core layers on parameter dictionaries, in PyTorch's weight layouts.

Counterpart of video_enhancer_tpu/nn/core.py. A dense layer is ``{"w":
(out, in), "b": (out,)}`` (Linear's layout); a conv3d is ``{"w": (Cout,
Cin, kt, kh, kw), "b"}`` (Conv3d's layout). runtime/weights.py converts the
JAX package's checkpoints into these layouts.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d, conv3d

__all__ = ["dense_init", "dense_apply", "conv2d_init", "conv2d_apply",
           "conv3d_init", "conv3d_apply", "layer_norm_init",
           "layer_norm_apply", "group_norm_init", "group_norm_apply",
           "mlp_init", "mlp_apply", "sinusoidal_embedding"]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def dense_init(gen: torch.Generator, din: int, dout: int,
               bias: bool = True, scale: float | None = None) -> dict:
    """Torch's default Linear init (kaiming uniform, a = sqrt(5)); with
    ``scale``, normal weights times ``scale``, and ``scale=0`` a true zero
    layer (nn/core.py:36-50)."""
    bound = 1.0 / math.sqrt(din)
    if scale is None:
        p = {"w": _uniform(gen, (dout, din), bound)}
    else:
        p = {"w": torch.randn((dout, din), generator=gen) * scale}
    if bias:
        p["b"] = (torch.zeros(dout) if scale == 0.0
                  else _uniform(gen, (dout,), bound))
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Products in x's dtype with fp32 accumulation, bias, cast back
    (nn/core.py:53-58)."""
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype),
                    None if b is None else b.to(x.dtype))


def conv2d_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                zero: bool = False) -> dict:
    bound = 1.0 / math.sqrt(kh * kw * cin)
    shape = (cout, cin, kh, kw)
    if zero:
        return {"w": torch.zeros(shape), "b": torch.zeros(cout)}
    return {"w": _uniform(gen, shape, bound), "b": _uniform(gen, (cout,), bound)}


def conv2d_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, p["w"], p.get("b"))


def conv3d_init(gen: torch.Generator, kt: int, kh: int, kw: int, cin: int,
                cout: int, zero: bool = False, groups: int = 1) -> dict:
    bound = 1.0 / math.sqrt(kt * kh * kw * cin // groups)
    shape = (cout, cin // groups, kt, kh, kw)
    if zero:
        return {"w": torch.zeros(shape), "b": torch.zeros(cout)}
    return {"w": _uniform(gen, shape, bound), "b": _uniform(gen, (cout,), bound)}


def conv3d_apply(p: dict, x: torch.Tensor, groups: int = 1,
                 stride=1) -> torch.Tensor:
    return conv3d(x, p["w"], p.get("b"), groups=groups, stride=stride)


def layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 (nn/core.py:106-111)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def group_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def group_norm_apply(p: dict, x: torch.Tensor, groups: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of channels-last ``(B, ..., C)``: fp32 statistics (ddof 0)
    over every non-batch position and the group's ``C // groups``
    consecutive channels, then scale and bias in fp32, cast back
    (nn/core.py:129-152 without ``axis_name``)."""
    *lead, c = x.shape
    xf = x.float().reshape(lead[0], -1, groups, c // groups)
    var, mu = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def mlp_init(gen: torch.Generator, din: int, hidden: int,
             dout: int | None = None) -> dict:
    return {"fc1": dense_init(gen, din, hidden),
            "fc2": dense_init(gen, hidden, dout or din)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, act=_gelu) -> torch.Tensor:
    """fc2(act(fc1(x))); ``act`` defaults to the tanh GELU,
    ``jax.nn.gelu``'s default (nn/core.py:161)."""
    return dense_apply(p["fc2"], act(dense_apply(p["fc1"], x)))


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """Position embedding, cos before sin, in fp32 (nn/core.py:165-173)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
