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

from ..ops.conv import conv3d

__all__ = ["dense_init", "dense_apply", "conv3d_init", "conv3d_apply",
           "layer_norm_init", "layer_norm_apply", "mlp_init", "mlp_apply"]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def dense_init(gen: torch.Generator, din: int, dout: int,
               bias: bool = True) -> dict:
    """Torch's default Linear init (kaiming uniform, a = sqrt(5))."""
    bound = 1.0 / math.sqrt(din)
    p = {"w": _uniform(gen, (dout, din), bound)}
    if bias:
        p["b"] = _uniform(gen, (dout,), bound)
    return p


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Products in x's dtype with fp32 accumulation, bias, cast back
    (nn/core.py:53-58)."""
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype),
                    None if b is None else b.to(x.dtype))


def conv3d_init(gen: torch.Generator, kt: int, kh: int, kw: int, cin: int,
                cout: int, zero: bool = False) -> dict:
    bound = 1.0 / math.sqrt(kt * kh * kw * cin)
    shape = (cout, cin, kt, kh, kw)
    if zero:
        return {"w": torch.zeros(shape), "b": torch.zeros(cout)}
    return {"w": _uniform(gen, shape, bound), "b": _uniform(gen, (cout,), bound)}


def conv3d_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return conv3d(x, p["w"], p.get("b"))


def layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 (nn/core.py:106-111)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def mlp_init(gen: torch.Generator, din: int, hidden: int) -> dict:
    return {"fc1": dense_init(gen, din, hidden),
            "fc2": dense_init(gen, hidden, din)}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(x))) with the tanh GELU, ``jax.nn.gelu``'s default
    (nn/core.py:161)."""
    return dense_apply(p["fc2"],
                       F.gelu(dense_apply(p["fc1"], x), approximate="tanh"))
