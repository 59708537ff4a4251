"""Diffusion backbone: the noise schedule and the 3-D video UNet.

Counterpart of video_enhancer_tpu/models/diffusion.py without
``time_axis``: the schedule's tables and DDIM step (:35-99), the multi-step
``sample_loop`` (:102-130, a Python loop), and the UNet (:138-324): a
SiLU timestep MLP, 3x3x3 ResBlocks with GroupNorm, stride-(1, 2, 2) down
convs, transposed up convs, and at the levels in ``attn_levels`` the
factorised attention block: spatial attention within each frame as one
head of the level's full width, which the shared dispatcher
(ops/attention.py) sends to the flash kernel on the card (``kernels=False``
takes the plain form), plus ``site_attention`` over time at every site,
summed into one projection. Layout ``(B, T, H, W, C)``; H and W must be
divisible by 2 ** (levels - 1).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..ops import prng
from ..ops.attention import attention, site_attention
from ..ops.conv import conv_transpose3d

__all__ = ["NoiseSchedule", "make_schedule", "sample_loop", "unet_init",
           "unet_apply"]


def _expand(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """The tables in fp32 on the CPU; each method moves what it reads to
    the sample's device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str = "epsilon"   # or "v_prediction"

    def _abar(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        a = self.alphas_cumprod.to(like.device)[t.to(like.device)]
        return _expand(a.to(like.dtype), like.ndim)

    def add_noise(self, clean, noise, t):
        """q(x_t | x_0): sqrt(a_bar) x0 + sqrt(1 - a_bar) eps."""
        a = self._abar(t, clean)
        return torch.sqrt(a) * clean + torch.sqrt(1.0 - a) * noise

    def pred_x0(self, sample, model_out, t):
        a = self._abar(t, sample)
        if self.prediction_type == "epsilon":
            return (sample - torch.sqrt(1.0 - a) * model_out) / torch.sqrt(a)
        return torch.sqrt(a) * sample - torch.sqrt(1.0 - a) * model_out

    def step(self, model_out, t, t_prev, sample):
        """One deterministic DDIM step t -> t_prev (eta 0)."""
        x0 = self.pred_x0(sample, model_out, t)
        abar = self.alphas_cumprod.to(sample.device)
        t_prev = t_prev.to(sample.device)
        a_prev = torch.where(t_prev >= 0, abar[torch.clamp(t_prev, min=0)],
                             1.0)
        a_prev = _expand(a_prev.to(sample.dtype), sample.ndim)
        a = self._abar(t, sample)
        eps = (sample - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def make_schedule(num_timesteps: int = 1000, schedule: str = "cosine",
                  beta_start: float = 8.5e-4, beta_end: float = 1.2e-2,
                  prediction_type: str = "epsilon") -> NoiseSchedule:
    """The tables in float64 numpy, stored in fp32 (diffusion.py:79-99)."""
    if schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_timesteps)
    elif schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps) ** 2
    elif schedule == "cosine":
        s = 0.008
        ts = np.arange(num_timesteps + 1) / num_timesteps
        f = np.cos((ts + s) / (1 + s) * math.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(f"unknown schedule {schedule}")
    return NoiseSchedule(
        betas=torch.from_numpy(betas.astype(np.float32)),
        alphas_cumprod=torch.from_numpy(
            np.cumprod(1.0 - betas).astype(np.float32)),
        num_train_timesteps=num_timesteps, prediction_type=prediction_type)


def _timesteps(start_t: int, num_steps: int) -> list[int]:
    """``jnp.linspace(start_t, 0, num_steps + 1).astype(int32)`` as XLA
    computes it: fp32 ``start (1 - i * (1 / n))`` with the end point exact,
    truncated (so 500 over 10 steps ends 99, 49, 0)."""
    frac = (np.arange(num_steps, dtype=np.float32)
            * (np.float32(1) / np.float32(num_steps)))
    vals = np.float32(start_t) * (np.float32(1) - frac)
    return [int(v) for v in vals.astype(np.int32)] + [0]


def sample_loop(params: dict, cond: torch.Tensor, sched: NoiseSchedule,
                num_steps: int = 20, start_t: int | None = None,
                seed: int = 0, t_dim: int = 128,
                noise: torch.Tensor | None = None,
                kernels: bool = True) -> torch.Tensor:
    """Multi-step DDIM restoration from ``start_t`` to 0 (diffusion.py
    :102-130). ``cond`` is the clip in [-1, 1]; the UNet sees [cond,
    sample]. ``noise`` defaults to JAX's draw for ``seed``
    (``ops/prng.normal``). Returns x0 in [-1, 1]."""
    start_t = start_t or sched.num_train_timesteps // 2
    ts = _timesteps(start_t, num_steps)
    b = cond.shape[0]
    if noise is None:
        noise = prng.normal(seed, cond.shape, cond.dtype, cond.device)

    def full(v):
        return torch.full((b,), v, dtype=torch.int64, device=cond.device)

    sample = sched.add_noise(cond, noise, full(start_t))
    for i in range(num_steps):
        model_in = torch.cat([cond, sample], dim=-1)
        eps = unet_apply(params, model_in, full(ts[i]), t_dim=t_dim,
                         kernels=kernels)
        sample = sched.step(eps.float(), full(ts[i]), full(ts[i + 1]),
                            sample)
    return sample


def _resblock_init(gen, cin, cout, t_dim):
    p = {
        "norm1": nn.group_norm_init(cin),
        "conv1": nn.conv3d_init(gen, 3, 3, 3, cin, cout),
        "t_proj": nn.dense_init(gen, t_dim, cout),
        "norm2": nn.group_norm_init(cout),
        "conv2": nn.conv3d_init(gen, 3, 3, 3, cout, cout, zero=True),
    }
    if cin != cout:
        p["skip"] = nn.conv3d_init(gen, 1, 1, 1, cin, cout)
    return p


def _resblock_apply(p, x, t_emb, groups=8):
    h = F.silu(nn.group_norm_apply(p["norm1"], x, groups))
    h = nn.conv3d_apply(p["conv1"], h)
    h = h + nn.dense_apply(p["t_proj"], t_emb)[:, None, None, None, :]
    h = F.silu(nn.group_norm_apply(p["norm2"], h, groups))
    h = nn.conv3d_apply(p["conv2"], h)
    skip = nn.conv3d_apply(p["skip"], x) if "skip" in p else x
    return skip + h


def _attnblock_init(gen, c):
    return {"norm": nn.group_norm_init(c),
            "qkv": nn.dense_init(gen, c, 3 * c, bias=False),
            "proj": nn.dense_init(gen, c, c, scale=0.0)}


def _attnblock_apply(p, x, groups=8, heads=4, kernels=True):
    """Spatial attention in each frame (one head of width c: the flash
    kernel's ``(B*T, 1, H*W, c)``) plus temporal ``site_attention`` at each
    site with ``heads`` heads, summed into one output projection."""
    b, t, h, w, c = x.shape
    n = nn.group_norm_apply(p["norm"], x, groups)
    q, k, v = nn.dense_apply(p["qkv"], n.reshape(b, t * h * w, c)).chunk(
        3, dim=-1)

    def frames(z):
        return z.reshape(b * t, 1, h * w, c)

    a_sp = attention(frames(q), frames(k), frames(v),
                     use_kernel=None if kernels else False)
    a_sp = a_sp.reshape(b, t * h * w, c)

    def sites(z):
        return (z.reshape(b, t, h, w, c).permute(0, 2, 3, 1, 4)
                .reshape(b * h * w, t, c))

    a_t = site_attention(sites(q), sites(k), sites(v), heads)
    a_t = (a_t.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
           .reshape(b, t * h * w, c))
    return x + nn.dense_apply(p["proj"], a_sp + a_t).reshape(b, t, h, w, c)


def unet_init(gen: torch.Generator, in_channels: int = 6,
              out_channels: int = 3, base: int = 32,
              channel_mult=(1, 2, 4), t_dim: int = 128,
              attn_levels=(2,)) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts;
    the up convs' kernels ``(Cout, Cin, 3, 3, 3)`` as ``conv_transpose3d``
    takes them."""
    chans = [base * m for m in channel_mult]
    params = {
        "t_mlp": nn.mlp_init(gen, t_dim, 4 * t_dim, t_dim),
        "stem": nn.conv3d_init(gen, 3, 3, 3, in_channels, chans[0]),
        "down": [],
        "mid1": _resblock_init(gen, chans[-1], chans[-1], t_dim),
        "mid_attn": _attnblock_init(gen, chans[-1]),
        "mid2": _resblock_init(gen, chans[-1], chans[-1], t_dim),
        "up": [],
        "out_norm": nn.group_norm_init(chans[0]),
        "out_conv": nn.conv3d_init(gen, 3, 3, 3, chans[0], out_channels,
                                   zero=True),
    }
    cin = chans[0]
    for lvl, cout in enumerate(chans):
        stage = {"res": _resblock_init(gen, cin, cout, t_dim)}
        if lvl in attn_levels:
            stage["attn"] = _attnblock_init(gen, cout)
        if lvl < len(chans) - 1:
            stage["down"] = nn.conv3d_init(gen, 3, 3, 3, cout, cout)
        params["down"].append(stage)
        cin = cout
    for lvl in reversed(range(len(chans))):
        cout = chans[lvl]
        stage = {"res": _resblock_init(gen, cin + cout, cout, t_dim)}
        if lvl in attn_levels:
            stage["attn"] = _attnblock_init(gen, cout)
        if lvl > 0:
            stage["up"] = {
                "w": torch.randn((cout, cout, 3, 3, 3), generator=gen) * 0.02,
                "b": torch.zeros(cout)}
        params["up"].append(stage)
        cin = cout
    return params


def unet_apply(params: dict, x: torch.Tensor, t: torch.Tensor,
               t_dim: int = 128, groups: int = 8,
               kernels: bool = True) -> torch.Tensor:
    """``x (B, T, H, W, in)``, ``t (B,)`` timesteps (integer or float) ->
    ``(B, T, H, W, out)``."""
    t_emb = nn.sinusoidal_embedding(t.float(), t_dim).to(x.dtype)
    t_emb = nn.mlp_apply(params["t_mlp"], t_emb, act=F.silu)

    h = nn.conv3d_apply(params["stem"], x)
    skips = []
    for stage in params["down"]:
        h = _resblock_apply(stage["res"], h, t_emb, groups)
        if "attn" in stage:
            h = _attnblock_apply(stage["attn"], h, groups, kernels=kernels)
        skips.append(h)
        if "down" in stage:
            h = nn.conv3d_apply(stage["down"], h, stride=(1, 2, 2))

    h = _resblock_apply(params["mid1"], h, t_emb, groups)
    h = _attnblock_apply(params["mid_attn"], h, groups, kernels=kernels)
    h = _resblock_apply(params["mid2"], h, t_emb, groups)

    for stage in params["up"]:
        h = _resblock_apply(stage["res"], torch.cat([h, skips.pop()], dim=-1),
                            t_emb, groups)
        if "attn" in stage:
            h = _attnblock_apply(stage["attn"], h, groups, kernels=kernels)
        if "up" in stage:
            h = conv_transpose3d(h, stage["up"]["w"], stage["up"]["b"],
                                 stride=(1, 2, 2))

    h = F.silu(nn.group_norm_apply(params["out_norm"], h, groups))
    return nn.conv3d_apply(params["out_conv"], h)
