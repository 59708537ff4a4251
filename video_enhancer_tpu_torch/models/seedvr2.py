"""SeedVR2: one-step diffusion video restoration at scale 1.

Counterpart of video_enhancer_tpu/models/seedvr2.py without ``time_axis``:
noise the clip at a timestep that a quality MLP shifts from 500, feed
[clean, noisy] (6 channels) to the 3-D UNet (models/diffusion.py), recover
x0 in the epsilon form, then the temporal-consistency module (per-site
temporal attention, a light flow net and a gather warp of the previous
frame, a (3, 1, 1) fuse conv) and the calibrated blend toward the input.
Layout ``(B, T, H, W, 3)`` in [0, 1]; H and W divisible by 4.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .. import nn
from ..ops import prng
from ..ops.attention import site_attention
from ..ops.warp import flow_warp
from .diffusion import make_schedule, sample_loop, unet_apply, unet_init

__all__ = ["init", "apply", "default_config", "FIXED_T", "DEFAULT_STRENGTH"]

FIXED_T = 500             # the timestep the quality shift starts from
# the calibrated output blend: the JAX package's measured operating point
# (+0.451 dB ind / -0.084 alt on the bundled weights, seedvr2.py:26-31)
DEFAULT_STRENGTH = 0.2


def default_config() -> dict:
    return {"base_channels": 32, "channel_mult": (1, 2, 4), "heads": 4}


def _flownet_init(gen, dim=16):
    return {"c1": nn.conv2d_init(gen, 3, 3, 6, dim),
            "c2": nn.conv2d_init(gen, 3, 3, dim, dim),
            "c3": nn.conv2d_init(gen, 3, 3, dim, 2, zero=True)}


def _flownet_apply(p, a, b):
    """``(B, H, W, 3)`` pair -> ``(B, H, W, 2)`` flow as (dy, dx)."""
    h = F.relu(nn.conv2d_apply(p["c1"], torch.cat([a, b], dim=-1)))
    h = F.relu(nn.conv2d_apply(p["c2"], h))
    return nn.conv2d_apply(p["c3"], h)


def _tc_init(gen, dim=32):
    return {"proj_in": nn.conv3d_init(gen, 1, 1, 1, 3, dim),
            "qkv": nn.dense_init(gen, dim, 3 * dim, bias=False),
            "attn_out": nn.dense_init(gen, dim, dim),
            "flow": _flownet_init(gen),
            "fuse": nn.conv3d_init(gen, 3, 1, 1, dim + 3, 3, zero=True)}


def _tc_apply(p, clip, heads=4):
    """Temporal consistency: per-site temporal attention over the features,
    the previous frame (the first frame's is itself) warped onto each frame
    by the flow net, both fused by a (3, 1, 1) conv, residual into the
    clip (seedvr2.py:68-118)."""
    b, t, h, w, c = clip.shape
    feats = nn.conv3d_apply(p["proj_in"], clip)
    d = feats.shape[-1]
    seq = feats.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
    q, k, v = nn.dense_apply(p["qkv"], seq).chunk(3, dim=-1)
    seq = seq + nn.dense_apply(p["attn_out"], site_attention(q, k, v, heads))
    feats = seq.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)

    prev = torch.cat([clip[:, :1], clip[:, :-1]], dim=1)
    flow = _flownet_apply(p["flow"], clip.reshape(b * t, h, w, c),
                          prev.reshape(b * t, h, w, c))
    warped = flow_warp(prev.reshape(b * t, h, w, c),
                       flow.to(clip.dtype)).reshape(b, t, h, w, c)
    fused = nn.conv3d_apply(p["fuse"], torch.cat([feats, warped], dim=-1))
    return clip + fused


def init(gen: torch.Generator, base_channels: int = 32,
         channel_mult=(1, 2, 4), heads: int = 4) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts.
    The head count changes no shape: it is an argument of ``apply``."""
    return {"unet": unet_init(gen, in_channels=6, out_channels=3,
                              base=base_channels, channel_mult=channel_mult),
            "tc": _tc_init(gen),
            "quality": nn.mlp_init(gen, 4, 32, 1)}


def _quality_stats(x: torch.Tensor) -> torch.Tensor:
    """(mean, std, mean |frame difference|, max |x|) of each clip, the
    mean and std from sums, as the JAX package computes them
    (seedvr2.py:175-185)."""
    dims = (1, 2, 3, 4)
    cnt = x[0].numel()
    mean = x.sum(dims) / cnt
    std = torch.sqrt(torch.clamp((x * x).sum(dims) / cnt - mean * mean,
                                 min=0.0))
    tdiff = ((x[:, 1:] - x[:, :-1]).abs().mean(dims) if x.shape[1] > 1
             else torch.zeros_like(mean))
    amax = x.abs().amax(dims)
    return torch.stack([mean, std, tdiff, amax], dim=-1)


def apply(params: dict, clip: torch.Tensor, seed: int = 0, heads: int = 4,
          num_steps: int = 1, t_cap: float | None = None,
          strength: float | None = None, noise: torch.Tensor | None = None,
          kernels: bool = True, time_axis: str | None = None) -> torch.Tensor:
    """``(B, T, H, W, 3)`` in [0, 1] -> the restored clip, same shape.

    The timestep is continuous: ``tf = clip(500 + 495 tanh(quality(stats)),
    1, min(t_cap, 999 - 1e-3))`` with the schedule's a_bar interpolated
    between ``floor(tf)`` and the next entry. ``t_cap`` defaults to
    ``$VETPU_SEEDVR2_T_CAP`` (read at the call), else 999. ``num_steps > 1``
    runs the DDIM loop from 500 (``diffusion.sample_loop``) instead.

    ``noise`` (the clip's shape) is the draw added to the clip; by default
    it is JAX's ``jax.random.normal(PRNGKey(seed), x.shape, x.dtype)``
    reproduced in torch ops (``ops/prng.normal``), which is what serving
    uses, so the port and the JAX package add the same noise for a seed.

    ``strength`` (default ``$VETPU_SEEDVR2_STRENGTH``, else 0.2) blends the
    output toward the input: ``clip(s out + (1 - s) clip, 0, 1)``.
    ``kernels=False`` runs the UNet's spatial attention in its plain form,
    the reference the flash kernel is held against. ``time_axis`` (the
    JAX package's T-sharded form) is not ported and raises."""
    if time_axis is not None:
        raise NotImplementedError("seedvr2's time_axis is not ported")
    sched = make_schedule()
    x = clip * 2.0 - 1.0

    t_shift = 495.0 * torch.tanh(
        nn.mlp_apply(params["quality"], _quality_stats(x))[..., 0].float())
    tmax = float(sched.num_train_timesteps - 1)
    if t_cap is None:
        t_cap = float(os.environ.get("VETPU_SEEDVR2_T_CAP", tmax))
    tf = torch.clamp(FIXED_T + t_shift, 1.0, min(float(t_cap), tmax - 1e-3))
    t0 = torch.floor(tf).long()
    frac = tf - t0.float()
    abar = sched.alphas_cumprod.to(x.device)
    ab = abar[t0] * (1.0 - frac) + abar[t0 + 1] * frac

    if noise is None:
        noise = prng.normal(seed, x.shape, x.dtype, x.device)
    if num_steps > 1:
        x0 = sample_loop(params["unet"], x, sched, num_steps=num_steps,
                         start_t=FIXED_T, seed=seed, noise=noise.to(x.dtype),
                         kernels=kernels)
    else:
        sqrt_ab = torch.sqrt(ab)[:, None, None, None, None]
        sqrt_1mab = torch.sqrt(1.0 - ab)[:, None, None, None, None]
        noisy = sqrt_ab.to(x.dtype) * x + sqrt_1mab.to(x.dtype) * noise.to(
            x.dtype)
        eps = unet_apply(params["unet"], torch.cat([x, noisy], dim=-1), tf,
                         kernels=kernels)
        x0 = (noisy.float() - sqrt_1mab * eps.float()) / sqrt_ab

    restored = _tc_apply(params["tc"], ((x0 + 1.0) / 2.0).to(clip.dtype),
                         heads)
    restored = torch.clamp(restored, 0.0, 1.0)
    if strength is None:
        strength = float(os.environ.get("VETPU_SEEDVR2_STRENGTH",
                                        DEFAULT_STRENGTH))
    s = float(strength)
    if s != 1.0:
        restored = torch.clamp(s * restored + (1.0 - s) * clip, 0.0, 1.0)
    return restored
