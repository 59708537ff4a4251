"""FastMambaVSR: the strict-latency x4 model, a bidirectional selective scan
along time at every pixel.

Counterpart of video_enhancer_tpu/models/fast_mamba_vsr.py: separable-conv3d
embeds ->
multi-scale fusion (2x2 average pools, separable convs, linear upsampling,
1x1 fuse) -> ``num_layers`` layers of (LayerNorm, the shared-stream
bidirectional SSM over each pixel's (T, C) sequence, depthwise and
pointwise spatial convs, a 0.1-scaled skip every second layer) -> refine ->
head -> per-frame pixel shuffle, added to the bicubic upscale, plus a
0.1-scaled (3, 1, 1) temporal conv of the result. The head and the temporal
conv start at zero, so an untrained model returns exact bicubic. Layout
``(B, T, H, W, C)``.

The temporal mixer is chosen at ``init`` (JAX :83-87):

- ``"ssm"`` (the default): ``nn.ssm.bissm_apply``, whose fused interior
  runs the CUDA kernel csrc/fused_bissm.cu for a CUDA tensor (the TPU's
  ``_fused_bissm_kernel``), here at (B*H*W, T, inner 96, N 8, K 5, rank 3);
- ``"ssd"`` (``fast_mamba_vsr_ssd``): ``nn.ssm.bissd_apply`` with one head
  a layer width (inner 96, 2 heads of P 48, N 8), whose two SSD scans run
  the CUDA kernel csrc/ssd_shared.cu (the TPU's SSD kernels) at (B*H*W, T,
  2, 48, 8) for a CUDA tensor. The JAX package runs this mixer in its plain
  form (:113-116: its chunked TPU kernels stall at long L and small b); the
  port's kernel takes b past 65,535, so on the card it runs there.

``kernels=False`` runs the plain versions of either.

With ``time_axis`` (parallel/mesh.py) the clip is this rank's T shard and
the model runs exactly over the whole clip: the temporal SSM is
``bissm_apply_sharded`` (the distributed scans, four short-scan kernels a
layer on the card), or on the ssd mixer ``bissd_apply_sharded`` (the
distributed SSD scan, two SSD kernels a layer at (B*H*W, T / n, 2, 48, 8)),
and the final temporal conv exchanges 1-frame halos, zeroed at the global
edges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..nn.ssm import (bissd_apply, bissd_apply_sharded, bissd_init,
                      bissm_apply, bissm_apply_sharded, bissm_init)
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.resize import resize
from ..parallel.temporal import halo_exchange_time

__all__ = ["init", "apply", "default_config"]


def default_config() -> dict:
    return {"dim": 48, "num_layers": 8, "scale": 4, "state_dim": 8,
            "expand": 2, "groups": 8}


def _sepconv3d_init(gen, cin, cout):
    """Depthwise (1, 3, 3) then pointwise conv3d."""
    return {"dw": nn.conv3d_init(gen, 1, 3, 3, cin, cin, groups=cin),
            "pw": nn.conv3d_init(gen, 1, 1, 1, cin, cout)}


def _sepconv3d_apply(p, x):
    return nn.conv3d_apply(p["pw"],
                           nn.conv3d_apply(p["dw"], x, groups=x.shape[-1]))


def init(gen: torch.Generator, dim: int = 48, num_layers: int = 8,
         scale: int = 4, state_dim: int = 8, expand: int = 2,
         temporal_mixer: str = "ssm") -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts;
    ``temporal_mixer`` "ssm" or "ssd"."""
    if temporal_mixer not in ("ssm", "ssd"):
        raise ValueError(f"unknown temporal_mixer {temporal_mixer!r}")

    def mixer():
        if temporal_mixer == "ssd":
            return bissd_init(gen, dim, state_dim=state_dim, expand=expand,
                              head_dim=dim)
        return bissm_init(gen, dim, state_dim=state_dim, expand=expand)

    return {
        "embed1": _sepconv3d_init(gen, 3, dim),
        "embed2": _sepconv3d_init(gen, dim, dim),
        "ms_down2": _sepconv3d_init(gen, dim, dim),
        "ms_down4": _sepconv3d_init(gen, dim, dim),
        "ms_fuse": nn.conv3d_init(gen, 1, 1, 1, 3 * dim, dim),
        "layers": [{
            "norm": nn.layer_norm_init(dim),
            "bimamba": mixer(),
            "spatial_dw": nn.conv3d_init(gen, 1, 3, 3, dim, dim, groups=dim),
            "spatial_pw": nn.conv3d_init(gen, 1, 1, 1, dim, dim),
        } for _ in range(num_layers)],
        "refine": _sepconv3d_init(gen, dim, dim),
        "head": nn.conv3d_init(gen, 1, 3, 3, dim, 3 * scale * scale,
                               zero=True),
        "temporal": nn.conv3d_init(gen, 3, 1, 1, 3, 3, zero=True),
    }


def _temporal_bimamba(p, x, kernels, time_axis=None):
    """The bidirectional SSM (or SSD: the layer holds ``norm_scale``) along
    T at every pixel: (B, T, H, W, C) -> sequences (B*H*W, T, C) -> back."""
    b, t, h, w, c = x.shape
    seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    if "norm_scale" in p:
        if time_axis is not None:
            y = bissd_apply_sharded(p, seq, time_axis, use_kernel=kernels)
        else:
            y = bissd_apply(p, seq, use_kernel=kernels)
    elif time_axis is not None:
        y = bissm_apply_sharded(p, seq, time_axis,
                                impl=None if kernels else "ref")
    else:
        y = bissm_apply(p, seq, impl="fused" if kernels else "plain")
    return y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def _avg_pool2(x):
    """2x2 average pool over H and W, VALID (an odd last row or column is
    dropped)."""
    b, t, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :, :2 * h2, :2 * w2].reshape(b, t, h2, 2, w2, 2, c)
    return x.sum(dim=(3, 5)) / 4.0


def _multi_scale(params, feats):
    b, t, h, w, c = feats.shape
    x2 = _avg_pool2(feats)
    x4 = _avg_pool2(x2)
    x2 = resize(_sepconv3d_apply(params["ms_down2"], x2), (h, w),
                method="linear")
    x4 = resize(_sepconv3d_apply(params["ms_down4"], x4), (h, w),
                method="linear")
    return nn.conv3d_apply(params["ms_fuse"], torch.cat([feats, x2, x4], -1))


def apply(params: dict, clip: torch.Tensor, scale: int = 4,
          kernels: bool = True, time_axis=None) -> torch.Tensor:
    """``(B, T, H, W, 3)`` in [0, 1] -> ``(B, T, scale*H, scale*W, 3)``.

    ``kernels=True`` runs the fused SSM kernel for a CUDA tensor (with
    ``time_axis``, the scan kernels by ``selective_scan``'s rule), or the
    SSD kernel on the ssd mixer; ``False`` the plain versions.
    ``time_axis``: the clip is this rank's T shard (see the module
    docstring)."""
    x = clip
    feats = _sepconv3d_apply(params["embed2"],
                             F.silu(_sepconv3d_apply(params["embed1"], x)))
    feats = feats + _multi_scale(params, feats)

    skip = feats
    for i, layer in enumerate(params["layers"]):
        h = nn.layer_norm_apply(layer["norm"], feats)
        feats = feats + _temporal_bimamba(layer["bimamba"], h, kernels,
                                          time_axis)
        s = nn.conv3d_apply(layer["spatial_dw"], feats, groups=feats.shape[-1])
        feats = feats + nn.conv3d_apply(layer["spatial_pw"], F.silu(s))
        if i % 2 == 1:
            feats = feats + 0.1 * skip
            skip = feats

    feats = F.silu(_sepconv3d_apply(params["refine"], feats))
    res = pixel_shuffle(nn.conv3d_apply(params["head"], feats), scale)
    base = resize(x, (x.shape[2] * scale, x.shape[3] * scale), antialias=False)
    out = base + res
    out = out + 0.1 * _temporal_conv(params["temporal"], out, time_axis)
    return nn.clip(out, 0.0, 1.0)


def _temporal_conv(p, out, time_axis):
    """The (3, 1, 1) temporal conv; over a T shard, with 1-frame halos from
    the neighbours, zeroed at the global edges (the unsharded zero
    padding)."""
    if time_axis is None:
        return nn.conv3d_apply(p, out)
    oh = halo_exchange_time(out, 1, time_axis)
    if time_axis.index == 0:
        oh[:, :1] = 0
    if time_axis.index == time_axis.size - 1:
        oh[:, -1:] = 0
    return nn.conv3d_apply(p, oh)[:, 1:-1]
