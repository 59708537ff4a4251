"""VSRM: Mamba-based video super-resolution (the x4 model of the main path).

Counterpart of video_enhancer_tpu/models/vsrm.py with ``mixer="ssd"``: conv3d embed -> blocks of (bidirectional SSD over each
frame's H*W raster, per-site temporal attention + bidirectional temporal
SSM, MLP) -> flow-based alignment -> recon -> per-frame pixel shuffle, added
to the bicubic upscale. The head and the offset conv start at zero, so an
untrained model returns exact bicubic. Layout ``(B, T, H, W, C)``.

With ``time_axis`` (parallel/mesh.py) the clip is this rank's T shard and
the model runs exactly over the whole clip: the temporal attention's keys
and values are gathered over the axis, and the temporal SSM runs the
distributed scans (``bissm_apply_sharded``); every conv has a T-kernel of
1, so nothing else couples the frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..nn.ssm import (bissd_apply, bissd_init, bissm_apply,
                      bissm_apply_sharded, bissm_init)
from ..ops.attention import site_attention
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.resize import resize
from ..ops.warp import flow_warp_local

__all__ = ["init", "apply"]


def _block_init(gen, dim, state_dim):
    return {
        "spatial_norm": nn.layer_norm_init(dim),
        "spatial_ssm": bissd_init(gen, dim, state_dim=2 * state_dim,
                                  head_dim=64),
        "temporal_norm": nn.layer_norm_init(dim),
        "qkv": nn.dense_init(gen, dim, 3 * dim, bias=False),
        "attn_out": nn.dense_init(gen, dim, dim),
        "temporal_ssm": bissm_init(gen, dim, state_dim=min(state_dim, 4)),
        "mlp_norm": nn.layer_norm_init(dim),
        "mlp": nn.mlp_init(gen, dim, dim * 2),
    }


def init(gen: torch.Generator, dim: int = 64, num_blocks: int = 6,
         scale: int = 4, state_dim: int = 8) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts."""
    return {
        "embed": nn.conv3d_init(gen, 1, 3, 3, 3, dim),
        "blocks": [_block_init(gen, dim, state_dim) for _ in range(num_blocks)],
        "offset": nn.conv3d_init(gen, 1, 3, 3, dim, 2, zero=True),
        "align_fuse": nn.conv3d_init(gen, 1, 1, 1, 2 * dim, dim),
        "recon": nn.conv3d_init(gen, 1, 3, 3, dim, dim),
        "head": nn.conv3d_init(gen, 1, 3, 3, dim, 3 * scale * scale,
                               zero=True),
    }


def _spatial_ssm(p, x, kernels):
    b, t, h, w, c = x.shape
    y = bissd_apply(p, x.reshape(b * t, h * w, c),
                    use_kernel=None if kernels else False)
    return y.reshape(b, t, h, w, c)


def _temporal_mix(blk, x, heads, kernels, time_axis=None):
    b, t, h, w, c = x.shape
    seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    q, k, v = nn.dense_apply(blk["qkv"], seq).chunk(3, dim=-1)
    if time_axis is not None:
        k = time_axis.all_gather(k, dim=1, tiled=True)
        v = time_axis.all_gather(v, dim=1, tiled=True)
    seq = seq + nn.dense_apply(blk["attn_out"], site_attention(q, k, v, heads))
    if time_axis is not None:
        seq = seq + bissm_apply_sharded(blk["temporal_ssm"], seq, time_axis,
                                        impl=None if kernels else "ref")
    else:
        seq = seq + bissm_apply(blk["temporal_ssm"], seq,
                                impl="fused" if kernels else "plain")
    return seq.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def _deformable_align(params, feats):
    offsets = torch.tanh(nn.conv3d_apply(params["offset"], feats))
    b, t, h, w, c = feats.shape
    warped = flow_warp_local(feats.reshape(b * t, h, w, c),
                             offsets.to(feats.dtype).reshape(b * t, h, w, 2))
    fused = nn.conv3d_apply(
        params["align_fuse"],
        torch.cat([feats, warped.reshape(b, t, h, w, c)], dim=-1))
    return feats + fused


def apply(params: dict, clip: torch.Tensor, scale: int = 4, heads: int = 4,
          kernels: bool = True, time_axis=None) -> torch.Tensor:
    """``(B, T, H, W, 3)`` in [0, 1] -> ``(B, T, scale*H, scale*W, 3)``.

    ``kernels=True`` keeps the JAX package's dispatch (the SSD kernel for
    half-precision input, the fused SSM kernel always, or with
    ``time_axis`` the scan kernels by ``selective_scan``'s rule); ``False``
    runs the plain PyTorch versions, the reference the kernels are held
    against. ``time_axis``: the clip is this rank's T shard (see the module
    docstring)."""
    x = clip
    feats = nn.conv3d_apply(params["embed"], x)
    for blk in params["blocks"]:
        h = nn.layer_norm_apply(blk["spatial_norm"], feats)
        feats = feats + _spatial_ssm(blk["spatial_ssm"], h, kernels)
        h = nn.layer_norm_apply(blk["temporal_norm"], feats)
        feats = feats + _temporal_mix(blk, h, heads, kernels, time_axis)
        h = nn.layer_norm_apply(blk["mlp_norm"], feats)
        feats = feats + nn.mlp_apply(blk["mlp"], h)

    feats = _deformable_align(params, feats)
    feats = F.silu(nn.conv3d_apply(params["recon"], feats))
    res = pixel_shuffle(nn.conv3d_apply(params["head"], feats), scale)
    base = resize(x, (x.shape[2] * scale, x.shape[3] * scale), antialias=False)
    return torch.clamp(base + res, 0.0, 1.0)
