"""RVRT: shifted-window spatio-temporal attention VSR (the fallback model
of the vsrm and rvrt hierarchies).

Counterpart of video_enhancer_tpu/models/rvrt.py: conv3d embed -> ``depth``
Swin blocks over 3-D windows of ``window`` = (2, 8, 8) tokens (LayerNorm,
qkv, windowed attention with a relative-position bias per head, proj,
residual, LayerNorm + MLP), every second block with the cyclic shift of
half a window -> recon -> per-frame pixel shuffle, added to the bicubic
upscale. The clip is padded with its edge values to window multiples and the
output cropped back. Layout ``(B, T, H, W, C)``.

The attention runs through ``ops.attention.window_attention``, whose CUDA
kernel (csrc/window_attn.cu) replaces the TPU's ``_window_kernel``. Unlike
the JAX package, where that kernel is opt-in on the TPU
(``VETPU_RVRT_ATTN=kernel``, models/rvrt.py:116-131) because it measured
slower than XLA's fused form there, the port launches its kernel for every
CUDA tensor with no switch. ``kernels=False`` runs the plain version, the
form the JAX package runs off the TPU (``attention_ref`` with the bias,
:135), which the kernel is held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..ops.attention import window_attention, window_attention_plain
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.resize import resize

__all__ = ["init", "apply", "WINDOW"]

WINDOW = (2, 8, 8)


@functools.lru_cache(maxsize=8)
def _relpos_index(window: tuple[int, int, int]) -> np.ndarray:
    """``(N, N)`` index into the ``((2wt-1)(2wh-1)(2ww-1), heads)`` bias
    table of each token pair of a window (models/rvrt.py:29-47)."""
    wt, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wt), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += wt - 1
    rel[..., 1] += wh - 1
    rel[..., 2] += ww - 1
    return (rel[..., 0] * (2 * wh - 1) * (2 * ww - 1)
            + rel[..., 1] * (2 * ww - 1) + rel[..., 2])


def _block_init(gen, dim, heads, window):
    wt, wh, ww = window
    table = (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1)
    return {
        "norm1": nn.layer_norm_init(dim),
        "qkv": nn.dense_init(gen, dim, 3 * dim, bias=False),
        "proj": nn.dense_init(gen, dim, dim),
        "bias_table": torch.randn((table, heads), generator=gen) * 0.02,
        "norm2": nn.layer_norm_init(dim),
        "mlp": nn.mlp_init(gen, dim, 2 * dim),
    }


def init(gen: torch.Generator, dim: int = 64, depth: int = 4, heads: int = 4,
         window=WINDOW, scale: int = 4) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts."""
    return {
        "embed": nn.conv3d_init(gen, 1, 3, 3, 3, dim),
        "blocks": [_block_init(gen, dim, heads, tuple(window))
                   for _ in range(depth)],
        "recon": nn.conv3d_init(gen, 1, 3, 3, dim, dim),
        "head": nn.conv3d_init(gen, 1, 3, 3, dim, 3 * scale * scale,
                               zero=True),
    }


def _window_partition(x, window):
    b, t, h, w, c = x.shape
    wt, wh, ww = window
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)


def _window_reverse(wins, window, shape):
    b, t, h, w, c = shape
    wt, wh, ww = window
    x = wins.reshape(b, t // wt, h // wh, w // ww, wt, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, w, c)


def _swin_block(blk, x, heads, window, shift, relpos_idx, attend):
    b, t, h, w, c = x.shape
    wt, wh, ww = window
    shifts = (-wt // 2, -wh // 2, -ww // 2)
    shortcut = x
    x = nn.layer_norm_apply(blk["norm1"], x)
    if shift:
        x = torch.roll(x, shifts, dims=(1, 2, 3))
    wins = _window_partition(x, window)                     # (nW, N, C)
    nW, N, _ = wins.shape
    q, k, v = nn.dense_apply(blk["qkv"], wins).chunk(3, dim=-1)

    def mh(z):
        return z.reshape(nW, N, heads, c // heads).transpose(1, 2)

    bias = blk["bias_table"][relpos_idx].permute(2, 0, 1)   # (heads, N, N)
    a = attend(mh(q), mh(k), mh(v), bias)
    a = a.transpose(1, 2).reshape(nW, N, c)
    x = _window_reverse(nn.dense_apply(blk["proj"], a), window,
                        (b, t, h, w, c))
    if shift:
        x = torch.roll(x, (wt // 2, wh // 2, ww // 2), dims=(1, 2, 3))
    x = shortcut + x
    return x + nn.mlp_apply(blk["mlp"], nn.layer_norm_apply(blk["norm2"], x))


def apply(params: dict, clip: torch.Tensor, scale: int = 4, heads: int = 4,
          window=WINDOW, kernels: bool = True) -> torch.Tensor:
    """``(B, T, H, W, 3)`` in [0, 1] -> ``(B, T, scale*H, scale*W, 3)``.

    ``kernels=True`` takes ``window_attention`` (the CUDA kernel for a CUDA
    tensor); ``False`` its plain version."""
    window = tuple(window)
    b, t, h, w, _ = clip.shape
    wt, wh, ww = window
    pt, ph, pw = (-t) % wt, (-h) % wh, (-w) % ww
    x = clip
    if pt or ph or pw:   # edge padding, one axis at a time (5-D input)
        x = torch.cat([x, x[:, -1:].expand(-1, pt, -1, -1, -1)], dim=1)
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, ph, -1, -1)], dim=2)
        x = torch.cat([x, x[:, :, :, -1:].expand(-1, -1, -1, pw, -1)], dim=3)

    attend = window_attention if kernels else window_attention_plain
    relpos_idx = torch.from_numpy(_relpos_index(window)).to(clip.device)
    feats = nn.conv3d_apply(params["embed"], x)
    for i, blk in enumerate(params["blocks"]):
        feats = _swin_block(blk, feats, heads, window, bool(i % 2),
                            relpos_idx, attend)
    feats = F.silu(nn.conv3d_apply(params["recon"], feats))
    res = pixel_shuffle(nn.conv3d_apply(params["head"], feats), scale)
    res = res[:, :t, :h * scale, :w * scale, :]
    base = resize(clip, (h * scale, w * scale), antialias=False)
    return torch.clamp(base + res, 0.0, 1.0)
