"""The released GFPGAN v1 "clean" generator (the graph inside
``GFPGANv1.4.pth``): a U-Net encoder that gives per-resolution SFT
conditions and a style code, and a StyleGAN2 "clean" decoder.

Counterpart of video_enhancer_tpu/models/official_gfpgan.py. The parameter
tree is keyed like the official state dict, so a ``.pth`` loads through
runtime/weights.py (``try_load_params``) key for key, and so does the JAX
package's tree saved as a ``.npz``. Weights are in PyTorch's layouts:
Conv2d ``(O, I, kh, kw)``, Linear ``(O, I)``, the modulated conv's 5-D
``(1, O, I, k, k)``, ``ConstantInput`` ``(1, C, 4, 4)``, StyleConv's
noise strength the 1-D ``w`` of one element, the 4-D biases ``(1, C, 1,
1)`` and the noise buffers ``(1, 1, r, r)`` as stored.

As in the JAX package, the modulated conv is reassociated: the input's
channels scaled by the modulation, one conv with the shared weight, the
output's channels demodulated (``rsqrt(sum_k w^2 s^2 + 1e-8)``), which
equals the official grouped conv with B x O groups. Resizes are bilinear
without antialias (ops/resize.py, as torch's ``F.interpolate``); the noise
is the stored buffers (the official ``randomize_noise=False``). Frames
are channels-last ``(B, S, S, 3)`` in [-1, 1].

The SFT between a level's two convs runs while ``i < len(conditions)``,
the official guard; the JAX package tests ``i - 1 < len(conditions)``,
which is the same for every configuration it runs (its conditions always
number two a level).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.resize import resize

__all__ = ["gfpgan_official_init", "gfpgan_official_apply",
           "gfpgan_channels"]


def gfpgan_channels(channel_multiplier: float = 2.0,
                    narrow: float = 1.0) -> dict[int, int]:
    """The published StyleGAN2-clean channel table (v1.4: multiplier 2,
    narrow 1)."""
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
    }


# --- leaf inits ---------------------------------------------------------


def _conv_init(gen, k: int, cin: int, cout: int, bias: bool = True) -> dict:
    p = nn.conv2d_init(gen, k, k, cin, cout)
    if not bias:
        del p["b"]
    return p


def _linear_init(gen, cin: int, cout: int) -> dict:
    return {"w": torch.randn((cout, cin), generator=gen) * 0.02,
            "b": torch.zeros(cout)}


def _modconv_init(gen, cin: int, cout: int, k: int, nsf: int) -> dict:
    # the modulation as the official graph initialises it: bias 1
    return {"w": torch.randn((1, cout, cin, k, k), generator=gen)
            / math.sqrt(cin * k * k),
            "modulation": {"w": torch.randn((cin, nsf), generator=gen)
                           / math.sqrt(nsf), "b": torch.ones(cin)}}


def _styleconv_init(gen, cin: int, cout: int, k: int, nsf: int) -> dict:
    return {"modulated_conv": _modconv_init(gen, cin, cout, k, nsf),
            "w": torch.zeros(1),                     # noise strength
            "b": torch.zeros((1, cout, 1, 1))}


def _torgb_init(gen, cin: int, nsf: int) -> dict:
    return {"modulated_conv": _modconv_init(gen, cin, 3, 1, nsf),
            "b": torch.zeros((1, 3, 1, 1))}


def _resblock_init(gen, cin: int, cout: int) -> dict:
    return {"conv1": _conv_init(gen, 3, cin, cin),
            "conv2": _conv_init(gen, 3, cin, cout),
            "skip": _conv_init(gen, 1, cin, cout, bias=False)}


# --- leaf applies -------------------------------------------------------


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    return resize(x, hw, antialias=False, method="linear")


def _nchw_bias(b: torch.Tensor) -> torch.Tensor:
    return b.permute(0, 2, 3, 1)


def _modconv_apply(p: dict, x: torch.Tensor, style: torch.Tensor, *,
                   demodulate: bool, sample_mode: str | None = None,
                   eps: float = 1e-8) -> torch.Tensor:
    """The official ModulatedConv2d, reassociated."""
    w = p["w"][0]                                    # (O, I, k, k)
    s = nn.dense_apply(p["modulation"], style)      # (B, I)
    h, wd = x.shape[1:3]
    if sample_mode == "upsample":
        x = _bilinear(x, (h * 2, wd * 2))
    elif sample_mode == "downsample":
        x = _bilinear(x, (h // 2, wd // 2))
    y = nn.conv2d_apply({"w": w}, x * s[:, None, None, :])
    if demodulate:
        wsq = torch.square(w.float()).sum((2, 3))     # (O, I)
        d = torch.rsqrt(torch.square(s.float()) @ wsq.T + eps)
        y = y * d[:, None, None, :].to(y.dtype)
    return y


def _styleconv_apply(p: dict, x, style, noise, sample_mode=None):
    y = _modconv_apply(p["modulated_conv"], x, style, demodulate=True,
                       sample_mode=sample_mode) * math.sqrt(2.0)
    y = y + p["w"][0] * noise
    return _lrelu(y + _nchw_bias(p["b"]))


def _torgb_apply(p: dict, x, style, skip=None):
    y = _modconv_apply(p["modulated_conv"], x, style, demodulate=False)
    y = y + _nchw_bias(p["b"])
    if skip is not None:
        y = y + _bilinear(skip, (skip.shape[1] * 2, skip.shape[2] * 2))
    return y


def _resblock_apply(p: dict, x: torch.Tensor, mode: str) -> torch.Tensor:
    h = _lrelu(nn.conv2d_apply(p["conv1"], x))
    hw = ((x.shape[1] // 2, x.shape[2] // 2) if mode == "down"
          else (x.shape[1] * 2, x.shape[2] * 2))
    h = _lrelu(nn.conv2d_apply(p["conv2"], _bilinear(h, hw)))
    return h + nn.conv2d_apply(p["skip"], _bilinear(x, hw))


def _norm_style(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=-1,
                                      keepdim=True) + 1e-8)


# --- decoder (StyleGAN2GeneratorCSFT, clean) ---------------------------


def _decoder_init(gen, out_size: int, nsf: int, num_mlp: int,
                  channels: dict[int, int]) -> dict:
    log_size = int(math.log2(out_size))
    num_layers = (log_size - 2) * 2 + 1
    # Sequential(NormStyleCode, [Linear, LeakyReLU] * num_mlp): the linears
    # sit at odd indices
    style_mlp = {str(2 * i + 1): _linear_init(gen, nsf, nsf)
                 for i in range(num_mlp)}
    style_convs, to_rgbs = [], []
    cin = channels[4]
    for i in range(3, log_size + 1):
        cout = channels[2 ** i]
        style_convs.append(_styleconv_init(gen, cin, cout, 3, nsf))
        style_convs.append(_styleconv_init(gen, cout, cout, 3, nsf))
        to_rgbs.append(_torgb_init(gen, cout, nsf))
        cin = cout
    noises = {}
    for i in range(num_layers):
        r = 2 ** ((i + 5) // 2)
        noises[f"noise{i}"] = torch.randn((1, 1, r, r), generator=gen)
    return {
        "style_mlp": style_mlp,
        "constant_input": {"w": torch.randn((1, channels[4], 4, 4),
                                            generator=gen)},
        "style_conv1": _styleconv_init(gen, channels[4], channels[4], 3, nsf),
        "to_rgb1": _torgb_init(gen, channels[4], nsf),
        "style_convs": style_convs,
        "to_rgbs": to_rgbs,
        "noises": noises,
    }


def _decoder_apply(p: dict, latent: torch.Tensor, conditions: list,
                   *, sft_half: bool) -> torch.Tensor:
    """``latent (B, num_latent, nsf)``; ``conditions`` [scale0, shift0,
    ...] channels-last."""
    noise = [p["noises"][f"noise{i}"].permute(0, 2, 3, 1)
             for i in range(len(p["noises"]))]
    b = latent.shape[0]
    out = p["constant_input"]["w"].permute(0, 2, 3, 1)
    out = out.expand((b,) + tuple(out.shape[1:])).to(latent.dtype)
    out = _styleconv_apply(p["style_conv1"], out, latent[:, 0], noise[0])
    skip = _torgb_apply(p["to_rgb1"], out, latent[:, 1])
    i = 1
    for j in range(len(p["to_rgbs"])):
        out = _styleconv_apply(p["style_convs"][2 * j], out, latent[:, i],
                               noise[2 * j + 1], sample_mode="upsample")
        if i < len(conditions):               # SFT between the two convs
            if sft_half:
                half = out.shape[-1] // 2
                out_same, out_sft = out[..., :half], out[..., half:]
                out_sft = out_sft * conditions[i - 1] + conditions[i]
                out = torch.cat([out_same, out_sft], dim=-1)
            else:
                out = out * conditions[i - 1] + conditions[i]
        out = _styleconv_apply(p["style_convs"][2 * j + 1], out,
                               latent[:, i + 1], noise[2 * j + 2])
        skip = _torgb_apply(p["to_rgbs"][j], out, latent[:, i + 2], skip)
        i += 2
    return skip


# --- GFPGANv1Clean -------------------------------------------------------


def gfpgan_official_init(gen: torch.Generator, out_size: int = 512,
                         num_style_feat: int = 512, num_mlp: int = 8,
                         channel_multiplier: float = 2.0,
                         narrow: float = 1.0, different_w: bool = True,
                         sft_half: bool = True) -> dict:
    """Parameters keyed exactly like ``GFPGANv1.4.pth`` (v1.4 config:
    out_size 512, channel_multiplier 2, different_w, sft_half,
    input_is_latent)."""
    log_size = int(math.log2(out_size))
    dec_ch = gfpgan_channels(channel_multiplier, narrow)
    unet_ch = gfpgan_channels(channel_multiplier, narrow * 0.5)
    conv_body_down, cin = [], unet_ch[out_size]
    for i in range(log_size, 2, -1):
        cout = unet_ch[2 ** (i - 1)]
        conv_body_down.append(_resblock_init(gen, cin, cout))
        cin = cout
    conv_body_up, to_rgb, cond_scale, cond_shift = [], [], [], []
    cin = unet_ch[4]
    for i in range(3, log_size + 1):
        cout = unet_ch[2 ** i]
        conv_body_up.append(_resblock_init(gen, cin, cout))
        to_rgb.append(_conv_init(gen, 1, cout, 3))
        sft_out = cout if sft_half else cout * 2
        for cond in (cond_scale, cond_shift):
            cond.append({"0": _conv_init(gen, 3, cout, cout),
                         "2": _conv_init(gen, 3, cout, sft_out)})
        cin = cout
    num_latent = log_size * 2 - 2
    lin_out = num_latent * num_style_feat if different_w else num_style_feat
    return {
        "conv_body_first": _conv_init(gen, 1, 3, unet_ch[out_size]),
        "conv_body_down": conv_body_down,
        "final_conv": _conv_init(gen, 3, unet_ch[8], unet_ch[4]),
        "conv_body_up": conv_body_up,
        "toRGB": to_rgb,
        "final_linear": _linear_init(gen, unet_ch[4] * 4 * 4, lin_out),
        "condition_scale": cond_scale,
        "condition_shift": cond_shift,
        "stylegan_decoder": _decoder_init(gen, out_size, num_style_feat,
                                          num_mlp, dec_ch),
    }


def gfpgan_official_apply(params: dict, x: torch.Tensor, *,
                          num_style_feat: int = 512, different_w: bool = True,
                          sft_half: bool = True,
                          input_is_latent: bool = True) -> torch.Tensor:
    """The official GFPGANv1Clean forward: ``(B, S, S, 3)`` in [-1, 1] ->
    the same."""
    feat = _lrelu(nn.conv2d_apply(params["conv_body_first"], x))
    skips = []
    for blk in params["conv_body_down"]:
        feat = _resblock_apply(blk, feat, "down")
        skips.insert(0, feat)
    feat = _lrelu(nn.conv2d_apply(params["final_conv"], feat))
    b = feat.shape[0]
    # torch flattens NCHW: (C, H, W) element order
    style_code = nn.dense_apply(params["final_linear"],
                                feat.permute(0, 3, 1, 2).reshape(b, -1))
    conditions = []
    for i in range(len(params["conv_body_down"])):
        feat = feat + skips[i]
        feat = _resblock_apply(params["conv_body_up"][i], feat, "up")
        for cond in (params["condition_scale"][i],
                     params["condition_shift"][i]):
            conditions.append(nn.conv2d_apply(
                cond["2"], _lrelu(nn.conv2d_apply(cond["0"], feat))))
    if different_w:
        latent = style_code.reshape(b, -1, num_style_feat)
    else:
        latent = style_code[:, None, :]
    if not input_is_latent:
        mlp = params["stylegan_decoder"]["style_mlp"]
        s = _norm_style(latent)
        for idx in sorted(mlp, key=int):
            s = _lrelu(nn.dense_apply(mlp[idx], s))
        latent = s
    num_latent = 2 * len(params["stylegan_decoder"]["to_rgbs"]) + 2
    if latent.shape[1] == 1:
        latent = latent.expand(b, num_latent, latent.shape[-1])
    return _decoder_apply(params["stylegan_decoder"], latent, conditions,
                          sft_half=sft_half)
