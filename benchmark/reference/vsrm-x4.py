"""Plain reference of vsrm x4 as it is served: the model (a conv embed;
blocks of a bidirectional SSD over each frame's raster, per-site temporal
attention and a bidirectional shared-stream SSM over the frames, an MLP;
the local deformable alignment; the reconstruction and a pixel-shuffle
head added to the cubic upscale) and the calibrated blend toward the cubic
upscale, on clips ``(B, T, H, W, 3)`` in [0, 1]."""

from __future__ import annotations

import torch
import torch.nn.functional as F

import plain

STRENGTH = 0.25        # the served calibrated strength of vsrm
HEADS = 4              # the temporal attention's heads
SSD_CHUNK = 256


def load(config: dict, device) -> dict:
    params = plain.load_checkpoint(config["checkpoint"], device)
    plain.check_sizes(config, sizes(params))
    return params


def sizes(params: dict) -> dict:
    """The model's sizes as the checkpoint (and this reference) has them."""
    blk = params["blocks"][0]
    ssd, tssm = blk["spatial_ssm"], blk["temporal_ssm"]
    heads, inner = ssd["A_log_f"].shape[0], ssd["D"].shape[0]
    return {"dim": params["embed"]["w"].shape[0],
            "num_blocks": len(params["blocks"]), "ssd_heads": heads,
            "ssd_head_dim": inner // heads,
            "ssd_state": (ssd["conv_w"].shape[0] - inner) // 2,
            "temporal_heads": HEADS,
            "temporal_state": tssm["A_log_f"].shape[1],
            "mlp_hidden": blk["mlp"]["fc1"]["w"].shape[0]}


def _conv(p, x, ops):
    return ops.conv_frames(x, p["w"][:, :, 0], p["b"])


def _bissd(p, x, ops):
    heads = p["A_log_f"].shape[0]
    inner = p["D"].shape[0]
    n = (p["conv_w"].shape[0] - inner) // 2
    zx = ops.linear(x, p["in_proj"]["w"])
    z, xbc, dt_raw = (zx[..., :inner], zx[..., inner:2 * inner + 2 * n],
                      zx[..., -heads:])
    xbc = F.silu(plain.depthwise_conv1d(xbc, p["conv_w"], p["conv_b"]))
    u, Bm, Cm = (xbc[..., :inner], xbc[..., inner:inner + n],
                 xbc[..., inner + n:])
    b, L, _ = x.shape
    uh = u.reshape(b, L, heads, inner // heads)
    y = (ops.ssd_shared(uh, F.softplus(dt_raw + p["dt_bias_f"]),
                        -torch.exp(p["A_log_f"]), Bm, Cm, SSD_CHUNK, False)
         + ops.ssd_shared(uh, F.softplus(dt_raw + p["dt_bias_b"]),
                          -torch.exp(p["A_log_b"]), Bm, Cm, SSD_CHUNK, True))
    y = (y.reshape(b, L, inner) + u * p["D"]) * F.silu(z)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return ops.linear(y * p["norm_scale"], p["out_proj"]["w"])


def _site_attention(q, k, v, ops):
    n, t, c = q.shape
    dh = c // HEADS
    qh, kh, vh = (ops.q(a).reshape(n, t, HEADS, dh).transpose(1, 2)
                  for a in (q, k, v))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) / dh ** 0.5, dim=-1)
    return ops.q((ops.q(probs) @ vh).transpose(1, 2).reshape(n, t, c))


def _temporal_mix(blk, x, ops):
    b, t, h, w, c = x.shape
    seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
    q, k, v = ops.linear(seq, blk["qkv"]["w"]).chunk(3, dim=-1)
    seq = seq + ops.linear(_site_attention(q, k, v, ops),
                           blk["attn_out"]["w"], blk["attn_out"]["b"])
    p = blk["temporal_ssm"]
    n = p["A_log_f"].shape[1]
    u, gate = ops.linear(seq, p["in_proj"]["w"]).chunk(2, dim=-1)
    y = ops.fused_bissm(u, gate, p, p["x_proj"]["w"].shape[0] - 2 * n)
    seq = seq + ops.linear(y, p["out_proj"]["w"])
    return seq.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


def forward(params, clip, ops, context=None):
    """``(B, T, H, W, 3)`` -> ``(B, T, 4H, 4W, 3)``, the calibrated output."""
    b, t, h, w, _ = clip.shape
    s = params["head"]["w"].shape[0] // 3
    s = int(round(s ** 0.5))
    frames = ops.q(clip.reshape(b * t, h, w, 3))
    feats = _conv(params["embed"], frames, ops)
    c = feats.shape[-1]
    for blk in params["blocks"]:
        x = plain.layer_norm(blk["spatial_norm"], feats)
        feats = feats + _bissd(blk["spatial_ssm"], x.reshape(b * t, h * w, c),
                               ops).reshape(b * t, h, w, c)
        x = plain.layer_norm(blk["temporal_norm"], feats)
        feats = feats + _temporal_mix(blk, x.reshape(b, t, h, w, c),
                                      ops).reshape(b * t, h, w, c)
        x = plain.layer_norm(blk["mlp_norm"], feats)
        m = blk["mlp"]
        feats = feats + ops.linear(
            plain.gelu(ops.linear(x, m["fc1"]["w"], m["fc1"]["b"])),
            m["fc2"]["w"], m["fc2"]["b"])
    offsets = torch.tanh(_conv(params["offset"], feats, ops))
    warped = plain.flow_warp_local(feats, offsets)
    feats = feats + _conv(params["align_fuse"],
                          torch.cat([feats, warped], dim=-1), ops)
    feats = F.silu(_conv(params["recon"], feats, ops))
    res = plain.pixel_shuffle(_conv(params["head"], feats, ops), s)
    base = ops.q(plain.resize_cubic(frames, (h * s, w * s)))
    out = ops.q(torch.clamp(base + res, 0.0, 1.0))
    out = ops.q(torch.clamp(STRENGTH * out
                            + (1.0 - STRENGTH) * torch.clamp(base, 0.0, 1.0),
                            0.0, 1.0))
    return out.reshape(b, t, h * s, w * s, 3)
