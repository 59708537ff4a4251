"""Plain reference of ditvr as it is served for restoration: a 3-D patch
embedding with a sinusoidal position embedding of the token grid, AdaLN
transformer blocks conditioned on a degradation type and three scores,
gated low-rank adapters after the last blocks, a linear head unpatchified
onto the (edge-padded) input, and the calibrated blend toward the input,
on clips ``(B, T, H, W, 3)`` in [0, 1]. ``context`` holds
``degradation_scores`` (three floats) and ``degradation_type`` (an index
into unknown, noise, blur, compression)."""

from __future__ import annotations

import torch

import plain

STRENGTH = 0.5         # the served calibrated strength of ditvr
HEADS = 3              # the served head count (head width 128)
PATCH = (2, 4, 4)


def load(config: dict, device) -> dict:
    params = plain.load_checkpoint(config["checkpoint"], device)
    plain.check_sizes(config, sizes(params))
    return params


def sizes(params: dict) -> dict:
    """The model's sizes as the checkpoint (and this reference) has them."""
    dim, patch_in = params["patch_embed"]["w"].shape
    pt, ph, pw = PATCH
    return {"dim": dim, "depth": len(params["blocks"]), "heads": HEADS,
            "head_dim": dim // HEADS,
            "patch": list(PATCH) if patch_in == pt * ph * pw * 3 else None,
            "mlp_hidden": params["blocks"][0]["mlp"]["fc1"]["w"].shape[0],
            "adapt_layers": len(params["adapters"]),
            "adapter_rank": params["adapters"][0]["down"]["w"].shape[0]}


def _dense(p, x, ops):
    return ops.linear(x, p["w"], p.get("b"))


def _mlp(p, x, ops):
    return _dense(p["fc2"], plain.gelu(_dense(p["fc1"], x, ops)), ops)


def _edge_pad(x, dim, pad):
    if not pad:
        return x
    idx = torch.arange(x.shape[dim] + pad, device=x.device)
    return x.index_select(dim, idx.clamp(max=x.shape[dim] - 1))


def _pos_embed(grid, dim, device):
    gt, gh, gw = grid
    dt, dh = dim // 4, dim // 4
    dw = dim - dt - dh

    def emb(n, d):
        return plain.sinusoidal_embedding(
            torch.arange(n, dtype=torch.float32, device=device), d)

    et, eh, ew = emb(gt, dt), emb(gh, dh), emb(gw, dw)
    e = torch.cat([et[:, None, None, :].expand(gt, gh, gw, dt),
                   eh[None, :, None, :].expand(gt, gh, gw, dh),
                   ew[None, None, :, :].expand(gt, gh, gw, dw)], dim=-1)
    return e.reshape(1, gt * gh * gw, dim)


def _block(blk, x, cond, ops):
    b, L, c = x.shape
    sh1, sc1, g1, sh2, sc2, g2 = _dense(blk["adaln"], cond,
                                        ops)[:, None, :].chunk(6, dim=-1)
    h = plain.layer_norm(blk["norm1"], x) * (1 + sc1) + sh1
    q, k, v = _dense(blk["qkv"], h, ops).chunk(3, dim=-1)

    def heads(z):
        return z.reshape(b, L, HEADS, c // HEADS).transpose(1, 2)

    a = ops.attention(heads(q), heads(k), heads(v))
    x = x + g1 * _dense(blk["proj"], a.transpose(1, 2).reshape(b, L, c), ops)
    h = plain.layer_norm(blk["norm2"], x) * (1 + sc2) + sh2
    return x + g2 * _mlp(blk["mlp"], h, ops)


def _adapter(p, x, stats, ops):
    sim = (stats * p["proto"]).sum(-1) / (
        torch.linalg.vector_norm(stats, dim=-1)
        * torch.linalg.vector_norm(p["proto"]) + 1e-6)
    gate = torch.sigmoid(4.0 * sim)[..., None]
    return x + gate * _dense(p["up"], plain.gelu(_dense(p["down"], x, ops)),
                             ops)


def forward(params, clip, ops, context):
    b, t, h, w, c = clip.shape
    pt, ph, pw = PATCH
    clip = ops.q(clip)
    x = clip
    for axis, (n, p) in enumerate(((t, pt), (h, ph), (w, pw)), start=1):
        x = _edge_pad(x, axis, (-n) % p)
    T, H, W = x.shape[1:4]
    gt, gh, gw = T // pt, H // ph, W // pw
    tokens = x.reshape(b, gt, pt, gh, ph, gw, pw, c).permute(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(b, gt * gh * gw, pt * ph * pw * c)
    tok = _dense(params["patch_embed"], tokens, ops)
    tok = tok + _pos_embed((gt, gh, gw), tok.shape[-1], tok.device)
    scores = torch.as_tensor(context["degradation_scores"],
                             dtype=torch.float32, device=clip.device)
    kind = int(context["degradation_type"])
    cond = (params["deg_type_embed"][kind][None]
            + _mlp(params["deg_mlp"], scores[None], ops)).expand(b, -1)
    stats = torch.stack([tokens.mean(-1), tokens.std(-1, correction=0),
                         tokens.amin(-1), tokens.amax(-1)], dim=-1)
    depth, adapters = len(params["blocks"]), params["adapters"]
    for i, blk in enumerate(params["blocks"]):
        tok = _block(blk, tok, cond, ops)
        ai = i - (depth - len(adapters))
        if ai >= 0:
            tok = _adapter(adapters[ai], tok, stats, ops)
    res = _dense(params["head"], plain.layer_norm(params["head_norm"], tok),
                 ops)
    res = res.reshape(b, gt, gh, gw, pt, ph, pw, c).permute(
        0, 1, 4, 2, 5, 3, 6, 7).reshape(b, T, H, W, c)
    out = ops.q(torch.clamp((x + res)[:, :t, :h, :w], 0.0, 1.0))
    return ops.q(torch.clamp(STRENGTH * out + (1.0 - STRENGTH) * clip, 0.0,
                             1.0))
