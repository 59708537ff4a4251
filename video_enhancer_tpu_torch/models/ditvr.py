"""DiTVR: zero-shot video restoration by a degradation-conditioned
diffusion transformer (one forward, 1x).

Counterpart of video_enhancer_tpu/models/ditvr.py without ``time_axis``:
3-D patch embedding (patch (2, 4, 4)) plus a sinusoidal position embedding
of the actual token grid, AdaLN DiT blocks conditioned on a degradation
type and three degradation scores, a gated low-rank meta-adapter after
each of the last ``adapt_layers`` blocks, a linear head, unpatchify, and a
residual to the (edge-padded) input, clipped to [0, 1]. Attention is the
shared dispatcher (ops/attention.py): the flash kernel on the card, the
plain form elsewhere or with ``kernels=False``. Layout ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.attention import attention

__all__ = ["init", "apply", "SIZE_PRESETS", "DEG_TYPES"]

SIZE_PRESETS = {
    "small": {"dim": 384, "depth": 8, "heads": 6},
    "base": {"dim": 768, "depth": 12, "heads": 12},
    "3b": {"dim": 2304, "depth": 32, "heads": 24},
    "7b": {"dim": 3072, "depth": 42, "heads": 24},
}

DEG_TYPES = ("unknown", "noise", "blur", "compression")


def _block_init(gen, dim):
    return {
        "norm1": nn.layer_norm_init(dim),
        "norm2": nn.layer_norm_init(dim),
        "adaln": nn.dense_init(gen, dim, 6 * dim, scale=0.02),
        "qkv": nn.dense_init(gen, dim, 3 * dim, bias=False),
        "proj": nn.dense_init(gen, dim, dim),
        "mlp": nn.mlp_init(gen, dim, 4 * dim),
    }


def init(gen: torch.Generator, dim: int = 384, depth: int = 8,
         patch: tuple[int, int, int] = (2, 4, 4), adapt_layers: int = 3,
         adapter_rank: int = 8) -> dict:
    """Random parameters (fp32, CPU) from ``gen``, in the port's layouts.
    The head count changes no shape: it is an argument of ``apply``."""
    pt, ph, pw = patch
    in_dim = pt * ph * pw * 3
    return {
        "patch_embed": nn.dense_init(gen, in_dim, dim),
        "deg_type_embed": torch.randn((len(DEG_TYPES), dim),
                                      generator=gen) * 0.02,
        "deg_mlp": nn.mlp_init(gen, 3, dim, dim),
        "blocks": [_block_init(gen, dim) for _ in range(depth)],
        "adapters": [
            {"down": nn.dense_init(gen, dim, adapter_rank),
             "up": nn.dense_init(gen, adapter_rank, dim, scale=0.0),
             "proto": torch.randn((4,), generator=gen)}
            for _ in range(adapt_layers)
        ],
        "head_norm": nn.layer_norm_init(dim),
        "head": nn.dense_init(gen, dim, in_dim, scale=0.0),
    }


def _patchify(clip, patch):
    b, t, h, w, c = clip.shape
    pt, ph, pw = patch
    gt, gh, gw = t // pt, h // ph, w // pw
    x = clip.reshape(b, gt, pt, gh, ph, gw, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, gt * gh * gw, pt * ph * pw * c), (gt, gh, gw)


def _unpatchify(tokens, grid, patch, c=3):
    b = tokens.shape[0]
    gt, gh, gw = grid
    pt, ph, pw = patch
    x = tokens.reshape(b, gt, gh, gw, pt, ph, pw, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, gt * pt, gh * ph, gw * pw, c)


def _pos_embed(grid, dim, dtype, device):
    gt, gh, gw = grid
    dt_, dh, dw = dim // 4, dim // 4, dim - dim // 4 - dim // 4

    def emb(n, d):
        return nn.sinusoidal_embedding(
            torch.arange(n, dtype=torch.float32, device=device), d)

    et, eh, ew = emb(gt, dt_), emb(gh, dh), emb(gw, dw)
    e = torch.cat([et[:, None, None, :].expand(gt, gh, gw, dt_),
                   eh[None, :, None, :].expand(gt, gh, gw, dh),
                   ew[None, None, :, :].expand(gt, gh, gw, dw)], dim=-1)
    return e.reshape(1, gt * gh * gw, dim).to(dtype)


def _patch_stats(tokens):
    """Per-patch (mean, std, min, max), the adapters' gate input; std with
    ddof 0, as ``jnp.std``."""
    return torch.stack([tokens.mean(-1), tokens.std(-1, correction=0),
                        tokens.amin(-1), tokens.amax(-1)], dim=-1)


def _adapter(p, x, stats):
    """Gated low-rank adaptation: gate = sigmoid(4 cos(stats, proto))."""
    proto = p["proto"].float()
    s = stats.float()
    sim = (s * proto).sum(-1) / (torch.linalg.vector_norm(s, dim=-1)
                                 * torch.linalg.vector_norm(proto) + 1e-6)
    gate = torch.sigmoid(4.0 * sim)[..., None].to(x.dtype)
    up = nn.dense_apply(p["up"], F.gelu(nn.dense_apply(p["down"], x),
                                        approximate="tanh"))
    return x + gate * up


def _dit_block(blk, x, cond, heads, kernels):
    b, L, c = x.shape
    mod = nn.dense_apply(blk["adaln"], cond)[:, None, :]     # (B, 1, 6*dim)
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)

    h = nn.layer_norm_apply(blk["norm1"], x) * (1 + sc1) + sh1
    q, k, v = nn.dense_apply(blk["qkv"], h).chunk(3, dim=-1)

    def mh(z):      # (B, L, c) column slice -> (B, heads, L, dh) view
        return z.reshape(b, L, heads, c // heads).transpose(1, 2)

    a = attention(mh(q), mh(k), mh(v), use_kernel=None if kernels else False)
    a = a.transpose(1, 2).reshape(b, L, c)
    x = x + g1 * nn.dense_apply(blk["proj"], a)

    h = nn.layer_norm_apply(blk["norm2"], x) * (1 + sc2) + sh2
    return x + g2 * nn.mlp_apply(blk["mlp"], h)


def _edge_pad(x, dim, pad):
    if not pad:
        return x
    idx = torch.arange(x.shape[dim] + pad, device=x.device)
    return x.index_select(dim, idx.clamp(max=x.shape[dim] - 1))


def apply(params: dict, clip: torch.Tensor,
          degradation_type: str | int | torch.Tensor = "unknown",
          degradation_scores=(0.0, 0.0, 0.0), heads: int | None = None,
          patch: tuple[int, int, int] = (2, 4, 4), auto_adapt: bool = True,
          kernels: bool = True) -> torch.Tensor:
    """``(B, T, H, W, 3)`` -> restored ``(B, T, H, W, 3)``; T, H and W are
    edge-padded to the patch and cropped back.

    ``kernels=True`` keeps the JAX package's dispatch (the flash kernel on
    the card for 256 tokens or more); ``False`` runs the plain attention,
    the reference the kernel is held against."""
    b, t, h, w, c = clip.shape
    pt, ph, pw = patch
    dim = params["blocks"][0]["qkv"]["w"].shape[1]
    heads = heads or max(dim // 64, 1)

    x = clip
    for axis, (n, p) in enumerate(((t, pt), (h, ph), (w, pw)), start=1):
        x = _edge_pad(x, axis, (-n) % p)

    tokens, grid = _patchify(x, patch)
    tok = nn.dense_apply(params["patch_embed"], tokens)
    tok = tok + _pos_embed(grid, tok.shape[-1], tok.dtype, tok.device)

    if isinstance(degradation_type, str):
        degradation_type = (DEG_TYPES.index(degradation_type)
                            if degradation_type in DEG_TYPES else 0)
    cond = params["deg_type_embed"][degradation_type][None].to(tok.dtype)
    scores = torch.as_tensor(degradation_scores, device=tok.device)
    cond = cond + nn.mlp_apply(params["deg_mlp"], scores.to(tok.dtype)[None])
    cond = cond.expand(b, cond.shape[-1])

    stats = _patch_stats(tokens)
    n_adapt = len(params["adapters"])
    depth = len(params["blocks"])
    for i, blk in enumerate(params["blocks"]):
        tok = _dit_block(blk, tok, cond, heads, kernels)
        ai = i - (depth - n_adapt)
        if auto_adapt and ai >= 0:
            tok = _adapter(params["adapters"][ai], tok, stats)

    tok = nn.layer_norm_apply(params["head_norm"], tok)
    res = nn.dense_apply(params["head"], tok)
    out = x + _unpatchify(res, grid, patch, c)
    return torch.clamp(out[:, :t, :h, :w, :], 0.0, 1.0)
