"""Per-site short-sequence multi-head attention.

Counterpart of video_enhancer_tpu/ops/attention.py ``site_attention``
(the broadcast form; the JAX package has no kernel for it): ``q (N, T, C)``,
``k/v (N, Tg, C)`` -> ``(N, T, C)``, heads of ``C // heads`` channels.
"""

from __future__ import annotations

import math

import torch

__all__ = ["site_attention"]


def site_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    n, t, c = q.shape
    tg = k.shape[1]
    dh = c // heads
    prod = (q[:, :, None, :] * k[:, None, :, :]).reshape(n, t, tg, heads, dh)
    scores = prod.sum(-1).float()                            # (N,T,Tg,h)
    probs = torch.softmax(scores / math.sqrt(dh), dim=2).to(v.dtype)
    pc = probs.repeat_interleave(dh, dim=-1)                 # (N,T,Tg,C)
    return (pc * v[:, None, :, :]).sum(dim=2)
