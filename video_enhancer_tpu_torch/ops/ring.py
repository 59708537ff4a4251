"""Sequence-parallel attention over a token axis split across the ranks of
an axis (parallel/mesh.py).

Counterpart of video_enhancer_tpu/ops/ring.py:

- ``ring_attention`` (:25-64): queries stay on their rank while each
  rank's K/V block travels around the ring (``ppermute``), every visiting
  block folded into an online-softmax accumulator (running max, normaliser
  and output). The products are fp32 einsums of q cast to fp32 and scaled
  before the first one, as in JAX; it is an XLA-level product there, not a
  Pallas kernel. The rotation after the last fold is skipped (it changes
  no result). Peak memory is one ``(B, H, L_loc, L_loc)`` fp32 logits block
  and its exponent, computed in place.
- ``RING_MIN_TOKENS`` (:67) and ``sharded_attention`` (:70-93): the ring
  for ``L_loc * n >= min_ring_tokens`` global tokens, otherwise K and V are
  gathered and the shared dispatcher runs (the flash kernel on the card,
  ops/attention.py).

Exact against single-device attention up to the order of sums.
"""

from __future__ import annotations

import torch

from .attention import attention

__all__ = ["ring_attention", "sharded_attention", "RING_MIN_TOKENS"]

# Below this many global tokens one gather of K/V is cheaper than n - 1
# ring hops (and the gathered tensor is small anyway).
RING_MIN_TOKENS = 4096


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                   scale: float | None = None) -> torch.Tensor:
    """q, k, v: this rank's ``(B, H, L_loc, D)`` shards of a token axis
    split over ``axis``. Returns this rank's ``(B, H, L_loc, D)`` shard of
    ``softmax(q K^T scale) V`` over the global K and V, in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    m = torch.full(qf.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for i in range(axis.size):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = s.sub_(m_new).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
        m = m_new
        del s, p
        if i < axis.size - 1:
            k, v = axis.ppermute(k, 1), axis.ppermute(v, 1)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, axis,
                      min_ring_tokens: int = RING_MIN_TOKENS,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """Attention over ``(B, L_loc, C)`` shards with ``heads`` heads: the
    ring for long global sequences, gathered K/V through ``attention``
    (``use_kernel`` passed on) for short ones. Returns ``(B, L_loc, C)``."""
    b, l_loc, c = q.shape
    dh = c // heads

    def mh(z):
        return z.reshape(b, -1, heads, dh).transpose(1, 2)

    def unmh(z):
        return z.transpose(1, 2).reshape(b, -1, c)

    if l_loc * axis.size >= min_ring_tokens:
        return unmh(ring_attention(mh(q), mh(k), mh(v), axis))
    kg = axis.all_gather(k, dim=1, tiled=True)
    vg = axis.all_gather(v, dim=1, tiled=True)
    return unmh(attention(mh(q), mh(kg), mh(vg), use_kernel=use_kernel))
