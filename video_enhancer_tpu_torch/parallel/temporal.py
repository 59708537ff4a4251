"""Temporal context parallelism: the clip's T axis split over the ranks of
a time axis (parallel/mesh.py).

Counterpart of video_enhancer_tpu/parallel/temporal.py:

- ``halo_exchange_time`` (:36-66): pad each shard with ``halo`` boundary
  steps of its neighbours, so that temporal convolutions see real context
  (parallel/mesh.py ``halo_exchange`` along T);
- ``temporal_parallel_scan`` (:69-119): the exact distributed selective
  scan. Each shard scans from zero state, the shards gather their (decay,
  end state) summaries, an exclusive prefix-combine gives each shard its
  incoming state, and a second local scan applies it;
- ``make_temporal_scan`` (:185): that scan over a whole sequence held by
  every rank.
"""

from __future__ import annotations

import torch

from ..ops.scan import selective_scan
from .mesh import TimeAxis, halo_exchange

__all__ = ["halo_exchange_time", "temporal_parallel_scan",
           "make_temporal_scan"]


def halo_exchange_time(x: torch.Tensor, halo: int, axis: TimeAxis,
                       edge: str = "replicate") -> torch.Tensor:
    """``(B, T_loc, ...)`` -> ``(B, T_loc + 2 halo, ...)``: the left
    neighbour's last ``halo`` steps, x, the right neighbour's first. At the
    global ends ``edge="replicate"`` repeats the boundary step and
    ``"zero"`` inserts zeros (what an unsharded zero-padded conv sees)."""
    return halo_exchange(x, halo, axis, dim=1, edge=edge)


def temporal_parallel_scan(x, dt, A, Bmat, C, D, axis: TimeAxis,
                           impl: str | None = None, reverse: bool = False):
    """Exact selective scan over a T-sharded sequence. The arguments are
    this rank's shards: x, dt ``(B, L_loc, D)``; Bmat, C ``(B, L_loc, N)``;
    A ``(D, N)`` and D ``(D,)`` whole. ``reverse`` scans the global
    sequence back to front (local flips, and the prefix runs from the last
    shard to the first). Summaries and states are fp32. Returns the local y
    shard in natural order."""
    n, idx = axis.size, axis.index
    if reverse:
        x, dt, Bmat, C = (torch.flip(a, dims=(1,)) for a in (x, dt, Bmat, C))

    Bsz, _, Dd = x.shape
    N = A.shape[1]
    h0 = torch.zeros((Bsz, Dd, N), device=x.device)
    _, h_local = selective_scan(x, dt, A, Bmat, C, D, h0=h0, impl=impl)

    # shard summary: total decay exp(A * sum_t dt), (B, D, N)
    sum_dt = dt.float().sum(dim=1)
    a_tot = torch.exp(sum_dt[..., None] * A.float())
    a_all = axis.all_gather(a_tot)                           # (n, B, D, N)
    h_all = axis.all_gather(h_local)
    if reverse:
        a_all, h_all = torch.flip(a_all, dims=(0,)), torch.flip(h_all, dims=(0,))

    # exclusive prefix in scan order: the state entering shard k
    my_pos = (n - 1 - idx) if reverse else idx
    h_in = torch.zeros_like(h_local)
    for k in range(my_pos):
        h_in = a_all[k] * h_in + h_all[k]

    y, _ = selective_scan(x, dt, A, Bmat, C, D, h0=h_in, impl=impl)
    return torch.flip(y, dims=(1,)) if reverse else y


def make_temporal_scan(axis: TimeAxis, impl: str | None = None):
    """``fn(x, dt, A, Bmat, C, D) -> y`` over whole sequences held by every
    rank: each rank scans its T shard with ``temporal_parallel_scan`` and
    the shards are gathered back, so every rank returns the whole y (as
    JAX's sharded global array)."""

    def fn(x, dt, A, Bmat, C, D):
        n, idx = axis.size, axis.index
        L = x.shape[1]
        if L % n:
            raise ValueError(f"L={L} not divisible by time axis {n}")
        s = slice(idx * (L // n), (idx + 1) * (L // n))
        y = temporal_parallel_scan(x[:, s], dt[:, s], A, Bmat[:, s], C[:, s],
                                   D, axis, impl=impl)
        return axis.all_gather(y, dim=1, tiled=True)

    return fn
