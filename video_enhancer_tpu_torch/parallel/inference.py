"""Exact T-sharded inference of fast_mamba_vsr and vsrm over a time axis
(parallel/mesh.py).

Counterpart of video_enhancer_tpu/parallel/inference.py
``_make_exact_sharded`` (:27-44), ``make_exact_sharded_vsrm`` (:47-58) and
``make_exact_sharded_fmv`` (:87-119). Each rank runs the model on its T
shard with ``time_axis`` set, so every temporal scan runs the distributed
prefix-combine and every temporal coupling exchanges real context; the
output equals the single-device output up to the order of sums. JAX's
factories pass ``scan_impl="ref"``, which neither model forwards on its
``time_axis`` path, so the port passes nothing: the scans keep the
dispatch rule (on the card, the short kernel with state).
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import TimeAxis

__all__ = ["make_exact_sharded_vsrm", "make_exact_sharded_fmv"]


def _make_exact_sharded(local_apply: Callable, axis: TimeAxis):
    """``fn(params, clip)``: every rank passes the whole clip ``(B, T, H, W,
    C)`` (T divisible by the axis size), runs ``local_apply`` on its T
    shard and returns the whole output, gathered along T in rank order."""

    def wrapper(params, clip: torch.Tensor) -> torch.Tensor:
        n_t, idx = axis.size, axis.index
        if clip.shape[1] % n_t:
            raise ValueError(
                f"T={clip.shape[1]} not divisible by time axis {n_t}")
        t = clip.shape[1] // n_t
        out = local_apply(params, clip[:, idx * t:(idx + 1) * t])
        return axis.all_gather(out, dim=1, tiled=True)

    return wrapper


def make_exact_sharded_vsrm(axis: TimeAxis, scale: int = 4, heads: int = 4):
    """Exact T-sharded vsrm: gathered-K/V temporal attention and the
    distributed temporal scans (its convs have a T-kernel of 1)."""
    from ..models import vsrm

    def local(params, shard):
        return vsrm.apply(params, shard, scale=scale, heads=heads,
                          time_axis=axis)

    return _make_exact_sharded(local, axis)


def make_exact_sharded_fmv(axis: TimeAxis, scale: int = 4):
    """Exact T-sharded fast_mamba_vsr: the distributed temporal scans and
    the final temporal conv's frame halos."""
    from ..models import fast_mamba_vsr as fmv

    def local(params, shard):
        return fmv.apply(params, shard, scale=scale, time_axis=axis)

    return _make_exact_sharded(local, axis)
