"""Sharded clip inference over a mesh (parallel/mesh.py): the
halo-approximate factories and the exact time-sharded models.

Counterpart of video_enhancer_tpu/parallel/inference.py:

- ``make_mesh_sharded_clip_fn`` (:122-172): B over ``data``, T over
  ``time`` with frame halos, H over ``space`` with row halos, each halo
  exchanged only on an axis of more than one rank; the serving handler's
  mesh path (runtime/vsr_handler.py);
- ``make_sharded_clip_fn`` (:175-217): B over ``data``, T over ``time``,
  frame halos always (at one rank, replicated edge frames);
- ``_make_exact_sharded`` (:27-44), ``make_exact_sharded_vsrm`` (:47-58)
  and ``make_exact_sharded_fmv`` (:87-119): each rank runs the model on its
  T shard with ``time_axis`` set, so every temporal scan runs the
  distributed prefix-combine and every temporal coupling exchanges real
  context; the output equals the single-device output up to the order of
  sums. JAX's factories pass ``scan_impl="ref"``, which neither model
  forwards on its ``time_axis`` path, so the port passes nothing: the scans
  keep the dispatch rule (on the card, the short kernel with state).

The halo factories run the model on each shard extended by its
neighbours' frames or rows and trim the halo from the output, like the
reference's chunk overlap: exact for a model whose receptive field fits
the halo, an approximation for a recurrent one. Every rank passes the
whole clip and gets the whole output back, gathered in mesh order, with
JAX's checks and messages (raised before any exchange).
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import TimeAxis
from .spatial import halo_exchange_space
from .temporal import halo_exchange_time

__all__ = ["make_sharded_clip_fn", "make_mesh_sharded_clip_fn",
           "make_exact_sharded_vsrm", "make_exact_sharded_fmv"]


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


def make_mesh_sharded_clip_fn(apply_fn: Callable, mesh, halo_t: int = 2,
                              halo_s: int = 8, scale: int = 1):
    """``fn(params, clip)``: B over ``data``, T over ``time`` (frame halos),
    H over ``space`` (row halos), the halo of an axis exchanged only when
    it has more than one rank. ``apply_fn(params, clip)`` keeps T and
    scales H and W by ``scale``."""
    n_d, n_t, n_s = (mesh.shape[a] for a in ("data", "time", "space"))

    def wrapper(params, clip: torch.Tensor) -> torch.Tensor:
        b, t, h = clip.shape[0], clip.shape[1], clip.shape[2]
        if b % n_d or t % n_t or h % n_s:
            raise ValueError(
                f"clip (B={b}, T={t}, H={h}) not divisible by mesh "
                f"(data={n_d}, time={n_t}, space={n_s})")
        if n_t > 1 and t // n_t < halo_t:
            raise ValueError(f"T shard {t // n_t} < halo {halo_t}")
        if n_s > 1 and h // n_s < halo_s:
            raise ValueError(f"H shard {h // n_s} < halo {halo_s}")
        data, time, space = (mesh.axis(a) for a in ("data", "time", "space"))
        shard = space.shard(time.shard(data.shard(clip, 0), 1), 2)
        if n_t > 1:
            shard = halo_exchange_time(shard, halo_t, time)
        if n_s > 1:
            shard = halo_exchange_space(shard, halo_s, space)
        out = apply_fn(params, shard)
        if n_s > 1:
            tr = halo_s * scale
            out = out[:, :, tr:out.shape[2] - tr]
        if n_t > 1:
            out = out[:, halo_t:out.shape[1] - halo_t]
        out = space.all_gather(out, dim=2, tiled=True)
        out = time.all_gather(out, dim=1, tiled=True)
        return data.all_gather(out, dim=0, tiled=True)

    return wrapper


def make_sharded_clip_fn(apply_fn: Callable, mesh, halo: int = 2):
    """``fn(params, clip)``: B over ``data``, T over ``time``, every shard
    extended by ``halo`` frames of its neighbours (replicated edge frames at
    the clip's ends) and trimmed after ``apply_fn``, which must keep T. T
    must be divisible by the time axis and every shard hold >= ``halo``
    frames. Ranks along ``space`` compute the same output."""

    def wrapper(params, clip: torch.Tensor) -> torch.Tensor:
        n_t = mesh.shape["time"]
        if clip.shape[1] % n_t:
            raise ValueError(
                f"T={clip.shape[1]} not divisible by time axis {n_t}")
        if clip.shape[1] // n_t < halo:
            raise ValueError(
                f"local shard {clip.shape[1] // n_t} frames < halo {halo}")
        if clip.shape[0] % mesh.shape["data"]:
            raise ValueError(f"B={clip.shape[0]} not divisible by data axis "
                             f"{mesh.shape['data']}")
        data, time = mesh.axis("data"), mesh.axis("time")
        ext = halo_exchange_time(time.shard(data.shard(clip, 0), 1), halo,
                                 time)
        out = apply_fn(params, ext)
        out = time.all_gather(out[:, halo:out.shape[1] - halo], dim=1,
                              tiled=True)
        return data.all_gather(out, dim=0, tiled=True)

    return wrapper
