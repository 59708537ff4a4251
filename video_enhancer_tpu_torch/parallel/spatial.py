"""Spatial sharding: frame height split over the ranks of a mesh's
``space`` axis, with row halos.

Counterpart of video_enhancer_tpu/parallel/spatial.py: each space shard
holds a horizontal band of every frame, takes ``halo`` boundary rows from
its neighbours, runs the model on the extended band and trims ``scale *
halo`` output rows. The distributed form of overlapping tiles, exact where
the model's receptive field fits the halo.
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import Axis, halo_exchange

__all__ = ["halo_exchange_space", "make_spatially_sharded_clip_fn"]


def halo_exchange_space(x: torch.Tensor, halo: int,
                        axis: Axis) -> torch.Tensor:
    """Pad an H-sharded clip with ``halo`` rows from each neighbour on the
    space ``axis`` (:20-42): this rank's shard ``(B, T, H_loc, W, C)`` ->
    ``(B, T, H_loc + 2 halo, W, C)``; the shards at the top and bottom
    edges of the frame replicate their boundary row."""
    return halo_exchange(x, halo, axis, dim=2, edge="replicate")


def make_spatially_sharded_clip_fn(apply_fn: Callable, mesh, halo: int = 8,
                                   scale: int = 1):
    """``fn(params, clip)`` over a clip ``(B, T, H, W, C)`` with H split over
    the mesh's ``space`` axis and B over its ``data`` axis (:45-78).
    ``apply_fn(params, clip)`` maps H to ``scale * H``. Every rank passes
    the whole clip and gets the whole output back."""

    def wrapper(params, clip: torch.Tensor) -> torch.Tensor:
        n_s = mesh.shape["space"]
        if clip.shape[0] % mesh.shape["data"]:
            raise ValueError(f"B={clip.shape[0]} not divisible by data axis "
                             f"{mesh.shape['data']}")
        if clip.shape[2] % n_s:
            raise ValueError(
                f"H={clip.shape[2]} not divisible by space axis {n_s}")
        if clip.shape[2] // n_s < halo:
            raise ValueError(
                f"local band {clip.shape[2] // n_s} rows < halo {halo}")
        data, space = mesh.axis("data"), mesh.axis("space")
        ext = halo_exchange_space(space.shard(data.shard(clip, 0), 2),
                                  halo, space)
        out = apply_fn(params, ext)
        trim = halo * scale
        out = out[:, :, trim:out.shape[2] - trim]
        out = space.all_gather(out, dim=2, tiled=True)
        return data.all_gather(out, dim=0, tiled=True)

    return wrapper
