"""Parameter sharding (FSDP) for ditvr at the size presets no single
device should replicate: the 3b and 7b presets hold 3.06 and 7.1 billion
parameters (models/ditvr.py ``SIZE_PRESETS``).

Counterpart of video_enhancer_tpu/parallel/model_parallel.py:

- ``make_fsdp_shardings`` (:28-45): every weight of two or more dimensions
  and at least ``min_bytes`` is split along its largest dimension that the
  axis divides (ties to the lower index); everything else is whole on every
  rank. Here a leaf's split is that dimension, or None;
- ``init_sharded`` (:48-64): JAX creates each shard on its owner under
  ``jit`` with ``out_shardings``. Here every rank draws the parameters one
  layer at a time from the same generator (on the generator's device) and
  keeps its slice of each, so no rank holds more than its shards and one
  whole layer, and the shards at any world size concatenate to the
  one-rank init; given parameters are cut the same way;
- ``make_sharded_ditvr`` (:67-91): the forward of the sharded parameters.
  XLA's GSPMD inserts the gathers in JAX; here they are explicit: the
  parameters outside the blocks are gathered once, each block's just
  before the block (``ditvr.apply``'s ``block_fn``) and freed after it, so
  the peak is the shards, the small parameters and one block.
"""

from __future__ import annotations

import math

import torch

from ..models import ditvr

__all__ = ["make_fsdp_shardings", "init_sharded", "make_sharded_ditvr"]


def _tree_map(fn, *trees):
    """``fn`` on the leaves of dicts and lists of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(s[k] for s in trees)) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *s) for s in zip(*trees)]
    return fn(*trees)


def _split_dim(shape, itemsize: int, n: int, min_bytes: int) -> int | None:
    if len(shape) >= 2 and math.prod(shape) * itemsize >= min_bytes:
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % n == 0:
                return d
    return None


def make_fsdp_shardings(shapes, n: int, min_bytes: int = 1 << 20):
    """Map a tree of leaves with ``shape`` and ``dtype`` (tensors, numpy
    arrays, or any object with both) to each leaf's split over ``n`` ranks:
    the dimension it is cut along, or None where it stays whole."""
    return _tree_map(lambda a: _split_dim(tuple(a.shape), a.dtype.itemsize,
                                          n, min_bytes), shapes)


def _shard(t: torch.Tensor, d: int | None, axis) -> torch.Tensor:
    if d is None:
        return t
    return axis.shard(t, d).clone()


def init_sharded(init_fn, gen: torch.Generator, axis,
                 min_bytes: int = 1 << 20, dtype: torch.dtype | None = None,
                 params=None, **init_kw):
    """This rank's shards of ``init_fn(gen, place=..., **init_kw)``'s
    parameters over ``axis``, and the split of each leaf
    (``make_fsdp_shardings`` of the fp32 tree). ``init_fn`` hands each
    layer to ``place`` as soon as it is drawn (``ditvr.init`` does); the
    draws run on ``gen``'s device. With ``params`` (a whole tree, e.g. the
    JAX package's converted), those are cut instead and nothing is drawn.
    Each kept leaf goes to ``axis.device``, cast to ``dtype`` if given.
    Returns ``(shards, splits)``."""
    n = axis.size
    split_of = {}

    def keep(t):
        d = _split_dim(tuple(t.shape), t.dtype.itemsize, n, min_bytes)
        t = _shard(t, d, axis).to(device=axis.device, dtype=dtype or t.dtype)
        split_of[id(t)] = d
        return t

    if params is not None:
        return (_tree_map(keep, params),
                make_fsdp_shardings(params, n, min_bytes))
    with torch.device(gen.device):
        shards = init_fn(gen, place=lambda layer: _tree_map(keep, layer),
                         **init_kw)
    # each kept leaf is alive in ``shards``, so its id is its own
    return shards, _tree_map(lambda t: split_of[id(t)], shards)


def make_sharded_ditvr(mesh, preset: str = "3b", axis: str = "data",
                       heads: int | None = None, seed: int = 0,
                       min_bytes: int = 1 << 20,
                       dtype: torch.dtype | None = None, params=None):
    """ditvr at ``SIZE_PRESETS[preset]`` with FSDP-sharded parameters over
    ``mesh.axis(axis)``: drawn from a generator seeded with ``seed`` on the
    mesh's device, or ``params`` cut. Returns ``(shards, fn)``;
    ``fn(shards, clip)`` is ``ditvr.apply`` (``heads`` defaults to the
    preset's) on the gathered parameters, every rank with the same clip
    and the whole output."""
    cfg = ditvr.SIZE_PRESETS[preset]
    heads = heads or cfg["heads"]
    ax = mesh.axis(axis)
    gen = torch.Generator(device=ax.device).manual_seed(seed)
    shards, splits = init_sharded(ditvr.init, gen, ax, min_bytes=min_bytes,
                                  dtype=dtype, params=params,
                                  dim=cfg["dim"], depth=cfg["depth"])

    def gather(t, d):
        return t if d is None else ax.all_gather(t, dim=d, tiled=True)

    def fn(p, clip: torch.Tensor) -> torch.Tensor:
        whole = {k: _tree_map(gather, v, splits[k])
                 for k, v in p.items() if k != "blocks"}
        whole["blocks"] = p["blocks"]

        def block_fn(i, blk):
            return _tree_map(gather, blk, splits["blocks"][i])

        return ditvr.apply(whole, clip, heads=heads, block_fn=block_fn)

    return shards, fn
