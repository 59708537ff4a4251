"""SeedVR2 at its published sizes: ditvr restorers at the size presets.

Counterpart of video_enhancer_tpu/models/seedvr2_sizes.py (the reference's
SeedVR2_3B / SeedVR2_7B factories): ``make_seedvr2(size)`` returns
``(params, meta, apply)`` for ``ditvr.SIZE_PRESETS[size]``. The 3b and 7b
trees are 12 and 28 GB in fp32; draw them under ``torch.device("meta")``
for their shapes, or shard them (parallel/model_parallel.py).
"""

from __future__ import annotations

import torch

from . import ditvr

__all__ = ["make_seedvr2", "make_seedvr2_3b", "make_seedvr2_7b"]


def make_seedvr2(size: str = "small", gen: torch.Generator | None = None):
    """``(params, meta, apply)``: ditvr's init at the preset from ``gen``
    (default: seed 0), the JAX package's meta with ``preset``, and
    ``apply(params, clip, **kw)`` with the preset's heads."""
    cfg = ditvr.SIZE_PRESETS[size]
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    params = ditvr.init(gen, dim=cfg["dim"], depth=cfg["depth"])
    meta = {"dim": cfg["dim"], "depth": cfg["depth"], "heads": cfg["heads"],
            "patch": (2, 4, 4), "adapt_layers": 3, "preset": size}

    def apply(p, clip, **kw):
        return ditvr.apply(p, clip, heads=cfg["heads"], **kw)

    return params, meta, apply


def make_seedvr2_3b(gen: torch.Generator | None = None):
    return make_seedvr2("3b", gen)


def make_seedvr2_7b(gen: torch.Generator | None = None):
    return make_seedvr2("7b", gen)
