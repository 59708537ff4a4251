"""The operations of one model call, counted once in set-up from shapes.

The reference's forward runs on the ``meta`` device at the shape of one
model call of the handler (a window, or a group of its tiles) under
``FlopCounterMode``, which counts the products the program runs as
library calls; the calls that the program serves on its hand-written
kernels are recorded there with their shapes instead, and counted by the
benchmark's frozen formulas (``counts/<kernel>.py``). So moving work into
or out of a kernel does not change the count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode

TILE_GROUP = 4          # tiles a model call of the handler takes


@dataclass
class CallCount:
    shape: tuple              # (B, T, h, w, 3) of one model call
    calls_per_window: int
    flops: float              # of one model call
    kernel_calls: list        # [(kernel, shape)] of one model call


def call_shape(config: dict, height: int, width: int) -> tuple[tuple, int]:
    """The input shape of one model call and the calls a window makes."""
    import plain

    t, tile = config["window"], config["tile"]
    if max(height, width) <= tile:
        return (1, t, height, width, 3), 1
    n = len(plain.tile_origins(height, width, tile, config["tile_overlap"]))
    b = TILE_GROUP if n > TILE_GROUP else n
    return ((b, t, min(tile, height), min(tile, width), 3),
            -(-n // TILE_GROUP))


def count(ref, params, config: dict, height: int, width: int, context,
          kernels: dict) -> CallCount:
    import plain

    shape, calls = call_shape(config, height, width)
    ops = plain.Ops("count")
    meta = plain.to_device(params, "meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(meta, torch.empty(shape, device="meta"), ops, context)
    flops = float(fc.get_total_flops())
    flops += sum(kernels[k].flops(s) for k, s in ops.calls)
    return CallCount(shape, calls, flops, list(ops.calls))
