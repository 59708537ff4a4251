"""The system under test: the port's streaming handler, built for a
configuration through the port's own registry.

This is the only module of the benchmark that imports the program. It
builds ``build_handler(model)`` with the configuration's policy entry
(window, stride, tile, overlap, scale, the model's ``extra``) and the
bundled checkpoint, checks that the handler took them, and wraps the
handler's ``apply_fn`` so that the benchmark counts the model calls and,
when traced, marks each with a ``bench.apply_fn`` range.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch

_ENTRY_KEYS = ("scale", "window", "stride", "tile", "tile_overlap", "extra")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class Program:
    """``handler``: the port's ``VSRHandler``; ``calls``: model calls made
    so far; ``traced``: mark each call with a profiler range."""

    def __init__(self, config: dict, device: str):
        from video_enhancer_tpu_torch.config import default_policy
        from video_enhancer_tpu_torch.runtime.registry import build_handler

        model = config["model"]
        policy = default_policy()
        entry = dataclasses.replace(
            policy.models[model], weights_path=None,
            **{k: config[k] for k in _ENTRY_KEYS})
        policy = dataclasses.replace(policy,
                                     models={**policy.models, model: entry})
        h = build_handler(model, policy=policy, device=device)
        got = (h.scale, h.chunk, h.chunk - h.overlap, h.tile, h.tile_overlap,
               h.dtype)
        want = (config["scale"], config["window"], config["stride"],
                config["tile"], config["tile_overlap"],
                _DTYPES[config["dtype"]])
        if got != want:
            raise RuntimeError(f"the handler departs from the configuration:"
                               f" (scale, window, stride, tile, overlap, "
                               f"dtype) {got} != {want}")
        self.handler = h
        self.calls = 0
        self.traced = False
        inner = h.apply_fn

        def apply_fn(*a, **kw):
            self.calls += 1
            rng = (torch.profiler.record_function("bench.apply_fn")
                   if self.traced else nullcontext())
            with rng:
                return inner(*a, **kw)

        h.apply_fn = apply_fn

    def set_context(self, context: dict | None) -> None:
        if context:
            self.handler.update_context(**context)

    def stream(self, frames):
        """The handler's streaming loop over ``frames``."""
        return self.handler.enhance_frames(frames)

    def close(self) -> None:
        """Drop the handler, its parameters and the registry's cache."""
        from video_enhancer_tpu_torch.runtime.registry import clear_cache

        self.handler = None
        clear_cache()
