"""Warm start: build every available handler and run a seeded clip through
it, so that a deployment's first request finds everything ready.

Counterpart of video_enhancer_tpu/warm_start.py. Where the JAX package
fills its persistent compile cache, the port builds its kernel library
first (``kernels.library()``, into ``kernels.BUILD_DIR``, named by a hash
of the sources), so that a later start finds the ``.so`` and loads it
without a build; then each handler's first forward runs the kernels on
the card. Handlers are cached by the registry, so a server in the same
process serves the warmed ones.

Run: ``python -m video_enhancer_tpu_torch.warm_start [--models ...]
[--size 64] [--device cpu]`` (the card unless ``--device cpu``,
``--platform cpu`` or ``$VETPU_PLATFORM=cpu``; without a card it fails).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import kernels
from .device import platform_device, resolve_device
from .runtime.registry import build_handler, probe_available

__all__ = ["warm_start", "warm_kernels", "main"]


def warm_kernels() -> dict:
    """Build (or find) and load the kernel library: its path, whether it
    was already built before this call, and the seconds taken."""
    prebuilt = kernels.library_path().exists()
    t0 = time.perf_counter()
    kernels.library()
    return {"library": str(kernels.library_path()), "prebuilt": prebuilt,
            "sec": round(time.perf_counter() - t0, 2)}


def warm_start(models: list[str] | None = None, size: int = 64,
               frames: int = 4, device=None) -> dict:
    """Each model of ``models`` (else every available one) built on
    ``device`` and run on a seeded ``(frames, size, size, 3)`` clip: per
    model ``ok``, the seconds and the output's shape, or the error."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(f"warm kernels: {warm_kernels()}", flush=True)
    clip = torch.from_numpy(np.random.default_rng(0).random(
        (frames, size, size, 3), np.float32)).to(dev)
    results = {}
    for name in sorted(models or probe_available()):
        t0 = time.time()
        try:
            h = build_handler(name, device=dev)
            if hasattr(h, "process_clip"):
                out = h.process_clip(clip)
            else:
                out = h.process_frames(clip)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            results[name] = {"ok": True, "sec": round(time.time() - t0, 2),
                             "out_shape": list(out.shape)}
        except Exception as e:       # report each model, go on to the next
            results[name] = {"ok": False, "error": str(e)}
        print(f"warm {name}: {results[name]}", flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(prog="video_enhancer_tpu_torch.warm_start")
    p.add_argument("--platform", default=None,
                   help="cpu or gpu (as $VETPU_PLATFORM)")
    p.add_argument("--models", nargs="*", default=None)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = args.device or (platform_device(args.platform)
                             if args.platform else None)
    results = warm_start(models=args.models, size=args.size, device=device)
    ok = sum(1 for r in results.values() if r["ok"])
    print(f"warm start: {ok}/{len(results)} models ready")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
