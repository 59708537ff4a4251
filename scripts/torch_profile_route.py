#!/usr/bin/env python3
"""The host-side steps of the PyTorch/CUDA port's auto route, one by one.

    python3 scripts/torch_profile_route.py [--root DIR] [--repeats 5]
        [--engines ditvr,vsrm] [--tag NAME] [--cprofile 30]
        [--steps route,preprocess,load,build,enhance,e2e]

Imports ``video_enhancer_tpu_torch`` from ``--root`` (this checkout by
default, so that two trees can be timed by the same script in one run),
builds its kernels, and for each engine times, ``--repeats`` times after
one warm-up each:

- ``route``: ``probe_available`` and ``DegradationRouter.analyze_frames`` on
  the clip's sampled frames, as ``run_auto_frames`` calls them;
- ``preprocess``: ``preprocess_frames`` with the plan's experts;
- ``load``: ``registry.load_params(name)`` (init, then the checkpoint);
- ``build``: ``registry.build_handler(name)`` on the card;
- ``enhance``: that handler's ``enhance_frames`` over the clip;
- ``e2e``: ``run_auto_frames(clip)`` (ditvr through the router, which
  picks it for the dim clip; vsrm as ``engine="vsrm"``), split by its
  stats into routing (``analysis_time_sec``), enhance
  (``processing_time_sec``) and the rest (preprocessing and the build).
  With ``--cprofile N`` its repeats also run under ``cProfile``, and the
  N functions of most cumulative time are printed.

The clip is 16 frames of 180x320: for ditvr the dim sinusoid that
chip_smoke.py routes to ditvr, for vsrm seeded noise. Prints each step's
times in seconds and one JSON line of medians. ``--device cpu`` rehearses
it without a card (use a small ``--height``/``--width``).
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--repeats", type=int, default=5)
ap.add_argument("--engines", default="ditvr,vsrm")
ap.add_argument("--steps", default="route,preprocess,load,build,enhance,e2e")
ap.add_argument("--cprofile", type=int, default=0)
ap.add_argument("--tag", default="")
ap.add_argument("--device", default="cuda")
ap.add_argument("--frames", type=int, default=16)
ap.add_argument("--height", type=int, default=180)
ap.add_argument("--width", type=int, default=320)
args = ap.parse_args()
sys.path.insert(0, str(Path(args.root).resolve()))

from video_enhancer_tpu_torch import kernels  # noqa: E402
from video_enhancer_tpu_torch.analysis import DegradationRouter  # noqa: E402
from video_enhancer_tpu_torch.config import default_policy  # noqa: E402
from video_enhancer_tpu_torch.io.video import sample_indices  # noqa: E402
from video_enhancer_tpu_torch.runtime import registry  # noqa: E402
from video_enhancer_tpu_torch.runtime.pipeline import (  # noqa: E402
    apply_degradation_context, preprocess_frames, run_auto_frames)


def dim_clip(n: int, h: int, w: int, seed: int = 0) -> list[np.ndarray]:
    """chip_smoke.py's clip that routes to ditvr."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for _ in range(n):
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([0.2 + 0.15 * np.sin(0.1 * (xx + 0.7 * yy) + ph[c])
                        for c in range(3)], axis=-1)
        frames.append(np.clip(np.round(img * 255), 0, 255).astype(np.uint8))
    return frames


def noise_clip(n: int, h: int, w: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))


def main() -> int:
    cuda = args.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        kernels.build()
        kernels.library()
    pkg = Path(registry.__file__).resolve().parents[1]
    print(f"package {pkg}; tag {args.tag!r}")
    out = {"tag": args.tag, "package": str(pkg)}
    for name in args.engines.split(","):
        frames = (dim_clip if name == "ditvr" else noise_clip)(
            args.frames, args.height, args.width)
        kw = {} if name == "ditvr" else {"engine": name}
        policy = default_policy()
        sampled = np.stack([frames[i] for i in sample_indices(len(frames))])

        def route():
            router = DegradationRouter(
                policy, available_models=registry.probe_available(policy))
            return router.analyze_frames(sampled, fps=30.0,
                                         frame_count=len(frames),
                                         device=torch.device(args.device))

        plan = route()
        handler = registry.build_handler(name, device=args.device)
        if handler.context:
            apply_degradation_context(handler, plan)
        steps = {
            "route": route,
            "preprocess": lambda: preprocess_frames(
                frames, plan["expert_routing"]["experts"],
                torch.device(args.device)),
            "load": lambda: registry.load_params(name),
            "build": lambda: registry.build_handler(name, device=args.device),
            "enhance": lambda: list(handler.enhance_frames(iter(frames))),
            "e2e": lambda: run_auto_frames(frames, device=args.device, **kw),
        }
        times = {}
        for step in args.steps.split(","):
            fn = steps[step]
            fn()                                       # warm-up
            sync()
            ts, parts = [], []
            prof = (cProfile.Profile() if step == "e2e" and args.cprofile
                    else None)
            if prof:
                prof.enable()
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                res = fn()
                sync()
                ts.append(time.perf_counter() - t0)
                if step == "e2e":
                    st = res[1]
                    a = st["routing_plan"]["analysis_time_sec"]
                    e = st["processing_time_sec"]
                    parts.append((a, e, ts[-1] - a - e))
            if prof:
                prof.disable()
                pstats.Stats(prof).sort_stats("cumulative").print_stats(
                    args.cprofile)
            times[step] = ts
            print(f"{name} {step}: median {statistics.median(ts):.4f} s; "
                  + " ".join(f"{t:.4f}" for t in ts))
            for i, part in enumerate(("routing", "enhance", "rest")):
                if parts:
                    vs = [p[i] for p in parts]
                    times[f"e2e_{part}"] = vs
                    print(f"{name} e2e {part}: median "
                          f"{statistics.median(vs):.4f} s; "
                          + " ".join(f"{t:.4f}" for t in vs))
        primary = plan["expert_routing"]["primary_model"]
        print(f"{name}: the router's primary is {primary}")
        out[name] = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
