#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's seedvr2 windows goes.

    python3 scripts/torch_profile_seedvr2.py [--windows 3] [--trace out.json]

Builds ``build_handler("seedvr2")`` (bundled weights, bf16, base 32,
channel mult (1, 2, 4)), warms up on one 8x180x320 window of
``chip_smoke.blocky_clip`` (soft: the quality gate runs it), then traces
``--windows`` windows with ``torch.profiler`` and prints: wall time per
window, the device's busy and idle share of it, and the ops that take
the device's time, by self device time. ``--device cpu`` rehearses the
script without a card (no device numbers then; use a small
``--height``/``--width``, multiples of 4).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import blocky_clip  # noqa: E402
from video_enhancer_tpu_torch.runtime.registry import build_handler  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--trace", default=None, help="chrome trace output path")
    args = ap.parse_args()

    cuda = args.device == "cuda"
    handler = build_handler("seedvr2", device=args.device)
    frames = np.stack(blocky_clip(handler.chunk, args.height, args.width))
    clip = torch.from_numpy(frames).to(handler.device).float() / 255.0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    handler.process_clip(clip)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.windows):
            handler.process_clip(clip)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.windows

    print(f"device: {torch.cuda.get_device_name(0) if cuda else 'cpu'}")
    print(f"seedvr2 window {handler.chunk}x{args.height}x{args.width}: "
          f"{wall_ms:.2f} ms wall per window (profiled)")
    if cuda:
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        busy_ms = busy_us / 1e3 / args.windows
        print(f"device busy {busy_ms:.2f} ms per window, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=30,
                                    max_name_column_width=60))
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
