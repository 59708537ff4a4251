#!/usr/bin/env python3
"""The Mamba-1 scan kernels of the PyTorch/CUDA port (TPU kernel rows 6-10)
and the depthwise conv + SiLU (row 11) at the paths' shapes, and where the
exact time-sharded fast_mamba_vsr spends its time.

    python3 scripts/torch_profile_scans.py [--root DIR] [--tag NAME]
        [--trace]

Imports ``chip_smoke`` and ``video_enhancer_tpu_torch`` from ``--root``
(this checkout by default, so that two trees can be timed by the same
script in one call), builds the kernels and runs
``chip_smoke.scans_vs_plain``, ``shared_scan_vs_plain`` and
``dwconv_vs_plain`` (the last two where the checkout has them): each
kernel against its plain version in fp32 and bf16, with the median time
of 10 runs after 3 warm-ups and its bound. With ``--trace``,
``torch.profiler`` then records one call of
``make_exact_sharded_fmv`` (one-rank NCCL group, bundled weights in bf16,
16 frames of 180x320) after a warm-up, and prints the wall time, the
device's busy time and the ops of most device time. The last line is one
JSON object: the tag, the card, each kernel's bf16 ms and, with
``--trace``, the traced call's numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--tag", default="")
ap.add_argument("--trace", action="store_true")
ap.add_argument("--top", type=int, default=15)
args = ap.parse_args()
sys.path.insert(0, str(Path(args.root).resolve()))

import chip_smoke  # noqa: E402
from video_enhancer_tpu_torch import kernels  # noqa: E402


def trace_sharded_fmv() -> dict:
    from video_enhancer_tpu_torch.models import fast_mamba_vsr
    from video_enhancer_tpu_torch.parallel.inference import \
        make_exact_sharded_fmv
    from video_enhancer_tpu_torch.parallel.mesh import make_mesh
    from video_enhancer_tpu_torch.runtime.registry import load_params
    from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params

    frames = chip_smoke.synthetic_clip(16, 180, 320)
    clip = (torch.from_numpy(np.stack(frames)).cuda().float()[None]
            / 255.0).bfloat16()
    axis = make_mesh(time=1)
    try:
        params = cast_params(load_params("fast_mamba_vsr"), torch.bfloat16,
                             axis.device)
        fn = make_exact_sharded_fmv(axis)
        out = {}
        with torch.inference_mode():
            for name, call in (("sharded", lambda: fn(params, clip)),
                               ("single", lambda: fast_mamba_vsr.apply(
                                   params, clip))):
                call()
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy = sum(e.time_range.elapsed_us() for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           ) / 1e3
                print(f"{name} fast_mamba_vsr, 16 frames: wall "
                      f"{1e3 * wall:.2f} ms, device busy {busy:.2f} ms, "
                      f"idle share {max(0.0, 1 - busy / (1e3 * wall)):.3f}")
                print(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=args.top,
                    max_name_column_width=60))
                out[name] = {"wall_ms": 1e3 * wall, "busy_ms": busy}
    finally:
        axis.destroy()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_scans: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        rec = chip_smoke.scans_vs_plain()
        # rows 10 and 11, in a checkout that has them
        for fn in ("shared_scan_vs_plain", "dwconv_vs_plain"):
            if hasattr(chip_smoke, fn):
                rec.update(getattr(chip_smoke, fn)())
    res = {"tag": args.tag, "device": smi,
           "ms": {k: v["ms"] for k, v in rec.items()},
           "plain_ms": {k: v["plain_ms"] for k, v in rec.items()}}
    if args.trace:
        res["trace"] = trace_sharded_fmv()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
