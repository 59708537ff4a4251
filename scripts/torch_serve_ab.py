#!/usr/bin/env python3
"""Served windows of two checkouts of the port, timed in turn on the card.

    python3 scripts/torch_serve_ab.py --root A --root B [--calls 20]
        [--rounds 1] [--models vsrm,realesrgan_fast]

Each run is a process of its own that imports ``video_enhancer_tpu_torch``
from one ``--root`` (a checkout, or a ``git archive`` of one unpacked with
``video_enhancer_tpu/weights`` linked in, and the kernel library built in
its ``video_enhancer_tpu_torch/_build``). It builds ``build_handler(name)``
for each model (bundled weights, bf16, full width), warms it up on one
window, then serves ``--calls`` windows of ``chunk`` frames of 180x320 (the
shape phase 4 of ``chip_smoke.py`` serves) through ``process_clip``, each
between a host clock and a CUDA event pair with a sync after it. A round
runs the roots in the order A, B, B, A. Prints each run, the medians of
the wall and device ms a window by root and model, whether every root
served the same bytes, the size of the cuBLAS workspace that a first
matmul allocates with and without ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, the
card's name and power limit, and as its last line one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HEIGHT, WIDTH = 180, 320
SEED = 0

_PROBE = """
import torch
a = torch.ones((64, 64), device="cuda")
torch.cuda.synchronize()
m0 = torch.cuda.memory_allocated()
b = a @ a
torch.cuda.synchronize()
print(torch.cuda.memory_allocated() - m0 - b.numel() * b.element_size())
"""


def child(root: str, models: list[str], calls: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import hashlib

    import torch

    import video_enhancer_tpu_torch as pkg
    from video_enhancer_tpu_torch import kernels
    from video_enhancer_tpu_torch.runtime.registry import build_handler

    here = Path(pkg.__file__).resolve()
    if Path(root).resolve() not in here.parents:
        raise SystemExit(f"imported {here}, not from {root}")
    kernels.build()
    out = {"root": root}
    for name in models:
        handler = build_handler(name)
        gen = torch.Generator().manual_seed(SEED)
        clip = torch.rand((handler.chunk, HEIGHT, WIDTH, 3),
                          generator=gen).to(handler.device)
        y = handler.process_clip(clip)
        torch.cuda.synchronize()
        digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        wall, dev = [], []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            handler.process_clip(clip)
            end.record()
            end.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        out[name] = {"frames": handler.chunk, "sha256": digest,
                     "wall_ms": statistics.median(wall),
                     "event_ms": statistics.median(dev),
                     "wall_all": [round(x, 3) for x in wall]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--models", default="vsrm,realesrgan_fast")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    models = args.models.split(",")
    if args.child:
        print(json.dumps(child(args.root[0], models, args.calls)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = args.root
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    runs = []
    for root in order:
        res = subprocess.run(
            [sys.executable, __file__, "--child", "--root", root,
             "--calls", str(args.calls), "--models", args.models],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run))
    summary = {}
    for name in models:
        summary[name] = {r: {k: statistics.median(
            run[name][k] for run in runs if run["root"] == r)
            for k in ("wall_ms", "event_ms")} for r in roots}
        summary[name]["same_bytes"] = len(
            {run[name]["sha256"] for run in runs}) == 1
        summary[name]["frames"] = runs[0][name]["frames"]
    workspace = {}
    for label, env in (("unset", {}),
                       ("4096:8", {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})):
        e = {k: v for k, v in os.environ.items()
             if k != "CUBLAS_WORKSPACE_CONFIG"}
        res = subprocess.run([sys.executable, "-c", _PROBE], env={**e, **env},
                             capture_output=True, text=True, timeout=300,
                             check=True)
        workspace[label] = int(res.stdout.strip().splitlines()[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for name in models:
        s = summary[name]
        print(f"{name} window {s['frames']}x{HEIGHT}x{WIDTH}: " + "; ".join(
            f"{r}: {s[r]['wall_ms']:.3f} ms wall, {s[r]['event_ms']:.3f} ms "
            f"by events" for r in roots)
              + f"; same bytes from every root: {s['same_bytes']}")
    print(f"cuBLAS workspace after a first matmul: {workspace} bytes")
    print(smi)
    print(json.dumps({"summary": summary, "cublas_workspace": workspace,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
