"""Command-line entry point of the port.

Usage:
  python -m video_enhancer_tpu_torch.cli demo OUT.avi [--frames N]
  python -m video_enhancer_tpu_torch.cli enhance IN.avi OUT.avi \
      [--engine cnn|bicubic|auto|...] [--scale 2] [--device cpu]
  python -m video_enhancer_tpu_torch.cli metadata IN.avi
  python -m video_enhancer_tpu_torch.cli eval OUT.avi REF.avi

Counterpart of video_enhancer_tpu/cli.py, with its arguments and JSON
output, plus ``--device`` (the card unless ``cpu`` is given; without a card
the command fails, it does not fall back to the CPU). ``.avi`` files are
raw AVI read and written without OpenCV (io/video.py); other containers
need OpenCV.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="video_enhancer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="generate a synthetic demo video")
    d.add_argument("output")
    d.add_argument("--frames", type=int, default=48)
    d.add_argument("--height", type=int, default=240)
    d.add_argument("--width", type=int, default=320)

    e = sub.add_parser("enhance", help="enhance/upscale a video")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--engine", default="cnn",
                   choices=["cnn", "bicubic", "auto", "vsrm", "seedvr2",
                            "ditvr", "fast_mamba_vsr"])
    e.add_argument("--scale", type=int, default=2)
    e.add_argument("--batch", type=int, default=8)

    m = sub.add_parser("metadata", help="print video metadata as JSON")
    m.add_argument("input")

    ev = sub.add_parser("eval", help="PSNR/SSIM between two videos")
    ev.add_argument("output")
    ev.add_argument("reference")

    for sp in (e, ev):
        sp.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    if args.cmd == "demo":
        from .io.demo import write_demo_video

        path = write_demo_video(args.output, frames=args.frames,
                                size_hw=(args.height, args.width))
        print(json.dumps({"status": "success", "path": path}))
        return 0

    if args.cmd == "metadata":
        from .io.video import get_video_metadata

        print(json.dumps(get_video_metadata(args.input).to_dict()))
        return 0

    from .device import resolve_device

    device = resolve_device(args.device)

    if args.cmd == "enhance":
        if args.engine in ("cnn", "bicubic"):
            from .runtime.upscaler_handler import CnnUpscalerHandler

            h = CnnUpscalerHandler(scale=args.scale,
                                   use_cnn=args.engine == "cnn",
                                   device=device)
            stats = h.enhance_video(args.input, args.output,
                                    batch_size=args.batch)
        else:
            from .runtime.pipeline import run_auto_pipeline

            stats = run_auto_pipeline(args.input, args.output,
                                      engine=args.engine, scale=args.scale,
                                      device=device)
        from .io.audio import passthrough_audio

        try:
            stats["audio"] = passthrough_audio(args.input, args.output)
        except Exception as e:
            stats["audio"] = f"dropped ({e})"
        print(json.dumps(stats))
        return 0

    if args.cmd == "eval":
        import torch

        from .io.video import read_video
        from .ops.resize import resize
        from .utils.metrics import evaluate_pair

        def load(path):
            frames = torch.from_numpy(read_video(path))
            return frames.to(device).float() / 255.0

        out, ref = load(args.output), load(args.reference)
        n = min(out.shape[0], ref.shape[0])
        if out.shape[1:3] != ref.shape[1:3]:
            ref = resize(ref[:n], tuple(out.shape[1:3]), method="cubic")
        res = evaluate_pair(out[:n], ref[:n])
        print(json.dumps({k: float(v) for k, v in res.items()}))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
