#!/usr/bin/env python3
"""Where the face path's time goes on the card: host and device.

    python3 scripts/torch_profile_faces.py

Needs one card and builds no kernel. On chip_smoke.py's seeded face clip
(16 frames of 180x320) upscaled by realesrgan x4 to 720x1280, as phase 16
serves it, it profiles one frame's detection, one face's quality score,
one face's restoration and the routing of 12 sampled 180x320 frames, each
after a warm-up call: wall ms (host clock around the call, which ends in a
copy back; median of 5), then one call under ``torch.profiler`` (CPU and
CUDA): the device kernels and their device time, the CUDA runtime calls
the host made (kernel launches, copies, synchronisations) and the host ops
with the most self time; then ``cProfile`` over 5 calls for the Python
functions with the most own time (what the torch profiler does not see).
The card's name and power limit lead the output.
"""

from __future__ import annotations

import cProfile
import pstats
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import face_clip, nvidia_smi  # noqa: E402
from video_enhancer_tpu_torch.analysis import DegradationRouter  # noqa: E402
from video_enhancer_tpu_torch.io.video import sample_indices  # noqa: E402
from video_enhancer_tpu_torch.runtime.face_handler import (  # noqa: E402
    FaceRestorationExpert)
from video_enhancer_tpu_torch.runtime.registry import (  # noqa: E402
    build_handler, probe_available)


def wall_ms(fn, n: int = 5) -> float:
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def profile(name: str, fn) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    ms = wall_ms(fn)
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    dev_ms, kernels, runtime, host = 0.0, 0, {}, []
    for e in p.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            dev_ms += (getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0)) / 1e3
            kernels += e.count
        elif e.key.startswith("cuda"):
            runtime[e.key] = (e.count, e.self_cpu_time_total / 1e3)
        else:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    host.sort(reverse=True)
    print(f"{name}: {ms:.3f} ms wall (median of 5); {kernels} device "
          f"kernels, {dev_ms:.3f} ms device time (idle "
          f"{1 - dev_ms / ms:.3f})")
    print("  CUDA runtime calls (count, host ms): " + "; ".join(
        f"{k} x{c} {t:.3f}" for k, (c, t) in sorted(
            runtime.items(), key=lambda kv: -kv[1][1])[:6]))
    print("  host ops by self time (ms): " + "; ".join(
        f"{k} x{c} {t:.3f}" for t, c, k in host[:8]))
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][2])
    print("  Python by own time a call (ms): " + "; ".join(
        f"{Path(f).name}:{line}({fn_name}) {1e3 * tt / 5:.3f}"
        for (f, line, fn_name), (_, _, tt, _, _) in rows[:8]))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_faces: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; {nvidia_smi()}")
    frames = face_clip(16, 180, 320)
    big = list(build_handler("realesrgan").enhance_frames(iter(frames)))
    expert = FaceRestorationExpert()
    box = expert.detect_faces(big[0])[0]
    x, y, w, h = box
    crop = np.ascontiguousarray(big[0][y:y + h, x:x + w])
    print(f"720x1280 frame 0, first box {box}")
    profile("detection, one 720x1280 frame",
            lambda: expert.detect_faces(big[0]))
    profile("quality score, one face", lambda: expert.face_quality(crop))
    profile("restoration, one face",
            lambda: expert.restore_face(big[0], box, 0.6))
    router = DegradationRouter(available_models=probe_available())
    sampled = np.stack([frames[i] for i in sample_indices(len(frames))])
    profile("routing 12 sampled 180x320 frames (4 detected)",
            lambda: router.analyze_frames(sampled, frame_count=16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
