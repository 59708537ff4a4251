"""The auto pipeline: route -> preprocess -> primary model -> post stages.

Counterpart of video_enhancer_tpu/runtime/pipeline.py, with two entries:

- ``run_auto_frames(frames_u8, fps, ...) -> (frames_out, stats)``: the
  route on frames in memory, on the card unless ``device="cpu"``. It
  samples the router's 12 frames, routes them, runs the preprocessing
  experts, builds the primary's handler, feeds it the router's degradation
  context (ditvr) and streams the frames through it. It needs no OpenCV.
  A VSR handler's stats carry ``windows_skipped`` (the windows seedvr2's
  quality gate passed through), as its ``enhance_video`` stats do.
- ``run_auto_pipeline(input_path, output_path, ...) -> stats``: the same
  flow file to file through OpenCV, with the preprocessed video written to
  an intermediate file, as the JAX pipeline does. It takes the JAX
  pipeline's keywords; ``scale`` and ``enable_temporal_smoothing`` change
  nothing there, and nothing here.

A failure of the primary falls back to the bicubic handler and says so in
``stats["fallback_from"]`` and ``stats["fallback_error"]``; a conditioned
primary's context is recorded in ``stats["context"]``. The post stages
(temporal consistency, face restoration, frame interpolation) are not
ported: each one the plan asks for is recorded as
``stats["<stage>_error"] = "not ported"``, where the JAX pipeline records a
post stage that failed.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis import DegradationRouter
from ..config import Policy, default_policy
from ..device import resolve_device
from ..io.video import sample_indices
from .experts import preprocess_clip
from .registry import build_handler, probe_available
from .vsr_handler import VSRHandler

log = logging.getLogger(__name__)

__all__ = ["run_auto_frames", "run_auto_pipeline", "preprocess_frames",
           "apply_degradation_context"]

POST_STAGES = ("face_restoration", "temporal_consistency",
               "hfr_interpolation")


def _set_engine(plan: dict, engine: str) -> dict:
    """Let an explicit engine replace the routed primary."""
    if engine != "auto":
        plan["expert_routing"]["primary_model"] = engine
        order = [s for s in plan["processing_order"]
                 if not s.startswith("sota_")]
        plan["processing_order"] = order[:1] + [f"sota_{engine}"] + order[1:]
    return plan


def apply_degradation_context(handler, plan: dict) -> None:
    """Feed the router's degradation estimate to a conditioned model
    (ditvr): scores (noise, motion_blur, compression) and the type index of
    DEG_TYPES = (unknown, noise, blur, compression)."""
    deg = plan.get("degradations", {})
    scores = [float(deg.get("noise", 0.0)),
              float(deg.get("motion_blur", 0.0)),
              float(deg.get("compression", 0.0))]
    dtype_idx = 0
    if max(scores) > 0.3:
        dtype_idx = 1 + int(max(range(3), key=lambda i: scores[i]))
    handler.update_context(degradation_scores=scores,
                           degradation_type=dtype_idx)


def _finish_stats(stats: dict, handler, plan: dict, t0: float) -> dict:
    """Record the conditioning the primary ran with, the post stages the
    plan asks for (not ported), the plan and the total time."""
    if handler.context:
        stats["context"] = {k: v.tolist() for k, v in handler.context.items()}
    for stage in plan["processing_order"]:
        if stage in POST_STAGES:
            log.warning("post stage %s is not ported", stage)
            stats[f"{stage}_error"] = "not ported"
    stats["routing_plan"] = plan
    stats["total_time_sec"] = time.time() - t0
    return stats


def _stream(handler, frames) -> tuple[list[np.ndarray], dict]:
    """The handler's output frames and, from a VSR handler, its
    ``windows_skipped``."""
    if not isinstance(handler, VSRHandler):
        return list(handler.enhance_frames(iter(frames))), {}
    counts = {"windows_skipped": 0}
    return list(handler.enhance_frames(iter(frames), counts)), counts


def preprocess_frames(frames_u8, experts: dict,
                      device: torch.device) -> list[np.ndarray]:
    """The preprocessing experts over the whole clip on ``device``, back
    to uint8 frames (as the JAX pipeline writes its intermediate video)."""
    clip = torch.from_numpy(np.stack(frames_u8)).to(device).float() / 255.0
    out = preprocess_clip(clip, do_denoise=bool(experts.get("denoise")),
                          do_lowlight=bool(experts.get("low_light")),
                          do_compression=bool(experts.get("compression_cleanup")))
    u8 = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
    return list(u8.cpu().numpy())


def run_auto_frames(frames_u8, fps: float = 30.0, engine: str = "auto",
                    latency_class: str = "standard",
                    enable_face_expert: bool | None = None,
                    enable_hfr: bool | None = None,
                    policy: Policy | None = None,
                    device: str | torch.device | None = None
                    ) -> tuple[list[np.ndarray], dict]:
    """Enhance uint8 ``(H, W, 3)`` frames held in memory; returns the output
    frames and the stats, with the plan under ``routing_plan``."""
    policy = policy or default_policy()
    dev = resolve_device(device)
    t0 = time.time()
    frames = list(frames_u8)
    if not frames:
        raise ValueError("run_auto_frames: no frames")
    router = DegradationRouter(policy, available_models=probe_available(policy))
    sampled = np.stack([frames[i] for i in sample_indices(len(frames))])
    plan = _set_engine(router.analyze_frames(
        sampled, fps=fps, frame_count=len(frames),
        latency_class=latency_class, enable_face_expert=enable_face_expert,
        enable_hfr=enable_hfr, device=dev), engine)
    primary = plan["expert_routing"]["primary_model"]
    experts = plan["expert_routing"].get("experts", {})

    if "preprocessing" in plan["processing_order"]:
        frames = preprocess_frames(frames, experts, dev)

    try:
        handler = build_handler(primary, policy, device=dev)
        if handler.context:
            apply_degradation_context(handler, plan)
        t1 = time.time()
        out, counts = _stream(handler, frames)
    except Exception as e:  # the primary's failure serves bicubic
        log.warning("primary model %s failed (%s); bicubic fallback",
                    primary, e, exc_info=True)
        handler = build_handler("bicubic", policy, device=dev)
        t1 = time.time()
        out, counts = _stream(handler, frames)
        fallback = {"fallback_from": primary, "fallback_error": str(e)}
    else:
        fallback = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t1
    h, w = frames[0].shape[:2]
    stats = {"status": "success", "model": handler.name,
             "frames_processed": len(out), "processing_time_sec": dt,
             "fps": len(out) / dt if dt > 0 else 0.0,
             "input_resolution": [h, w],
             "output_resolution": list(out[0].shape[:2]) if out else [],
             "scale": handler.scale, **counts, **fallback}
    return out, _finish_stats(stats, handler, plan, t0)


def run_auto_pipeline(input_path, output_path, engine: str = "auto",
                      scale: int | None = None,
                      latency_class: str = "standard",
                      enable_face_expert: bool | None = None,
                      enable_hfr: bool | None = None,
                      enable_temporal_smoothing: bool | None = None,
                      policy: Policy | None = None,
                      device: str | torch.device | None = None) -> dict:
    """File to file: route the file's sampled frames, preprocess into an
    intermediate file, enhance it with the primary (bicubic on failure).
    ``scale`` and ``enable_temporal_smoothing`` are accepted as the JAX
    pipeline accepts them (video_enhancer_tpu/runtime/pipeline.py:26-36),
    where neither changes the result: the scale is the primary's."""
    policy = policy or default_policy()
    dev = resolve_device(device)
    t0 = time.time()
    router = DegradationRouter(policy, available_models=probe_available(policy))
    plan = _set_engine(router.analyze_and_route(
        input_path, latency_class=latency_class,
        enable_face_expert=enable_face_expert, enable_hfr=enable_hfr,
        device=dev), engine)
    primary = plan["expert_routing"]["primary_model"]
    experts = plan["expert_routing"].get("experts", {})
    work_input = str(input_path)
    tmp_files: list[str] = []
    try:
        if "preprocessing" in plan["processing_order"]:
            work_input = _preprocess_video(work_input, experts, dev,
                                           tmp_files)
        try:
            handler = build_handler(primary, policy, device=dev)
            if handler.context:
                apply_degradation_context(handler, plan)
            stats = handler.enhance_video(work_input, output_path)
        except Exception as e:  # the primary's failure serves bicubic
            log.warning("primary model %s failed (%s); bicubic fallback",
                        primary, e, exc_info=True)
            handler = build_handler("bicubic", policy, device=dev)
            stats = handler.enhance_video(work_input, output_path)
            stats["fallback_from"] = primary
            stats["fallback_error"] = str(e)
        return _finish_stats(stats, handler, plan, t0)
    finally:
        for f in tmp_files:
            Path(f).unlink(missing_ok=True)


def _preprocess_video(input_path: str, experts: dict, device: torch.device,
                      tmp_files: list[str]) -> str:
    """The preprocessing experts over the whole video, into a temporary
    file."""
    from ..io.video import get_video_metadata, read_frames, write_frames

    meta = get_video_metadata(input_path)
    frames = preprocess_frames(list(read_frames(input_path)), experts, device)
    fd, tmp = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    tmp_files.append(tmp)
    write_frames(tmp, frames, (meta.height, meta.width), fps=meta.fps)
    return tmp
