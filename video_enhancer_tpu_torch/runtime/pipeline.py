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
primary's context is recorded in ``stats["context"]``.

The post stages run in the plan's order, each on the handler's device over
the primary's uint8 output (over 255, processed, rounded back): in memory
for ``run_auto_frames`` and, as the JAX pipeline does, on the written file
for ``run_auto_pipeline``.

- Face restoration (``face_restoration``, runtime/face_handler.py, the
  plan holds it when ``enable_face_expert`` is asked for and the router saw
  faces) restores the poor faces of every frame (``FaceRestorationExpert``
  at its defaults: ``process_frames_selective`` in memory,
  ``process_video_selective`` rewriting the file); it sets
  ``stats["face_restoration"]``, ``stats["face_restoration_sec"]`` and
  ``stats["faces_restored"]``.
- Temporal consistency (``experts.temporal_smooth``) rewrites the file at
  its fps; it sets ``stats["temporal_smoothing"]`` and times itself in
  ``stats["temporal_smoothing_sec"]``.
- Frame interpolation (``hfr_interpolation``, the plan holds it when
  ``enable_hfr`` is asked for) runs RIFE's ``_double`` once (T -> 2T - 1,
  runtime/rife_handler.py) and rewrites the file at twice its fps; it sets
  ``stats["hfr"]``, ``stats["hfr_interpolation_sec"]`` and, when RIFE fell
  back to blending pairs, ``stats["hfr_blend_fallbacks"]``.

The stages run in the JAX pipeline's order: face, then temporal
consistency, then frame interpolation. As in the JAX pipeline a post stage
is best effort: its failure is recorded as ``stats["<stage>_error"]``,
with no retry elsewhere.
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
from .experts import preprocess_clip, temporal_smooth
from .face_handler import FaceRestorationExpert
from .registry import build_handler, probe_available
from .rife_handler import RIFEHandler
from .vsr_handler import VSRHandler

log = logging.getLogger(__name__)

__all__ = ["run_auto_frames", "run_auto_pipeline", "preprocess_frames",
           "apply_degradation_context", "face_frames", "smooth_frames",
           "hfr_frames"]

# each post stage's flag and the prefix of its time in the stats
_STAGE_STATS = {"face_restoration": ("face_restoration", "face_restoration"),
                "temporal_consistency": ("temporal_smoothing",
                                         "temporal_smoothing"),
                "hfr_interpolation": ("hfr", "hfr_interpolation")}


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


def _finish_stats(stats: dict, handler, plan: dict, t0: float,
                  stages: dict) -> dict:
    """Run the post stages the plan asks for (``stages[stage]()``, which
    returns any stats of its own), then record the conditioning the primary
    ran with, the plan and the total time."""
    for stage in plan["processing_order"]:
        if stage not in _STAGE_STATS:
            continue
        t1 = time.time()
        try:
            extra = stages[stage]()
        except Exception as e:  # post stages are best effort
            log.warning("post stage %s failed: %s", stage, e, exc_info=True)
            stats[f"{stage}_error"] = str(e)
            continue
        flag, sec = _STAGE_STATS[stage]
        stats[flag] = True
        stats[f"{sec}_sec"] = time.time() - t1
        stats.update(extra or {})
    if handler.context:
        stats["context"] = {k: v.tolist() for k, v in handler.context.items()}
    stats["routing_plan"] = plan
    stats["total_time_sec"] = time.time() - t0
    return stats


def face_frames(frames_u8, device: torch.device) -> tuple[list, dict]:
    """The face stage on uint8 frames, on ``device``: the expert at its
    defaults. Returns the frames and the stage's stats
    (``faces_restored``)."""
    out, stats = FaceRestorationExpert(
        device=device).process_frames_selective(frames_u8)
    return out, {"faces_restored": stats["faces_restored"]}


def smooth_frames(frames_u8, device: torch.device) -> list[np.ndarray]:
    """The temporal-consistency stage on uint8 frames, on ``device``: over
    255, ``temporal_smooth``, then rounded (halves to even) and clamped
    back to uint8, as the JAX pipeline does on its written video."""
    clip = torch.from_numpy(np.stack(frames_u8)).to(device).float() / 255.0
    out = temporal_smooth(clip)
    u8 = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
    return list(u8.cpu().numpy())


def hfr_frames(frames_u8, device: torch.device) -> tuple[list, dict]:
    """The frame-interpolation stage on uint8 frames, on ``device``: one
    doubling by RIFE (T -> 2T - 1, over 255, rounded and clamped back).
    Returns the frames and the stage's stats (``hfr_blend_fallbacks`` when
    RIFE fell back to blending)."""
    rife = RIFEHandler(device=device)
    out = rife.interpolate_frames(frames_u8, 2)
    return out, _fallbacks(rife.blend_fallbacks)


def _fallbacks(n: int) -> dict:
    return {"hfr_blend_fallbacks": n} if n else {}


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

    def faces():
        out[:], extra = face_frames(out, dev)
        return extra

    def smooth():
        out[:] = smooth_frames(out, dev)

    def hfr():
        frames_hfr, extra = hfr_frames(out, dev)
        out[:] = frames_hfr
        return extra

    return out, _finish_stats(stats, handler, plan, t0, {
        "face_restoration": faces, "temporal_consistency": smooth,
        "hfr_interpolation": hfr})


def run_auto_pipeline(input_path, output_path, engine: str = "auto",
                      scale: int | None = None,
                      latency_class: str = "standard",
                      enable_face_expert: bool | None = None,
                      enable_hfr: bool | None = None,
                      enable_temporal_smoothing: bool | None = None,
                      policy: Policy | None = None,
                      device: str | torch.device | None = None) -> dict:
    """File to file: route the file's sampled frames, preprocess into an
    intermediate file, enhance it with the primary (bicubic on failure),
    then run the post stages on the output file. ``scale`` and
    ``enable_temporal_smoothing`` are accepted as the JAX pipeline accepts
    them (video_enhancer_tpu/runtime/pipeline.py:26-36), where neither
    changes the result: the scale is the primary's, and the plan alone
    decides the temporal stage (:82-92)."""
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
        return _finish_stats(stats, handler, plan, t0, {
            "face_restoration": lambda: _apply_faces(output_path, dev),
            "temporal_consistency":
                lambda: _apply_temporal_smoothing(output_path, dev),
            "hfr_interpolation": lambda: _apply_hfr(output_path, dev)})
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


def _apply_faces(path, device: torch.device) -> dict:
    """The face stage on a written video, rewritten in place."""
    stats = FaceRestorationExpert(device=device).process_video_selective(
        path, path)
    return {"faces_restored": stats["faces_restored"]}


def _apply_temporal_smoothing(path, device: torch.device) -> None:
    """The temporal-consistency stage on a written video, rewritten in
    place at its fps."""
    from ..io.video import get_video_metadata, read_frames, write_frames

    meta = get_video_metadata(path)
    frames = smooth_frames(list(read_frames(path)), device)
    write_frames(path, frames, (meta.height, meta.width), fps=meta.fps)


def _apply_hfr(path, device: torch.device) -> dict:
    """The frame-interpolation stage on a written video: rewritten with
    2T - 1 frames at twice its fps (through a temporary file beside it)."""
    tmp = f"{path}.hfr.mp4"
    rife = RIFEHandler(device=device)
    rife.interpolate_video(path, tmp, interpolation_factor=2)
    Path(tmp).replace(path)
    return _fallbacks(rife.blend_fallbacks)
