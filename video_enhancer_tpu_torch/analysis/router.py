"""DegradationRouter: score a clip's degradations and choose its plan.

Counterpart of video_enhancer_tpu/analysis/router.py. A plan is a dict with
``degradations``, ``content_analysis``, ``expert_routing``,
``processing_order``, ``confidence_score`` and ``analysis_time_sec``; the
decision tree, the plan and the fallback plan are the JAX package's, with
thresholds from the port's copy of the policy (config.py). Two entries:

- ``analyze_frames``: the router's work on frames already sampled (uint8
  ``(T, H, W, 3)``), with the scores computed on the card unless
  ``device="cpu"``; no OpenCV;
- ``analyze_and_route``: samples 12 frames of a file (io/video.py: raw
  AVI without OpenCV) and routes them, as the JAX entry of that name does.

On every call, as in the JAX router, ``face_prominence`` is the detector
chain's face-area ratio of the sampled frames (analysis/faces.py
``face_area_ratio``, on the same device), best effort: a failure there
gives 0.0. The face expert is asked for when ``enable_face_expert`` is
true and the prominence is above the policy's threshold; left at None,
``enable_face_expert`` is the policy's default and the chain's validity
report clearing its floor (``face_chain_trusted``). A failure anywhere
else in routing returns the fallback plan (``"fallback": True``), as in
the JAX package.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from ..config import LatencyClass, Policy, default_policy
from ..device import resolve_device
from ..ops.degradation import degradation_scores
from ..utils.perf import get_tracker
from .faces import face_area_ratio, face_chain_trusted

log = logging.getLogger(__name__)

__all__ = ["DegradationRouter"]


def _detect_faces_ratio(frames, device: torch.device) -> float:
    """Face prominence of the sampled frames; 0.0 when detection fails."""
    try:
        return face_area_ratio(frames, device=device)
    except Exception:
        log.warning("face detection failed; face_prominence 0.0",
                    exc_info=True)
        return 0.0


class DegradationRouter:
    def __init__(self, policy: Policy | None = None,
                 available_models: set[str] | None = None):
        self.policy = policy or default_policy()
        if available_models is None:
            from ..runtime.qualification import disqualified_models

            available_models = (set(self.policy.enabled_models())
                                - disqualified_models())
        self.available = available_models

    # -- public API --------------------------------------------------------
    def analyze_frames(self, frames, fps: float = 30.0,
                       frame_count: int | None = None,
                       latency_class: str | LatencyClass =
                       LatencyClass.STANDARD,
                       allow_diffusion: bool = True,
                       allow_zero_shot: bool = True,
                       enable_face_expert: bool | None = None,
                       enable_hfr: bool | None = None,
                       device: str | torch.device | None = None
                       ) -> dict[str, Any]:
        """Route sampled uint8 frames ``(T, H, W, 3)`` (numpy or a tensor)
        of a video of ``frame_count`` frames at ``fps``."""
        t0 = time.time()
        try:
            return self._route(frames, fps, frame_count, latency_class,
                               allow_diffusion, allow_zero_shot,
                               enable_face_expert, enable_hfr, device, t0)
        except Exception as e:  # routing never stops the pipeline
            log.warning("routing failed; fallback plan", exc_info=True)
            return self._fallback_plan(str(e))

    def analyze_and_route(self, video_path,
                          latency_class: str | LatencyClass =
                          LatencyClass.STANDARD,
                          allow_diffusion: bool = True,
                          allow_zero_shot: bool = True,
                             enable_face_expert: bool | None = None,
                          enable_hfr: bool | None = None,
                          num_samples: int = 12,
                          device: str | torch.device | None = None
                          ) -> dict[str, Any]:
        """Sample ``num_samples`` frames of a file (io/video.py) and route
        them."""
        from ..io.video import get_video_metadata, sample_frames

        tracker = get_tracker()
        op = tracker.start_operation("analysis", "router", path=str(video_path))
        t0 = time.time()
        try:
            meta = get_video_metadata(video_path)
            frames = sample_frames(video_path, num_samples=num_samples)
            plan = self._route(frames, meta.fps, meta.frame_count,
                               latency_class, allow_diffusion,
                               allow_zero_shot, enable_face_expert,
                               enable_hfr, device, t0)
        except Exception as e:  # routing never stops the pipeline
            log.warning("routing failed; fallback plan", exc_info=True)
            tracker.finish_operation(op, success=False, error=str(e))
            return self._fallback_plan(str(e))
        tracker.finish_operation(op, success=True)
        return plan

    # -- internals ---------------------------------------------------------
    def _route(self, frames, fps, frame_count, latency_class,
               allow_diffusion, allow_zero_shot, enable_face_expert,
               enable_hfr, device, t0) -> dict[str, Any]:
        lc = (LatencyClass(latency_class) if isinstance(latency_class, str)
              else latency_class)
        defaults = self.policy.defaults
        if enable_face_expert is None:
            enable_face_expert = (defaults.enable_face_expert
                                  and face_chain_trusted())
        if enable_hfr is None:
            enable_hfr = defaults.enable_hfr

        if torch.is_tensor(frames):
            clip = frames.to(resolve_device(device) if device is not None
                             else frames.device)
        else:
            clip = torch.from_numpy(np.asarray(frames)).to(
                resolve_device(device))
        face_ratio = _detect_faces_ratio(frames, clip.device)
        clip = clip.float() / 255.0
        scores = {k: float(v) for k, v in degradation_scores(clip).items()}
        n_frames = clip.shape[0] if frame_count is None else frame_count

        degradations = {
            "compression": scores["compression"],
            "motion_blur": scores["motion_blur"],
            "low_light": scores["low_light"],
            "noise": scores["noise"],
            "temporal_inconsistency": scores["temporal_inconsistency"],
            "unknown": self._unknown_score(scores),
        }
        content = {
            "face_prominence": face_ratio,
            "scene_change_ratio": scores["scene_change_ratio"],
            "motion_complexity": scores["motion_complexity"],
            "brightness": scores["brightness"],
            "contrast": scores["contrast"],
            "resolution": [int(clip.shape[1]), int(clip.shape[2])],
            "frame_count": int(n_frames),
            "fps": float(fps),
        }
        primary = self._select_model(degradations, content, lc,
                                     allow_diffusion, allow_zero_shot)
        plan = self._build_plan(primary, degradations, content, lc,
                                enable_face_expert, enable_hfr)
        plan["confidence_score"] = self._confidence(degradations, content)
        plan["analysis_time_sec"] = time.time() - t0
        return plan

    def _unknown_score(self, scores: dict) -> float:
        """High when no single degradation dominates but quality is bad."""
        known = [scores["compression"], scores["motion_blur"],
                 scores["noise"], scores["low_light"]]
        overall = max(scores["temporal_inconsistency"], np.mean(known))
        dominance = max(known) - np.mean(known)
        return float(np.clip(overall - dominance, 0.0, 1.0))

    def _select_model(self, deg, content, lc, allow_diffusion,
                      allow_zero_shot):
        """The JAX package's decision tree (router.py:143-171)."""
        thr = self.policy.thresholds

        def ok(name):
            return name in self.available

        if lc == LatencyClass.STRICT and ok("fast_mamba_vsr"):
            return "fast_mamba_vsr"
        if (deg["unknown"] > thr.unknown_degradation and allow_zero_shot
                and ok("ditvr")):
            return "ditvr"
        if ((deg["compression"] > thr.compression
             or deg["motion_blur"] > thr.motion_blur + 0.1)
                and allow_diffusion and ok("seedvr2")):
            return "seedvr2"
        if content["motion_complexity"] > thr.motion_complexity and ok("vsrm"):
            return "vsrm"
        chain = (("fast_mamba_vsr", "realesrgan_fast", "realesrgan",
                  "cnn_upscaler", "bicubic")
                 if lc == LatencyClass.STRICT else
                 ("vsrm", "fast_mamba_vsr", "realesrgan", "cnn_upscaler",
                  "bicubic"))
        for cand in chain:
            if ok(cand):
                return cand
        return "bicubic"

    def _build_plan(self, primary, deg, content, lc, face, hfr):
        thr = self.policy.thresholds
        entry = self.policy.models.get(primary)
        budget = self.policy.budget(lc)

        experts = {
            "denoise": deg["noise"] > thr.noise,
            "compression_cleanup": deg["compression"] > thr.compression,
            "low_light": deg["low_light"] > thr.low_light,
            "face_restoration": bool(
                face and content["face_prominence"] > thr.face_prominence),
            "temporal_smoothing": deg["temporal_inconsistency"] > 0.5,
            "hfr_interpolation": bool(hfr),
        }

        # cleanup -> primary model -> face -> temporal consistency -> hfr
        order = []
        if experts["denoise"] or experts["compression_cleanup"] \
                or experts["low_light"]:
            order.append("preprocessing")
        order.append(f"sota_{primary}")
        if experts["face_restoration"]:
            order.append("face_restoration")
        if experts["temporal_smoothing"]:
            order.append("temporal_consistency")
        if experts["hfr_interpolation"]:
            order.append("hfr_interpolation")

        return {
            "degradations": deg,
            "content_analysis": content,
            "expert_routing": {
                "primary_model": primary,
                "model_config": {
                    "window": entry.window if entry else 8,
                    "stride": entry.stride if entry else 6,
                    "tile": entry.tile if entry else 512,
                    "tile_overlap": entry.tile_overlap if entry else 32,
                    "scale": entry.scale if entry else 2,
                },
                "experts": experts,
                "latency_class": lc.value,
                "budget": {
                    "max_ms_per_frame": budget.max_ms_per_frame,
                    "max_memory_gb": budget.max_memory_gb,
                },
            },
            "processing_order": order,
        }

    def _confidence(self, deg, content) -> float:
        """High when the scores are decisive."""
        known = [deg["compression"], deg["motion_blur"], deg["noise"],
                 deg["low_light"]]
        spread = max(known) - min(known)
        frames_factor = min(content["frame_count"] / 24.0, 1.0)
        return float(np.clip(0.5 + 0.4 * spread + 0.1 * frames_factor,
                             0.0, 1.0))

    def _fallback_plan(self, error: str) -> dict:
        """The safe plan of a routing failure (router.py:234-252)."""
        return {
            "degradations": {k: 0.0 for k in
                             ("compression", "motion_blur", "low_light",
                              "noise", "temporal_inconsistency", "unknown")},
            "content_analysis": {"error": error},
            "expert_routing": {
                "primary_model": "cnn_upscaler"
                if "cnn_upscaler" in self.available else "bicubic",
                "model_config": {"window": 8, "stride": 8, "tile": 512,
                                 "tile_overlap": 32, "scale": 2},
                "experts": {},
                "latency_class": LatencyClass.STANDARD.value,
            },
            "processing_order": ["sota_cnn_upscaler"],
            "confidence_score": 0.0,
            "fallback": True,
        }
