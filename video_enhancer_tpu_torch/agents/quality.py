"""QualityAssessmentAgent: quality metrics of an output clip against its
reference, on the agent's device.

Counterpart of video_enhancer_tpu/agents/quality.py: PSNR, SSIM, MSE, MAE,
temporal consistency, flicker, detail preservation and artifact score
(high-frequency energy against a half-size linear round trip, the
``jax.image.resize`` "linear" of ``ops/resize.image_resize``), colour
accuracy, the perceptual distance, the category table, the weighted
overall score and the reprocess decision against the policy's quality
gates. The perceptual distance is the calibrated proxy
(train/lpips.py, the bundled ``lpips_proxy.npz``), else the JAX
package's fixed random-feature distance (``jax.random.normal(PRNGKey(42),
(3, 3, 3, 16)) * 0.2`` drawn by ``ops/prng.py``, stride-2 VALID convs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.conv import conv2d
from ..ops.prng import normal
from ..ops.resize import image_resize, resize
from ..train.lpips import load_proxy, lpips_distance
from ..utils.metrics import psnr, ssim
from .base import AgentCapabilities, BaseAgent, ProcessingResult
from .task_spec import TaskSpecification, TaskType

__all__ = ["QualityAssessmentAgent", "assess_clips"]

# excellent/good/acceptable/poor thresholds (min PSNR, min SSIM)
CATEGORIES = (
    ("excellent", 35.0, 0.95),
    ("good", 30.0, 0.90),
    ("acceptable", 25.0, 0.80),
    ("poor", 20.0, 0.70),
)

_PROXY: dict = {}                  # device -> proxy layers, or None


def _calibrated(device: torch.device):
    key = str(device)
    if key not in _PROXY:
        _PROXY[key] = load_proxy(device)
    return _PROXY[key]


def _perceptual_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The calibrated feature-net distance; the random-projection one when
    the bundled weights are absent."""
    params = _calibrated(a.device)
    if params is not None:
        return torch.mean(lpips_distance(params, a, b))
    w = (normal(42, (3, 3, 3, 16)) * 0.2).permute(3, 2, 0, 1).to(a.device)
    fa, fb = (conv2d(x, w, stride=2, padding=((0, 0), (0, 0)))
              for x in (a, b))
    return torch.mean(torch.abs(fa - fb))


def _hf(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    blur = image_resize(image_resize(x, (h // 2, w // 2)), (h, w))
    return torch.mean(torch.abs(x - blur))


@torch.inference_mode()
def assess_clips(out_clip: torch.Tensor, ref_clip: torch.Tensor) -> dict:
    """The full metric set over (T, H, W, 3) fp32 clips in [0, 1]: 0-d
    tensors on the clips' device."""
    out_clip, ref_clip = out_clip.float(), ref_clip.float()
    zero = torch.zeros((), device=out_clip.device)
    diff = out_clip - ref_clip
    lum = torch.mean(out_clip, dim=(1, 2, 3))
    multi = out_clip.shape[0] > 1
    flicker = (torch.std(lum[1:] - lum[:-1], unbiased=False) if multi
               else zero)
    hf_out, hf_ref = _hf(out_clip), _hf(ref_clip)
    detail = torch.clamp(hf_out / torch.clamp(hf_ref, min=1e-6), 0.0, 2.0)
    artifact = torch.clamp(hf_out - hf_ref, 0.0, 1.0) * 10.0
    color = 1.0 - torch.clamp(
        torch.mean(torch.abs(torch.mean(out_clip, dim=(0, 1, 2))
                             - torch.mean(ref_clip, dim=(0, 1, 2)))) * 5.0,
        0.0, 1.0)
    tc = 1.0 - (torch.mean(torch.abs(out_clip[1:] - out_clip[:-1]))
                if multi else zero)
    return {
        "psnr": psnr(out_clip, ref_clip),
        "ssim": ssim(out_clip, ref_clip),
        "mse": torch.mean(diff * diff),
        "mae": torch.mean(torch.abs(diff)),
        "lpips_proxy": _perceptual_distance(out_clip, ref_clip),
        "temporal_consistency": tc,
        "flicker": flicker,
        "detail_preservation": detail,
        "artifact_score": artifact,
        "color_accuracy": color,
    }


class QualityAssessmentAgent(BaseAgent):
    def __init__(self, agent_id: str = "quality_assessor", policy=None,
                 device: str | torch.device | None = None):
        super().__init__(
            agent_id,
            AgentCapabilities(task_types={TaskType.QUALITY_ASSESSMENT},
                              max_concurrent_tasks=4),
        )
        from ..config import default_policy

        self.policy = policy or default_policy()
        self.device = resolve_device(device)

    def _clip(self, path) -> torch.Tensor:
        from ..io.video import read_video

        return (torch.from_numpy(read_video(path)).to(self.device).float()
                / 255.0)

    def _execute(self, task: TaskSpecification) -> ProcessingResult:
        out, ref = self._clip(task.output_path), self._clip(task.input_path)
        n = min(out.shape[0], ref.shape[0])
        out, ref = out[:n], ref[:n]
        if out.shape[1:3] != ref.shape[1:3]:
            ref = resize(ref, tuple(out.shape[1:3]))
        metrics = {k: float(v) for k, v in assess_clips(out, ref).items()}
        metrics["category"] = self.categorize(metrics)
        metrics["overall_score"] = self.overall_score(metrics)
        metrics.update(self.reprocess_decision(metrics))
        return ProcessingResult(task_id=task.task_id, status="success",
                                metrics=metrics)

    @staticmethod
    def categorize(m: dict) -> str:
        for name, min_psnr, min_ssim in CATEGORIES:
            if m["psnr"] >= min_psnr and m["ssim"] >= min_ssim:
                return name
        return "unacceptable"

    @staticmethod
    def overall_score(m: dict) -> float:
        """Weighted 0..1."""
        psnr_n = min(max(m["psnr"] - 20.0, 0.0) / 20.0, 1.0)
        return float(np.clip(
            0.3 * psnr_n + 0.3 * m["ssim"]
            + 0.2 * m["temporal_consistency"]
            + 0.1 * min(m["detail_preservation"], 1.0)
            + 0.1 * m["color_accuracy"],
            0.0, 1.0,
        ))

    def reprocess_decision(self, m: dict) -> dict:
        """The policy's quality gates and the escalation advice."""
        gates = self.policy.quality_gates
        failed = []
        if m["psnr"] < gates.min_psnr:
            failed.append(f"psnr {m['psnr']:.1f} < {gates.min_psnr}")
        if m["ssim"] < gates.min_ssim:
            failed.append(f"ssim {m['ssim']:.2f} < {gates.min_ssim}")
        recs = []
        if failed and gates.escalate_on_failure:
            recs.append("escalate to a higher-quality model (vsrm/seedvr2)")
        if m["flicker"] > 0.05:
            recs.append("enable temporal smoothing")
        if m["artifact_score"] > 0.5:
            recs.append("reduce sharpening / enable compression cleanup")
        return {
            "gates_failed": failed,
            "needs_reprocessing": bool(failed),
            "recommendations": recs,
        }
