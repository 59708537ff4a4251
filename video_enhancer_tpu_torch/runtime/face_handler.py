"""The face-restoration expert: find faces, score them, restore the poor
ones and blend them back.

Counterpart of video_enhancer_tpu/runtime/face_handler.py, on the
expert's device (the card unless ``device="cpu"``):

- detection is the chain of analysis/faces.py, then IoU deduplication (a
  box is kept when its IoU with every kept box is below 0.5);
- ``face_quality``: 0.4 sharpness (the Laplacian's variance over 500) +
  0.3 contrast (the gray's std over 64) + 0.2 exposure + 0.1 noise (the
  mean gap to a 5x5 Gaussian blur of sigma 1.5, over 16), each capped, on
  cv2's gray (ops/color.py), its Laplacian (ops/imgproc.py) and its blur
  (ops/optflow.py ``gaussian_blur``); statistics in fp64 where the JAX
  package takes numpy's fp32 ones;
- ``restore_face``: the box grown by 20% a side and clamped to the frame,
  its crop over 255 resized to 128x128 (ops/resize.py linear, antialiased
  as the JAX package's ``resize`` is by default), the restorer net, resized
  back, blended under a feathered ellipse of strength ``blend``, rounded
  (halves to even) into a copy of the frame;
- the restorer: a small encoder-decoder with a zero-initialised residual
  head, weights from ``weights_path``, else the bundled
  ``face_restorer.npz``, else a seeded init. A GFPGANv1Clean checkpoint
  (``gfpgan_ckpt`` or ``$VETPU_GFPGAN_CKPT``; a ``.pth`` or a ``.npz`` of
  models/official_gfpgan.py's tree) replaces it: the crop at the net's
  native size in [-1, 1], its output mapped back to [0, 1] and clamped.
  ``gfpgan_config`` is the model's configuration (default the v1.4
  release: ``out_size`` 512, ``input_is_latent``);
- ``process_video_selective`` (file to file) and
  ``process_frames_selective`` (frames in memory, the counterpart of the
  file entry for ``run_auto_frames``): detect on at most
  ``max_analysis_frames`` frames spread over the clip, give every frame the
  boxes of its nearest sample (ties to the lower index), restore each box
  whose crop scores below the strategy's threshold, into one copy of its
  frame (each later box scored on it, as the JAX expert's copies chain).

Every net runs in fp32 with TF32 off (``device.full_fp32``), as the JAX
package's do. Each scored box and each restored box costs the host a copy
back.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..analysis import faces
from ..device import full_fp32, resolve_device
from ..models.official_gfpgan import (gfpgan_official_apply,
                                      gfpgan_official_init)
from ..ops.color import rgb_to_gray
from ..ops.imgproc import laplacian
from ..ops.optflow import gaussian_blur
from ..ops.resize import resize
from ..utils.perf import track_enhancement_performance
from .vsr_handler import cast_params
from .weights import try_load_params

__all__ = ["FaceRestorationExpert", "STRATEGIES", "FACE_SIZE", "BUNDLED"]

STRATEGIES = {
    # intensity: (quality_threshold, blend_strength)
    "conservative": (0.35, 0.4),
    "balanced": (0.5, 0.6),
    "aggressive": (0.7, 0.8),
}

FACE_SIZE = 128  # the restorer's input size
BUNDLED = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
           / "weights" / "face_restorer.npz")


def _face_net_init(gen: torch.Generator, dim: int = 32) -> dict:
    return {
        "e1": nn.conv2d_init(gen, 3, 3, 3, dim),
        "e2": nn.conv2d_init(gen, 3, 3, dim, dim * 2),
        "mid": nn.conv2d_init(gen, 3, 3, dim * 2, dim * 2),
        "d1": nn.conv2d_init(gen, 3, 3, dim * 2, dim),
        "d2": nn.conv2d_init(gen, 3, 3, dim, dim),
        "out": nn.conv2d_init(gen, 3, 3, dim, 3, zero=True),
    }


def _face_net_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, 128, 128, 3)`` -> restored, through the residual head."""
    e1 = F.silu(nn.conv2d_apply(p["e1"], x))
    e2 = F.silu(nn.conv2d_apply(p["e2"], e1, stride=2))
    m = F.silu(nn.conv2d_apply(p["mid"], e2)) + e2
    u = resize(m, (x.shape[1], x.shape[2]), method="linear")
    d1 = F.silu(nn.conv2d_apply(p["d1"], u)) + e1
    d2 = F.silu(nn.conv2d_apply(p["d2"], d1))
    return torch.clamp(x + nn.conv2d_apply(p["out"], d2), 0.0, 1.0)


def _iou(a, b) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    x1, y1 = max(ax, bx), max(ay, by)
    x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def _feather_mask(ch: int, cw: int, blend: float) -> np.ndarray:
    """The feathered elliptical mask ``(ch, cw, 1)`` in fp32, in the JAX
    package's order of operations."""
    yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    cy, cx = ch / 2.0, cw / 2.0
    d = ((yy - cy) / (ch / 2.0)) ** 2 + ((xx - cx) / (cw / 2.0)) ** 2
    return np.clip(1.2 - d, 0.0, 1.0)[..., None] * np.float32(blend)


class FaceRestorationExpert:
    def __init__(self, intensity: str = "balanced", seed: int = 0,
                 weights_path=None, gfpgan_ckpt=None,
                 gfpgan_config: dict | None = None,
                 device: str | torch.device | None = None):
        self.intensity = intensity
        self.device = resolve_device(device)
        params = _face_net_init(torch.Generator().manual_seed(seed))
        for cand in ([weights_path] if weights_path else []) + [BUNDLED]:
            if cand and Path(cand).exists():
                loaded = try_load_params(cand, params)
                if loaded is not None:
                    params = loaded
                    break
        self.params = cast_params(params, torch.float32, self.device)

        self.gfpgan_params = None
        cfg = dict(gfpgan_config or {})
        self._gfpgan_size = int(cfg.pop("out_size", 512))
        # different_w and sft_half shape the tree and the forward,
        # input_is_latent the forward alone
        self._gfpgan_kw = {"input_is_latent": cfg.pop("input_is_latent",
                                                      True)}
        for k in ("num_style_feat", "different_w", "sft_half"):
            if k in cfg:
                self._gfpgan_kw[k] = cfg[k]
        ckpt = gfpgan_ckpt or os.environ.get("VETPU_GFPGAN_CKPT")
        if ckpt and Path(ckpt).exists():
            template = gfpgan_official_init(
                torch.Generator().manual_seed(0),
                out_size=self._gfpgan_size, **cfg)
            loaded = try_load_params(ckpt, template)
            if loaded is not None:
                self.gfpgan_params = cast_params(loaded, torch.float32,
                                                 self.device)

    # -- detection and scoring ---------------------------------------------
    def detect_faces(self, frame) -> list[tuple[int, int, int, int]]:
        """The detector chain's boxes, deduplicated at IoU 0.5."""
        found: list[tuple] = []
        for f in faces.detect_faces(frame, self.device):
            if all(_iou(f, g) < 0.5 for g in found):
                found.append(f)
        return found

    def face_quality(self, face_img) -> float:
        """The 4-factor score of a uint8 RGB crop."""
        t = torch.as_tensor(face_img).to(self.device)
        gray = rgb_to_gray(t).float()
        blur = gaussian_blur(gray, 5, 1.5)
        g = gray.double()
        var, std, mean, gap = torch.stack([
            laplacian(gray).double().var(correction=0),
            g.std(correction=0), g.mean(),
            (gray - blur).abs().double().mean()]).tolist()
        sharp = min(var / 500.0, 1.0)
        contrast = min(std / 64.0, 1.0)
        exposure = 1.0 - abs(mean - 128.0) / 128.0
        noise = 1.0 - min(gap / 16.0, 1.0)
        return float(0.4 * sharp + 0.3 * contrast + 0.2 * exposure
                     + 0.1 * noise)

    # -- restoration -------------------------------------------------------
    def _restored(self, crop: torch.Tensor) -> torch.Tensor:
        """The net's restoration of an ``(h, w, 3)`` crop in [0, 1], at
        the net's size."""
        if self.gfpgan_params is not None:
            s = self._gfpgan_size
            inp = resize(crop, (s, s), method="linear") * 2.0 - 1.0
            out = gfpgan_official_apply(self.gfpgan_params, inp[None],
                                        **self._gfpgan_kw)[0]
            return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0)
        inp = resize(crop, (FACE_SIZE, FACE_SIZE), method="linear")
        return _face_net_apply(self.params, inp[None])[0]

    def restore_face(self, frame: np.ndarray, box,
                     blend: float) -> np.ndarray:
        """A copy of the uint8 frame with the box's face restored."""
        out = frame.copy()
        self._restore_into(out, box, blend)
        return out

    def _restore_into(self, frame: np.ndarray, box, blend: float) -> None:
        """``restore_face`` written into ``frame`` itself."""
        x, y, w, h = box
        mx, my = int(w * 0.2), int(h * 0.2)
        x0, y0 = max(x - mx, 0), max(y - my, 0)
        x1 = min(x + w + mx, frame.shape[1])
        y1 = min(y + h + my, frame.shape[0])
        crop = torch.from_numpy(np.ascontiguousarray(frame[y0:y1, x0:x1])
                                ).to(self.device).float() / 255.0
        ch, cw = crop.shape[:2]
        with torch.inference_mode(), full_fp32():
            restored = resize(self._restored(crop), (ch, cw),
                              method="linear")
            mask = torch.from_numpy(_feather_mask(ch, cw, blend)).to(
                self.device)
            blended = crop * (1 - mask) + restored * mask
            frame[y0:y1, x0:x1] = torch.clamp(
                torch.round(blended * 255.0), 0, 255).to(
                torch.uint8).cpu().numpy()

    # -- public API --------------------------------------------------------
    def _selective(self, frames: list, face_threshold: float | None,
                   max_analysis_frames: int) -> tuple[list, dict]:
        n = len(frames)
        q_thr, blend = STRATEGIES[self.intensity]
        if face_threshold is not None:
            q_thr = face_threshold
        sample_idx = np.unique(
            np.linspace(0, n - 1, min(n, max_analysis_frames)).astype(int))
        detections = {int(i): self.detect_faces(frames[i])
                      for i in sample_idx}
        faces_restored = 0
        out_frames = []
        sorted_idx = sorted(detections)
        for i in range(n):
            nearest = min(sorted_idx, key=lambda s: abs(s - i))
            frame, copied = frames[i], False
            for box in detections[nearest]:
                x, y, w, h = box
                crop = frame[y:y + h, x:x + w]
                if crop.size and self.face_quality(crop) < q_thr:
                    # one copy a frame, the later boxes scored and
                    # restored on it, as restore_face's copies chain
                    if not copied:
                        frame, copied = frame.copy(), True
                    self._restore_into(frame, box, blend)
                    faces_restored += 1
            out_frames.append(frame)
        return out_frames, {
            "status": "success", "model": "face_restoration",
            "frames_processed": int(n),
            "frames_analyzed": int(len(sample_idx)),
            "faces_restored": int(faces_restored),
            "intensity": self.intensity}

    def process_frames_selective(self, frames, face_threshold: float | None
                                 = None, max_analysis_frames: int = 50
                                 ) -> tuple[list[np.ndarray], dict]:
        """Uint8 RGB frames in memory -> the frames with their poor faces
        restored, and the stats of the file entry."""
        t0 = time.time()
        out, stats = self._selective([np.asarray(f) for f in frames],
                                     face_threshold, max_analysis_frames)
        stats["processing_time_sec"] = time.time() - t0
        return out, stats

    @track_enhancement_performance("face_restoration")
    def process_video_selective(self, input_path, output_path,
                                face_threshold: float | None = None,
                                max_analysis_frames: int = 50) -> dict:
        """File to file (io/video.py); ``output_path`` may
        be ``input_path``."""
        from ..io.video import get_video_metadata, read_frames, write_frames

        t0 = time.time()
        meta = get_video_metadata(input_path)
        out, stats = self._selective(list(read_frames(input_path)),
                                     face_threshold, max_analysis_frames)
        write_frames(output_path, out, (meta.height, meta.width),
                     fps=meta.fps)
        stats["processing_time_sec"] = time.time() - t0
        stats["output_path"] = str(output_path)
        return stats
