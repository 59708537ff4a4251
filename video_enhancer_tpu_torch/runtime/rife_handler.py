"""Frame-interpolation handler: RIFE midpoints, 2x a doubling.

Counterpart of video_enhancer_tpu/runtime/rife_handler.py:

- the weights: a released IFNet_HDv3 checkpoint (``official_ckpt``, else
  ``$VETPU_RIFE_CKPT``) loaded into the official graph at ``official_c``
  channels and served at full strength (:39-52, 71-77); else the internal
  RIFE from an explicit ``weights_path``, then the bundled ``rife.npz``,
  then the seeded init (:53-66), behind the calibrated blend toward the
  average of the two frames (``calibrate_interp``, s = 0.9);
- the parameters in bf16 on the handler's device (the card unless
  ``"cpu"`` is asked for), each pair cast to bf16 and its midpoint
  returned in fp32;
- ``_double`` (:128-160): T frames -> 2T - 1, a midpoint between each
  pair, one pair a call; ``multiscale`` (``quality="high"``) blends 0.75 of
  it with 0.25 of the midpoint of the half-size pair, both resized by
  ``jax.image.resize``'s linear rule (``ops.resize.image_resize``, as the
  JAX handler calls it, antialiased on the way down, not the package's
  ``ops.resize``). Any exception there falls back to the average of each
  pair, as the JAX handler and the reference do; here it is also logged
  with its traceback and counted in ``blend_fallbacks``;
- ``interpolate_frames`` (uint8 frames in memory) and ``interpolate_video``
  (file to file through OpenCV, :89-126): ``log2(factor)`` doublings
  (``target_fps`` sets the factor from the input's fps), rounded (halves to
  even) and clamped back to uint8. The JAX package's perf decorator has no
  counterpart; the call is timed in its stats.
"""

from __future__ import annotations

import logging
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import rife
from ..models.official_arch import ifnet_official_apply, ifnet_official_init
from ..ops.resize import image_resize
from .calibration import calibrate_interp
from .vsr_handler import cast_params
from .weights import try_load_params

log = logging.getLogger(__name__)

__all__ = ["RIFEHandler", "BUNDLED"]

BUNDLED = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
           / "weights" / "rife.npz")


class RIFEHandler:
    def __init__(self, dim: int = 32, levels: int = 3, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, weights_path=None,
                 official_ckpt=None, official_c: int = 90,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.blend_fallbacks = 0
        gen = torch.Generator().manual_seed(seed)
        params = None
        ckpt = official_ckpt or os.environ.get("VETPU_RIFE_CKPT")
        if ckpt and Path(ckpt).exists():
            params = try_load_params(ckpt, ifnet_official_init(gen,
                                                               c=official_c))
            if params is not None:
                self.meta = {"official": True, "weights": str(ckpt)}
                interp_fn = ifnet_official_apply
        if params is None:
            params = rife.init(gen, dim=dim, levels=levels)
            self.meta = {"dim": dim, "levels": levels}
            for cand in ([weights_path] if weights_path else []) + [BUNDLED]:
                loaded = try_load_params(cand, params)
                if loaded is not None:
                    params = loaded
                    self.meta["weights"] = str(cand)
                    break
            # the calibrated strength covers the bundled weights only
            interp_fn = calibrate_interp("rife", rife.interpolate_pair)
        self.params = cast_params(params, dtype, self.device)
        self._interp = interp_fn

    @torch.inference_mode()
    def _mid(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        """Midpoints of ``(B, H, W, 3)`` pairs, in fp32."""
        return self._interp(self.params, f0.to(self.dtype),
                            f1.to(self.dtype)).float()

    def interpolate_pair(self, f0: np.ndarray, f1: np.ndarray) -> np.ndarray:
        """The midpoint of two ``(H, W, 3)`` float frames in [0, 1]."""
        def dev(f):
            return torch.from_numpy(np.asarray(f, np.float32))[None].to(
                self.device)
        return self._mid(dev(f0), dev(f1))[0].cpu().numpy()

    def _double(self, clip: torch.Tensor,
                multiscale: bool = False) -> torch.Tensor:
        """``(T, H, W, 3)`` fp32 on the handler's device -> ``(2T - 1, H, W,
        3)``, the midpoints between the frames."""
        t, h, w = clip.shape[:3]
        if t < 2:
            return clip
        try:
            mids = []
            for i in range(t - 1):
                f0, f1 = clip[i:i + 1], clip[i + 1:i + 2]
                mid = self._mid(f0, f1)
                if multiscale:
                    h2, w2 = h // 2 * 2, w // 2 * 2

                    def small(z):
                        return image_resize(z[:, :h2, :w2], (h2 // 2, w2 // 2))
                    lo = image_resize(self._mid(small(f0), small(f1)), (h, w))
                    mid = 0.75 * mid + 0.25 * lo
                mids.append(mid[0])
            mids = torch.stack(mids)
        except Exception as e:  # the reference's blend fallback
            log.warning("RIFE failed (%s); blending each pair instead", e,
                        exc_info=True)
            self.blend_fallbacks += 1
            mids = 0.5 * clip[:-1] + 0.5 * clip[1:]
        out = clip.new_empty((2 * t - 1, h, w, clip.shape[3]))
        out[0::2] = clip
        out[1::2] = mids
        return out

    def interpolate_frames(self, frames_u8, factor: int = 2,
                           quality: str = "balanced") -> list[np.ndarray]:
        """uint8 ``(H, W, 3)`` frames -> the frames with ``log2(factor)``
        doublings (T -> 2T - 1 each), over 255 on the handler's device and
        rounded (halves to even) and clamped back to uint8."""
        clip = torch.from_numpy(np.stack(frames_u8)).to(self.device)
        clip = clip.float() / 255.0
        for _ in range(_doublings(factor)):
            clip = self._double(clip, multiscale=quality == "high")
        u8 = torch.clamp(torch.round(clip * 255.0), 0, 255).to(torch.uint8)
        return list(u8.cpu().numpy())

    def interpolate_video(self, input_path, output_path,
                          interpolation_factor: int = 2,
                          target_fps: float | None = None,
                          quality: str = "balanced") -> dict:
        """File to file through OpenCV: ``interpolate_frames`` at the factor
        (``target_fps / fps``, rounded, when ``target_fps`` is given),
        written at the input's fps times ``2 ** doublings``."""
        from ..io.video import get_video_metadata, read_frames, write_frames

        t0 = time.time()
        meta = get_video_metadata(input_path)
        if target_fps:
            interpolation_factor = max(
                int(round(target_fps / max(meta.fps, 1.0))), 1)
        frames = list(read_frames(input_path))
        levels = _doublings(interpolation_factor)
        out = self.interpolate_frames(frames, 2 ** levels, quality)
        out_fps = meta.fps * 2 ** levels
        write_frames(output_path, out, (meta.height, meta.width), fps=out_fps)
        return {"status": "success", "model": "rife",
                "frames_in": len(frames), "frames_processed": len(out),
                "input_fps": meta.fps, "output_fps": out_fps,
                "interpolation_factor": 2 ** levels,
                "blend_fallbacks": self.blend_fallbacks,
                "processing_time_sec": time.time() - t0,
                "output_path": str(output_path)}


def _doublings(factor: int) -> int:
    """The JAX handler's ``max(int(log2(max(factor, 1))), 0)``."""
    return max(int(math.log2(max(factor, 1))), 0)
