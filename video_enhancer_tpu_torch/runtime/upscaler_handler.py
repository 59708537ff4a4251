"""Handler of the basic path: the CNN 2x upscaler, or plain bicubic.

Counterpart of video_enhancer_tpu/runtime/upscaler_handler.py, with the
CNN at its default architecture (models/upscaler.py). Frames go through in
batches of ``batch_size`` (8 by default; the last batch padded by
repeating its last frame; only its real frames come out). The CNN runs in
``dtype`` (bf16 by default) behind the calibrated blend toward bicubic
(s = 0.7); bicubic runs in fp32. The methods follow the port's VSRHandler:
``process_frames`` takes a float batch ``(B, H, W, 3)`` on the handler's
device (the JAX handler's ``enhance_frames``), ``enhance_frames`` is the
streaming loop over uint8 frames, ``enhance_video`` goes file to file.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..io.pipeline import iter_windows
from ..models import upscaler
from .calibration import calibrate_vsr
from .vsr_handler import cast_params
from .weights import try_load_params
from ..utils.perf import track_enhancement_performance

__all__ = ["CnnUpscalerHandler"]

_BATCH = 8


class CnnUpscalerHandler:
    def __init__(self, scale: int = 2, use_cnn: bool = True,
                 weights_path=None, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.name = "cnn_upscaler" if use_cnn else "bicubic"
        self.scale = scale
        self.device = resolve_device(device)
        self.context: dict = {}       # no per-video conditioning
        if use_cnn:
            params = upscaler.init(torch.Generator().manual_seed(0),
                                   scale=scale)
            if weights_path:   # a checkpoint that does not load keeps init
                params = try_load_params(weights_path, params) or params
            self.dtype = dtype
            self.params = cast_params(params, dtype, self.device)
            self._apply = calibrate_vsr(
                "cnn_upscaler",
                lambda p, x: upscaler.apply(p, x, scale=scale))
        else:
            self.dtype = torch.float32
            self.params = None
            self._apply = lambda p, x: upscaler.bicubic_upscale(x, scale)

    @torch.inference_mode()
    def process_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` float32 in [0, 1] on the handler's device ->
        ``(B, sH, sW, 3)`` float32."""
        return self._apply(self.params, frames.to(self.dtype)).float()

    def enhance_frames(self, frames: Iterable[np.ndarray],
                       batch_size: int = _BATCH) -> Iterator[np.ndarray]:
        """uint8 ``(H, W, 3)`` frames in, upscaled uint8 frames out, one
        per input frame, in order, ``batch_size`` frames a forward."""
        for win in iter_windows(frames, batch_size, batch_size):
            batch = torch.from_numpy(win.frames).to(self.device).float() / 255.0
            out = self.process_frames(batch)[:win.valid]
            u8 = torch.clamp(torch.round(out * 255.0), 0, 255)
            yield from u8.to(torch.uint8).cpu().numpy()

    @track_enhancement_performance("cnn_upscaler")
    def enhance_video(self, input_path, output_path,
                      batch_size: int = _BATCH) -> dict:
        """File to file through ``enhance_frames`` (io/video.py)."""
        from ..io.video import get_video_metadata, read_frames, write_frames

        t0 = time.time()
        meta = get_video_metadata(input_path)
        out_hw = (meta.height * self.scale, meta.width * self.scale)
        n = write_frames(output_path,
                         self.enhance_frames(read_frames(input_path),
                                             batch_size),
                         out_hw, fps=meta.fps)
        dt = time.time() - t0
        return {"status": "success", "model": self.name,
                "frames_processed": n, "processing_time_sec": dt,
                "fps": n / dt if dt > 0 else 0.0,
                "input_resolution": [meta.height, meta.width],
                "output_resolution": list(out_hw), "scale": self.scale,
                "output_path": str(output_path)}

