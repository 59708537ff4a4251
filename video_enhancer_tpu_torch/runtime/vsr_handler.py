"""Streaming VSR handler: temporal windows and spatial tiles around a clip
model ``(B, T, H, W, 3) -> (B, T, sH, sW, 3)``.

Counterpart of video_enhancer_tpu/runtime/vsr_handler.py:35-247 without its
mesh and quality-gate options (neither is used by the x4 models):

- windows of ``chunk`` frames overlapping by ``overlap``; overlap frames are
  written from the later window (its fresh temporal context) and a padded
  tail writes only its real frames;
- frames larger than ``tile`` are cut into overlapping tiles, run in groups
  of 4 (the last group padded by repeating its last tile) and blended back
  with ramp weights (ops/blend.py);
- parameters are cast to the compute dtype (bf16 by default) once.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..io.pipeline import iter_windows
from ..ops.blend import overlap_add_blend

__all__ = ["VSRHandler"]

_TILE_GROUP = 4


def _cast(params, dtype, device):
    if isinstance(params, dict):
        return {k: _cast(v, dtype, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_cast(v, dtype, device) for v in params]
    if params.is_floating_point():
        return params.to(device=device, dtype=dtype)
    return params.to(device)


class VSRHandler:
    """Wraps a clip model with windowed, tiled video processing."""

    def __init__(self, name: str, apply_fn: Callable, params, scale: int = 4,
                 chunk: int = 8, overlap: int = 2, tile: int = 512,
                 tile_overlap: int = 32, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None):
        self.name = name
        self.apply_fn = apply_fn
        self.scale = scale
        self.chunk = chunk
        self.overlap = overlap
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = _cast(params, dtype, self.device)

    @torch.inference_mode()
    def _fwd(self, clips: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.params, clips.to(self.dtype)).float()

    def process_clip(self, clip: torch.Tensor) -> torch.Tensor:
        """``(T, H, W, 3)`` float32 on the handler's device -> ``(T, sH, sW,
        3)`` float32, tiling when the frame is larger than ``tile``."""
        t, h, w, _ = clip.shape
        if max(h, w) <= self.tile:
            return self._fwd(clip[None])[0]
        return self._tiled(clip)

    def _tiled(self, clip: torch.Tensor) -> torch.Tensor:
        t, h, w, _ = clip.shape
        ts, ov, s = self.tile, self.tile_overlap, self.scale
        step = ts - ov
        ys = sorted({min(y, max(h - ts, 0))
                     for y in range(0, max(h - ov, 1), step)})
        xs = sorted({min(x, max(w - ts, 0))
                     for x in range(0, max(w - ov, 1), step)})
        tiles, origins = [], []
        for y in ys:
            for x in xs:
                tiles.append(clip[:, y:y + ts, x:x + ts, :])
                origins.append((y * s, x * s))
        outs = []
        for i in range(0, len(tiles), _TILE_GROUP):
            batch = tiles[i:i + _TILE_GROUP]
            n_valid = len(batch)
            if len(tiles) > _TILE_GROUP:
                batch = batch + [batch[-1]] * (_TILE_GROUP - n_valid)
            outs.append(self._fwd(torch.stack(batch))[:n_valid])
        stacked = torch.cat(outs, dim=0)              # (N, T, sts, sts, 3)
        return overlap_add_blend(stacked, origins, (h * s, w * s), ov * s)

    def enhance_frames(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """The streaming loop: uint8 ``(H, W, 3)`` frames in, upscaled uint8
        frames out, one per input frame, in order."""
        stride = self.chunk - self.overlap
        for win in iter_windows(frames, self.chunk, stride):
            clip = torch.from_numpy(win.frames).to(self.device).float() / 255.0
            out = self.process_clip(clip)
            begin = self.overlap if win.start > 0 else 0
            end = min(win.valid, self.chunk)
            if begin >= end:
                continue
            u8 = torch.clamp(torch.round(out[begin:end] * 255.0), 0, 255)
            yield from u8.to(torch.uint8).cpu().numpy()

    def enhance_video(self, input_path, output_path) -> dict:
        """File to file through ``enhance_frames`` (OpenCV IO)."""
        from ..io.video import get_video_metadata, read_frames, write_frames

        t0 = time.time()
        meta = get_video_metadata(input_path)
        s = self.scale
        out_hw = (meta.height * s, meta.width * s)
        n = write_frames(output_path, self.enhance_frames(read_frames(input_path)),
                         out_hw, fps=meta.fps)
        dt = time.time() - t0
        return {"status": "success", "model": self.name,
                "frames_processed": n, "processing_time_sec": dt,
                "fps": n / dt if dt > 0 else 0.0,
                "input_resolution": [meta.height, meta.width],
                "output_resolution": list(out_hw), "scale": s,
                "chunk": self.chunk, "overlap": self.overlap,
                "output_path": str(output_path)}
