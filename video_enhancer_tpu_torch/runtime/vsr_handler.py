"""Streaming VSR handler: temporal windows and spatial tiles around a clip
model ``(B, T, H, W, 3) -> (B, T, sH, sW, 3)``.

Counterpart of video_enhancer_tpu/runtime/vsr_handler.py:35-247:

- windows of ``chunk`` frames overlapping by ``overlap``; overlap frames are
  written from the later window (its fresh temporal context) and a padded
  tail writes only its real frames;
- frames larger than ``tile`` are cut into overlapping tiles, run in groups
  of 4 (the last group padded by repeating its last tile) and blended back
  with ramp weights (ops/blend.py);
- with a ``mesh`` of more than one rank (parallel/mesh.py), a window whose
  T and H split over the mesh runs sharded instead
  (parallel/inference.py ``make_mesh_sharded_clip_fn``: frame halos of
  ``max(overlap, 1)``, row halos of 8), on every rank of the mesh;
- the quality gate of scale-1 models (seedvr2): with ``quality_threshold``
  set, a window whose middle frame's sharpness (``window_quality``) is above
  it passes through unchanged, its uint8 frames out and no forward run, and
  counts in ``windows_skipped``; a model of another scale warns and ignores
  the threshold (``gating_supported``);
- parameters are cast to the compute dtype (bf16 by default) once;
- ``context`` holds per-video conditioning (ditvr's degradation scores and
  type) as tensors on the handler's device, passed to the model as keyword
  arguments on every forward, tiles and shards included;
  ``update_context`` changes it between videos.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..io.pipeline import iter_windows
from ..ops.blend import overlap_add_blend
from ..ops.color import rgb_to_gray
from ..ops.imgproc import laplacian
from ..parallel.inference import make_mesh_sharded_clip_fn

__all__ = ["VSRHandler", "cast_params", "window_quality"]

log = logging.getLogger(__name__)

_TILE_GROUP = 4


def cast_params(params, dtype, device):
    """Floating-point leaves to ``dtype`` on ``device``; others moved."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype, device) for v in params]
    if params.is_floating_point():
        return params.to(device=device, dtype=dtype)
    return params.to(device)


def window_quality(frames_u8: torch.Tensor) -> float:
    """The JAX handler's sharpness of a window (vsr_handler.py:162-172),
    without OpenCV: its middle frame as the JAX handler sees it (uint8 over
    255 in fp32, times 255, truncated to uint8), ``rgb_to_gray``, cv2's
    ``ksize=1`` Laplacian with reflect-101 borders in fp32, its variance
    (ddof 0) over 500, capped at 1. ``frames_u8``: ``(T, H, W, 3)`` uint8
    on any device."""
    mid = frames_u8[frames_u8.shape[0] // 2]
    gray = rgb_to_gray((mid.float() / 255.0 * 255.0).to(torch.uint8))
    var = laplacian(gray.float()).double().var(correction=0).item()
    return min(var / 500.0, 1.0)


class VSRHandler:
    """Wraps a clip model with windowed, tiled video processing."""

    def __init__(self, name: str, apply_fn: Callable, params, scale: int = 4,
                 chunk: int = 8, overlap: int = 2, tile: int = 512,
                 tile_overlap: int = 32, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 context: dict | None = None,
                 quality_threshold: float | None = None, mesh=None):
        self.name = name
        self.apply_fn = apply_fn
        self.scale = scale
        self.chunk = chunk
        self.overlap = overlap
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.dtype = dtype
        self.gating_supported = scale == 1
        self.quality_threshold = quality_threshold if scale == 1 else None
        if quality_threshold is not None and not self.gating_supported:
            log.warning("%s: quality_threshold ignored (scale=%d model; "
                        "gating is restoration-only)", name, scale)
        self.device = resolve_device(device)
        self.params = cast_params(params, dtype, self.device)
        self.context = {k: torch.as_tensor(v).to(self.device)
                        for k, v in (context or {}).items()}
        self.mesh = mesh
        self._sharded = None
        if mesh is not None and mesh.num_devices > 1:
            self._sharded = make_mesh_sharded_clip_fn(
                lambda _, x: self._fwd(x), mesh, halo_t=max(overlap, 1),
                halo_s=8, scale=scale)

    def update_context(self, **kw) -> None:
        """Set context entries the handler has, keeping each one's dtype
        and shape."""
        for k, v in kw.items():
            if k in self.context:
                old = self.context[k]
                self.context[k] = torch.as_tensor(
                    v, dtype=old.dtype).to(self.device).reshape(old.shape)

    @torch.inference_mode()
    def _fwd(self, clips: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.params, clips.to(self.dtype),
                             **self.context).float()

    def process_clip(self, clip: torch.Tensor) -> torch.Tensor:
        """``(T, H, W, 3)`` float32 on the handler's device -> ``(T, sH, sW,
        3)`` float32: sharded over the mesh when T and H split over it (as
        the JAX handler decides), else whole, or tiled when the frame is
        larger than ``tile``."""
        t, h, w, _ = clip.shape
        if self._sharded is not None:
            n_t, n_s = self.mesh.shape["time"], self.mesh.shape["space"]
            divisible = (t % n_t == 0 and h % n_s == 0
                         and (n_t == 1 or t // n_t >= max(self.overlap, 1))
                         and (n_s == 1 or h // n_s >= 8))
            if divisible:
                with torch.inference_mode():
                    return self._sharded(self.params, clip[None])[0]
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

    def enhance_frames(self, frames: Iterable[np.ndarray],
                       stats: dict | None = None) -> Iterator[np.ndarray]:
        """The streaming loop: uint8 ``(H, W, 3)`` frames in, upscaled uint8
        frames out, one per input frame, in order. ``stats``, when given,
        gets ``windows_skipped``: the windows the quality gate passed
        through."""
        stride = self.chunk - self.overlap
        skipped = 0
        for win in iter_windows(frames, self.chunk, stride):
            u8 = torch.from_numpy(win.frames).to(self.device)
            if (self.quality_threshold is not None
                    and window_quality(u8) > self.quality_threshold):
                skipped += 1                      # already sharp: unchanged
            else:
                out = self.process_clip(u8.float() / 255.0)
                u8 = torch.clamp(torch.round(out * 255.0), 0, 255).to(
                    torch.uint8)
            begin = self.overlap if win.start > 0 else 0
            end = min(win.valid, self.chunk)
            if begin < end:
                yield from u8[begin:end].cpu().numpy()
        if stats is not None:
            stats["windows_skipped"] = skipped

    def enhance_video(self, input_path, output_path) -> dict:
        """File to file through ``enhance_frames`` (OpenCV IO)."""
        from ..io.video import get_video_metadata, read_frames, write_frames

        t0 = time.time()
        meta = get_video_metadata(input_path)
        s = self.scale
        out_hw = (meta.height * s, meta.width * s)
        counts = {"windows_skipped": 0}
        n = write_frames(output_path,
                         self.enhance_frames(read_frames(input_path), counts),
                         out_hw, fps=meta.fps)
        dt = time.time() - t0
        return {"status": "success", "model": self.name,
                "frames_processed": n, "processing_time_sec": dt,
                "fps": n / dt if dt > 0 else 0.0,
                "input_resolution": [meta.height, meta.width],
                "output_resolution": list(out_hw), "scale": s,
                "chunk": self.chunk, **counts, "overlap": self.overlap,
                "output_path": str(output_path)}
