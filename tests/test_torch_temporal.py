"""The temporal-consistency post stage of the port (runtime/experts.py
``temporal_smooth``, wired into runtime/pipeline.py) against the JAX
package's, on the CPU.

Tolerances: the smoothed clip within 1 LSB (1/255) at most and 0.01 LSB on
average of the JAX package's (measured 0.02 and 3e-5): a frame value a
hair below k/255 on one side and at it on the other gives gray levels one
apart, and the flow moves a little there. The file stage against the JAX
package's on the same written file: a mean of 0.05 LSB and a max of 2 LSB
after both encode with OpenCV's codec (measured 0 and 0).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_enhancer_tpu.runtime import experts as jexperts
from video_enhancer_tpu.runtime import pipeline as jpipeline
from video_enhancer_tpu_torch.io.video import (get_video_metadata,
                                               read_frames, write_frames)
from video_enhancer_tpu_torch.runtime import pipeline as tpipeline
from video_enhancer_tpu_torch.runtime.experts import temporal_smooth

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import dim_clip  # noqa: E402


def _moving_clip(t=6, h=64, w=96, seed=0) -> np.ndarray:
    """Seeded colour waves moving 2.5 px right and 1.5 px up a frame, with
    fine noise, fp32 in [0, 1]."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = g.uniform(0, 2 * np.pi, 3)
    clip = np.stack([np.stack(
        [0.5 + 0.3 * np.sin(0.15 * (xx - 2.5 * i) + 0.1 * (yy + 1.5 * i)
                            + ph[c]) for c in range(3)], -1)
        for i in range(t)])
    clip = clip + g.normal(0, 0.02, clip.shape)
    return np.clip(clip, 0, 1).astype(np.float32)


def test_temporal_smooth_matches_jax():
    clip = _moving_clip()
    want = jexperts.temporal_smooth(clip)
    got = temporal_smooth(torch.from_numpy(clip))
    assert got.dtype == torch.float32 and got.shape == want.shape
    d = np.abs(got.numpy() - want) * 255
    assert d.max() <= 1.0 and d.mean() <= 0.01, (d.max(), d.mean())
    assert np.abs(want - clip).max() * 255 > 5          # the stage acts
    np.testing.assert_array_equal(got[0].numpy(), clip[0])


def test_temporal_smooth_is_causal():
    """``out[:k]`` depends only on ``clip[:k]``."""
    clip = torch.from_numpy(_moving_clip(t=5, h=40, w=48, seed=1))
    whole = temporal_smooth(clip)
    np.testing.assert_array_equal(temporal_smooth(clip[:3]).numpy(),
                                  whole[:3].numpy())


def test_run_auto_frames_smooths_the_stream(monkeypatch):
    """The route on a clip whose plan holds the stage: the stats say so,
    and the frames are ``temporal_smooth`` of the primary's stream over
    255, rounded."""
    seen = []
    real = tpipeline.smooth_frames

    def spy(frames, device):
        seen.append(np.stack(frames))
        return real(frames, device)

    monkeypatch.setattr(tpipeline, "smooth_frames", spy)
    out, stats = tpipeline.run_auto_frames(dim_clip(16, 32, 48), device="cpu")
    assert "temporal_consistency" in stats["routing_plan"]["processing_order"]
    assert stats["temporal_smoothing"] is True
    assert stats["temporal_smoothing_sec"] > 0
    assert "temporal_consistency_error" not in stats
    assert len(seen) == 1 and seen[0].shape == (16, 32, 48, 3)
    clip = torch.from_numpy(seen[0]).float() / 255.0
    want = torch.clamp(torch.round(temporal_smooth(clip) * 255), 0, 255)
    np.testing.assert_array_equal(np.stack(out),
                                  want.to(torch.uint8).numpy())
    assert np.abs(np.stack(out).astype(np.int16)
                  - seen[0].astype(np.int16)).max() > 0


def test_a_failed_stage_is_recorded(monkeypatch):
    """As in the JAX pipeline the stage is best effort: its error is
    recorded and the primary's frames are served."""
    def fail(clip, blend=0.3):
        raise RuntimeError("stage failed on purpose")

    monkeypatch.setattr(tpipeline, "temporal_smooth", fail)
    out, stats = tpipeline.run_auto_frames(dim_clip(6, 16, 16), device="cpu")
    assert stats["temporal_consistency_error"] == "stage failed on purpose"
    assert "temporal_smoothing" not in stats and len(out) == 6


def test_file_stage_matches_jax(tmp_path):
    """``run_auto_pipeline``'s post stage against the JAX package's
    ``_apply_temporal_smoothing`` on the same written file: both rewrite it
    in place at its fps, with the same frames within the codec's noise."""
    src = tmp_path / "in.mp4"
    frames = [(f * 255).round().astype(np.uint8)
              for f in _moving_clip(t=8, h=48, w=64, seed=2)]
    write_frames(src, frames, (48, 64), fps=24.0)
    a, b = tmp_path / "port.mp4", tmp_path / "jax.mp4"
    shutil.copy(src, a)
    shutil.copy(src, b)
    tpipeline._apply_temporal_smoothing(a, torch.device("cpu"))
    jpipeline._apply_temporal_smoothing(str(b))
    for p in (a, b):
        meta = get_video_metadata(p)
        assert (meta.height, meta.width, meta.frame_count) == (48, 64, 8)
        assert meta.fps == pytest.approx(24.0)
    got = np.stack(list(read_frames(a))).astype(np.int16)
    want = np.stack(list(read_frames(b))).astype(np.int16)
    orig = np.stack(list(read_frames(src))).astype(np.int16)
    d = np.abs(got - want)
    assert d.mean() <= 0.05 and d.max() <= 2, (d.mean(), d.max())
    assert np.abs(want - orig).max() > 5                # the stage acts


def test_run_auto_pipeline_runs_the_stage(tmp_path):
    """File to file: the stats say the stage ran, and the output file is
    the stage's output on what the primary wrote."""
    src = tmp_path / "in.mp4"
    write_frames(src, dim_clip(6, 16, 16, seed=3), (16, 16), fps=24.0)
    stats = tpipeline.run_auto_pipeline(src, tmp_path / "out.mp4",
                                        device="cpu")
    assert "temporal_consistency" in stats["routing_plan"]["processing_order"]
    assert stats["temporal_smoothing"] is True
    assert "temporal_consistency_error" not in stats
    assert len(list(read_frames(tmp_path / "out.mp4"))) == 6
