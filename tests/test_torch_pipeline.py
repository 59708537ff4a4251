"""The port's auto pipeline, preprocessing experts and fallback handlers
against the JAX package's, on the CPU.

Tolerances: 1e-6 absolute for the preprocessing experts (fp32 stencils on
both sides); 1e-5 for bicubic and 1e-4 for the CNN upscaler at fp32
(convolutions and resize products summed in another order); 1 LSB for
uint8 frames of one computation. End to end, both pipelines run ditvr in
bf16 and encode with OpenCV; their outputs are held to a mean of 1 LSB and
a max of 16 LSB (bf16 rounding through 8 blocks, then the codec). Each
then runs the temporal-consistency stage on its written file (the port's
Farneback in torch, the JAX package's in OpenCV); the port's final file is
held to the JAX stage run on a copy of the port's written file, to a mean
of 0.05 LSB and a max of 2 (the limits of tests/test_torch_temporal.py).
The codec's second pass makes the two pipelines' final files differ more
than their inputs to the stage (a mean of 1.35 LSB against 0.46 on the
ditvr clip), so those are compared before the stage.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.config import default_policy as j_default_policy
from video_enhancer_tpu.runtime import experts as jexperts
from video_enhancer_tpu.runtime import pipeline as jpipeline
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu_torch import config as tconfig
from video_enhancer_tpu.runtime.upscaler_handler import \
    CnnUpscalerHandler as JCnn
from video_enhancer_tpu_torch.io.video import read_frames, write_frames
from video_enhancer_tpu_torch.runtime import pipeline as tpipeline
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime.experts import (preprocess_clip,
                                                      temporal_smooth)
from video_enhancer_tpu_torch.runtime.upscaler_handler import \
    CnnUpscalerHandler

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import dim_clip  # noqa: E402

CNN_NPZ = registry.WEIGHTS_DIR / "cnn_upscaler_2x.npz"
JAX_STAGE = jpipeline._apply_temporal_smoothing


@pytest.mark.parametrize("flags", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, True, True)])
def test_preprocess_clip_matches_jax(flags):
    dn, ll, cc = flags
    clip = np.random.default_rng(0).random((3, 17, 23, 3), dtype=np.float32)
    want = np.asarray(jexperts.preprocess_clip(
        jnp.asarray(clip), do_denoise=dn, do_lowlight=ll, do_compression=cc))
    got = preprocess_clip(torch.from_numpy(clip), do_denoise=dn,
                          do_lowlight=ll, do_compression=cc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_bicubic_handler_matches_jax():
    frames = np.random.default_rng(1).random((3, 12, 20, 3), dtype=np.float32)
    want = np.asarray(JCnn(scale=2, use_cnn=False).enhance_frames(
        jnp.asarray(frames)))
    h = CnnUpscalerHandler(scale=2, use_cnn=False, device="cpu")
    got = h.process_frames(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, 24, 40, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cnn_upscaler_handler_matches_jax():
    """The bundled cnn_upscaler_2x.npz (all 10 arrays) behind the
    calibrated blend (s = 0.7), at fp32 on both sides."""
    frames = np.random.default_rng(2).random((2, 16, 24, 3), dtype=np.float32)
    jh = JCnn(scale=2, use_cnn=True, weights_path=str(CNN_NPZ),
              compute_dtype=jnp.float32)
    assert jh.meta.get("weights") == "loaded"
    want = np.asarray(jh.enhance_frames(jnp.asarray(frames)))
    th = CnnUpscalerHandler(scale=2, use_cnn=True, weights_path=CNN_NPZ,
                            dtype=torch.float32, device="cpu")
    got = th.process_frames(torch.from_numpy(frames)).numpy()
    bicubic = CnnUpscalerHandler(scale=2, use_cnn=False, device="cpu")
    base = bicubic.process_frames(torch.from_numpy(frames)).numpy()
    assert np.abs(want - base).max() > 1e-2         # the CNN does something
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["cnn_upscaler", "bicubic"])
def test_registry_fallback_handlers_stream(name):
    """Batches of 8 with a padded tail: one frame out per frame in, equal
    to the batch computation."""
    h = registry.build_handler(name, device="cpu")
    assert h.name == name and h.scale == 2 and h.device.type == "cpu"
    assert h.dtype == (torch.bfloat16 if name == "cnn_upscaler"
                       else torch.float32)
    frames = [f for f in dim_clip(10, 16, 24, seed=4)]
    out = list(h.enhance_frames(iter(frames)))
    assert len(out) == 10
    assert all(f.shape == (32, 48, 3) and f.dtype == np.uint8 for f in out)
    clip = torch.from_numpy(np.stack(frames)).float() / 255.0
    want = torch.clamp(torch.round(h.process_frames(clip) * 255), 0, 255)
    diff = np.abs(np.stack(out).astype(np.int16)
                  - want.numpy().astype(np.int16))
    assert diff.max() <= 1


def test_cnn_upscaler_loads_every_array():
    from video_enhancer_tpu_torch.models import upscaler
    from video_enhancer_tpu_torch.runtime.weights import (load_into,
                                                          params_from_jax,
                                                          read_npz)

    template = upscaler.init(torch.Generator().manual_seed(0))
    _, matched, skipped = load_into(template,
                                    params_from_jax(read_npz(CNN_NPZ)))
    assert len(matched) == 10 and not skipped


def _clip_file(tmp_path, n=16, h=32, w=48):
    path = tmp_path / "in.mp4"
    write_frames(path, dim_clip(n, h, w, seed=5), (h, w), fps=24.0)
    return path


def _smoothed(frames_u8) -> np.ndarray:
    """The temporal stage on uint8 frames, recomputed: over 255,
    ``temporal_smooth``, rounded."""
    clip = torch.from_numpy(np.stack(frames_u8)).float() / 255.0
    return torch.clamp(torch.round(temporal_smooth(clip) * 255), 0,
                       255).to(torch.uint8).numpy()


def _keep_stage_input(monkeypatch, tmp_path) -> None:
    """Copy each pipeline's written file to ``<name>.pre.mp4`` before its
    temporal stage rewrites it."""
    for mod in (jpipeline, tpipeline):
        real = mod._apply_temporal_smoothing

        def keep(path, *args, real=real):
            shutil.copy(path, tmp_path / (Path(path).stem + ".pre.mp4"))
            real(path, *args)

        monkeypatch.setattr(mod, "_apply_temporal_smoothing", keep)


def _check_frames(tmp_path, shape) -> None:
    """The two pipelines' files before the stage within 1 LSB on average
    and 16 at most; the port's final file against the JAX stage on a copy
    of the port's file before it."""
    frames = lambda name: np.stack(list(read_frames(tmp_path / name))
                                   ).astype(np.int16)
    a, b = frames("port.pre.mp4"), frames("jax.pre.mp4")
    assert a.shape == b.shape == shape
    assert np.abs(a - b).mean() <= 1.0 and np.abs(a - b).max() <= 16
    shutil.copy(tmp_path / "port.pre.mp4", tmp_path / "ref.mp4")
    JAX_STAGE(str(tmp_path / "ref.mp4"))
    d = np.abs(frames("port.mp4") - frames("ref.mp4"))
    assert d.mean() <= 0.05 and d.max() <= 2, (d.mean(), d.max())
    assert np.abs(frames("port.mp4") - a).max() > 0     # the stage acts


def test_run_auto_pipeline_matches_jax(monkeypatch, tmp_path):
    """File to file on a clip the router sends to ditvr: the same plan, the
    same stats, and close frames. Both pipelines run the temporal stage
    the plan asks for on the written file, and neither records an error."""
    src = _clip_file(tmp_path)
    _keep_stage_input(monkeypatch, tmp_path)
    want = jpipeline.run_auto_pipeline(str(src), str(tmp_path / "jax.mp4"))
    got = tpipeline.run_auto_pipeline(src, tmp_path / "port.mp4",
                                      device="cpu")
    plan, jplan = got["routing_plan"], want["routing_plan"]
    assert plan["expert_routing"]["primary_model"] == "ditvr"
    for key in ("expert_routing", "processing_order"):
        assert plan[key] == jplan[key]
    for k, v in jplan["degradations"].items():
        assert plan["degradations"][k] == pytest.approx(v, abs=5e-5)
    assert "temporal_consistency" in plan["processing_order"]
    for k in ("model", "frames_processed", "input_resolution",
              "output_resolution", "scale", "temporal_smoothing"):
        assert got[k] == want[k], k
    assert got["temporal_smoothing"] is True
    assert "temporal_consistency_error" not in got
    assert "temporal_consistency_error" not in want
    assert "fallback_from" not in got and "fallback_from" not in want
    assert got["context"]["degradation_type"] == 3
    _check_frames(tmp_path, (16, 32, 48, 3))


def test_run_auto_pipeline_falls_back_to_bicubic(monkeypatch, tmp_path):
    """A primary that fails serves bicubic and says so."""
    src = _clip_file(tmp_path, n=6)
    real = tpipeline.build_handler

    def failing(name, policy=None, device=None):
        if name == "ditvr":
            raise RuntimeError("primary failed on purpose")
        return real(name, policy, device=device)

    monkeypatch.setattr(tpipeline, "build_handler", failing)
    stats = tpipeline.run_auto_pipeline(src, tmp_path / "out.mp4",
                                        device="cpu")
    assert stats["fallback_from"] == "ditvr"
    assert stats["fallback_error"] == "primary failed on purpose"
    assert stats["model"] == "bicubic" and stats["scale"] == 2
    assert stats["output_resolution"] == [64, 96]
    assert len(list(read_frames(tmp_path / "out.mp4"))) == 6


def test_run_auto_frames_routes_to_ditvr():
    frames = dim_clip(16, 32, 32, seed=6)
    out, stats = tpipeline.run_auto_frames(frames, device="cpu")
    plan = stats["routing_plan"]
    assert plan["expert_routing"]["primary_model"] == "ditvr"
    assert stats["model"] == "ditvr" and "fallback_from" not in stats
    assert len(out) == 16 and out[0].shape == (32, 32, 3)
    assert stats["temporal_smoothing"] is True
    assert "temporal_consistency_error" not in stats
    h = registry.build_handler("ditvr", device="cpu")
    tpipeline.apply_degradation_context(h, plan)
    assert stats["context"] == {k: v.tolist() for k, v in h.context.items()}
    # the first window is the temporal stage (causal) on the handler's
    # output on the preprocessed frames
    pre = tpipeline.preprocess_frames(frames[:8], plan["expert_routing"]
                                      ["experts"], torch.device("cpu"))
    clip = torch.from_numpy(np.stack(pre)).float() / 255.0
    want = torch.clamp(torch.round(h.process_clip(clip) * 255), 0, 255)
    want = _smoothed(list(want.to(torch.uint8).numpy()))
    assert np.abs(np.stack(out[:8]).astype(np.int16)
                  - want.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("engine", ["bicubic", "cnn_upscaler"])
def test_run_auto_frames_explicit_engine(engine):
    frames = dim_clip(5, 16, 16, seed=7)
    out, stats = tpipeline.run_auto_frames(frames, engine=engine,
                                           device="cpu")
    plan = stats["routing_plan"]
    assert plan["expert_routing"]["primary_model"] == engine
    assert plan["processing_order"] == ["preprocessing", f"sota_{engine}",
                                        "temporal_consistency"]
    assert stats["model"] == engine and len(out) == 5
    assert out[0].shape == (32, 32, 3) and "context" not in stats


def test_run_auto_frames_falls_back_to_bicubic(monkeypatch):
    frames = dim_clip(5, 16, 16, seed=8)
    real = tpipeline.build_handler
    monkeypatch.setattr(tpipeline, "build_handler",
                        lambda name, policy=None, device=None:
                        (_ for _ in ()).throw(RuntimeError("boom"))
                        if name == "ditvr" else real(name, policy,
                                                     device=device))
    out, stats = tpipeline.run_auto_frames(frames, device="cpu")
    assert stats["fallback_from"] == "ditvr" and stats["model"] == "bicubic"
    plan = stats["routing_plan"]
    pre = tpipeline.preprocess_frames(frames, plan["expert_routing"]
                                      ["experts"], torch.device("cpu"))
    want = list(registry.build_handler("bicubic", device="cpu")
                .enhance_frames(iter(pre)))
    assert stats["temporal_smoothing"] is True
    np.testing.assert_array_equal(np.stack(out), _smoothed(want))


def test_run_auto_frames_needs_frames():
    with pytest.raises(ValueError, match="no frames"):
        tpipeline.run_auto_frames([], device="cpu")


def test_policy_entry_reaches_the_handler(monkeypatch):
    """A policy whose vsrm entry has another window changes the handler
    that ``run_auto_frames`` builds, as the JAX package's ``_build`` reads
    ``policy.models`` (the port read its own defaults)."""
    tdef = tconfig.default_policy()
    tpol = dataclasses.replace(tdef, models={**tdef.models, "vsrm":
                                             dataclasses.replace(
                                                 tdef.models["vsrm"],
                                                 window=5, stride=4)})
    jdef = j_default_policy()
    jpol = dataclasses.replace(jdef, models={**jdef.models, "vsrm":
                                             dataclasses.replace(
                                                 jdef.models["vsrm"],
                                                 window=5, stride=4)})
    built = []
    real = tpipeline.build_handler

    def spy(name, *a, **kw):
        built.append(real(name, *a, **kw))
        return built[-1]

    monkeypatch.setattr(tpipeline, "build_handler", spy)
    out, stats = tpipeline.run_auto_frames(dim_clip(6, 16, 16, seed=9),
                                           engine="vsrm", policy=tpol,
                                           device="cpu")
    jh = jregistry._build("vsrm", jpol, 0)
    assert stats["model"] == "vsrm" and "fallback_from" not in stats
    assert (built[0].chunk, built[0].overlap) == (jh.chunk, jh.overlap) \
        == (5, 1)
    assert len(out) == 6 and out[0].shape == (64, 64, 3)


def test_run_auto_pipeline_takes_the_cli_keywords(tmp_path):
    """The call the JAX package's CLI makes (cli.py:74-75: ``engine=``,
    ``scale=``) and ``enable_temporal_smoothing``: accepted, and, as in the
    JAX pipeline, the output scale is the primary's."""
    src = _clip_file(tmp_path, n=4, h=16, w=16)
    stats = tpipeline.run_auto_pipeline(
        src, tmp_path / "out.mp4", engine="fast_mamba_vsr", scale=2,
        enable_temporal_smoothing=True, device="cpu")
    assert stats["model"] == "fast_mamba_vsr" and stats["scale"] == 4
    assert "fallback_from" not in stats
    assert stats["output_resolution"] == [64, 64]
    assert len(list(read_frames(tmp_path / "out.mp4"))) == 4


def test_run_auto_pipeline_rvrt_matches_jax(monkeypatch, tmp_path):
    """``engine="rvrt"`` file to file in both pipelines: the same plan and
    stats, no fallback, and close frames (both bf16 through 4 blocks, then
    the codec, then the temporal stage; the limits of the ditvr comparison
    above)."""
    src = _clip_file(tmp_path, n=10, h=16, w=24)
    _keep_stage_input(monkeypatch, tmp_path)
    want = jpipeline.run_auto_pipeline(str(src), str(tmp_path / "jax.mp4"),
                                       engine="rvrt")
    got = tpipeline.run_auto_pipeline(src, tmp_path / "port.mp4",
                                      engine="rvrt", device="cpu")
    plan, jplan = got["routing_plan"], want["routing_plan"]
    assert plan["expert_routing"]["primary_model"] == "rvrt"
    assert plan["processing_order"] == jplan["processing_order"]
    for k in ("model", "frames_processed", "input_resolution",
              "output_resolution", "scale", "chunk", "overlap",
              "temporal_smoothing"):
        assert got[k] == want[k], k
    assert "fallback_from" not in got and "fallback_from" not in want
    assert got["temporal_smoothing"] is True
    _check_frames(tmp_path, (10, 64, 96, 3))


def test_cached_ditvr_handler_takes_each_videos_context():
    """The registry hands the same ditvr handler to every call, and the
    pipeline sets the router's degradation context on it before each
    video, so a later video never runs with an earlier one's context."""
    clips = [dim_clip(8, 32, 32, seed=6), dim_clip(8, 32, 48, seed=3),
             dim_clip(8, 32, 32, seed=6)]
    contexts = []
    for frames in clips:
        _, stats = tpipeline.run_auto_frames(frames, device="cpu")
        plan = stats["routing_plan"]
        assert stats["model"] == "ditvr"
        deg = plan["degradations"]
        scores = [deg["noise"], deg["motion_blur"], deg["compression"]]
        assert stats["context"]["degradation_scores"] == pytest.approx(
            scores, abs=1e-6)
        contexts.append(stats["context"])
    assert contexts[0] == contexts[2] != contexts[1]
    h = registry.build_handler("ditvr", device="cpu")
    assert registry.build_handler("ditvr", device="cpu") is h
    assert h.context["degradation_scores"].tolist() == \
        contexts[2]["degradation_scores"]
