"""The port's fast_mamba_vsr against the JAX package's, on the CPU: the ops
it adds (linear resize, grouped and temporal convs), the bundled weights, a
narrow random init, the serving handler, and the strict-latency route.

Tolerances: 1e-5 absolute for the ops (fp32 products summed in another
order); 1e-4 absolute on model outputs in [0, 1], fp32 on both sides (the
measured gap is ~1e-6 through 8 layers).
"""

from __future__ import annotations

import copy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.analysis import router as jrouter
from video_enhancer_tpu.config import default_policy as j_default_policy
from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.ops.resize import resize as j_resize
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu.runtime import vsr_handler as jvh
from video_enhancer_tpu.runtime.weights import (flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.io.video import sample_indices
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.ops.resize import resize
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import synthetic_clip  # noqa: E402

TOL = 1e-4
NPZ = registry.WEIGHTS_DIR / "fast_mamba_vsr_4x.npz"


@pytest.mark.parametrize("in_hw,out_hw", [((9, 16), (18, 32)),
                                          ((5, 7), (20, 21)),
                                          ((12, 10), (6, 5))])
def test_linear_resize_matches_jax(in_hw, out_hw):
    img = np.random.default_rng(0).random((2, *in_hw, 3), dtype=np.float32)
    want = np.asarray(j_resize(jnp.asarray(img), out_hw, method="linear"))
    got = resize(torch.from_numpy(img), out_hw, method="linear").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["depthwise", "temporal"])
def test_grouped_and_temporal_conv3d_match_jax(kind):
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 5, 6, 7, 4)).astype(np.float32)
    if kind == "depthwise":
        w = g.standard_normal((1, 3, 3, 1, 4)).astype(np.float32)
        groups = 4
    else:
        w = g.standard_normal((3, 1, 1, 4, 3)).astype(np.float32)
        groups = 1
    b = g.standard_normal((w.shape[-1],)).astype(np.float32)
    want = np.asarray(jconv.conv3d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   feature_group_count=groups))
    got = tconv.conv3d(torch.from_numpy(x),
                       tweights.convert_array("a.w", w), torch.from_numpy(b),
                       groups=groups)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bundled_checkpoint_fills_every_leaf():
    flat = tweights.read_npz(NPZ)
    template = tfmv.init(torch.Generator().manual_seed(0))
    filled, matched, skipped = tweights.load_into(
        template, tweights.params_from_jax(flat))
    assert len(matched) == len(flat) == 178 and not skipped
    ssm = filled["layers"][7]["bimamba"]
    assert ssm["x_proj"]["w"].shape == (19, 96)
    assert ssm["conv_w"].shape == (96, 1, 5)
    assert filled["embed1"]["dw"]["w"].shape == (3, 1, 1, 3, 3)
    assert filled["temporal"]["w"].shape == (3, 3, 3, 1, 1)


@pytest.mark.parametrize("shape", [(8, 32, 32), (5, 18, 22)])
def test_bundled_weights_match_jax(shape):
    """8 frames of 32x32; 5 of 18x22, whose second pool drops a row and a
    column."""
    jp, _ = jfmv.init(jax.random.PRNGKey(0))
    jp = try_load_params(NPZ, jp)
    t, h, w = shape
    clip = np.random.default_rng(t).random((1, t, h, w, 3), dtype=np.float32)
    want = np.asarray(jfmv.apply(jp, jnp.asarray(clip), scale=4))
    with torch.inference_mode():
        got = tfmv.apply(registry.load_params("fast_mamba_vsr"),
                         torch.from_numpy(clip), scale=4).numpy()
    assert got.shape == (1, t, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_random_init_matches_jax():
    """JAX init at a narrow width (dim 16, 2 layers, N 4), with the
    zero-initialised head and temporal conv filled."""
    jp, _ = jfmv.init(jax.random.PRNGKey(5), dim=16, num_layers=2,
                      scale=2, state_dim=4)
    g = np.random.default_rng(5)
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    for k in ("head.w", "head.b", "temporal.w", "temporal.b"):
        flat[k] = (g.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    jp, _, _ = unflatten_into(jp, flat)
    clip = g.random((2, 4, 12, 8, 3), dtype=np.float32)
    want = np.asarray(jfmv.apply(jp, jnp.asarray(clip), scale=2))
    with torch.inference_mode():
        got = tfmv.apply(tweights.params_from_jax(flat),
                         torch.from_numpy(clip), scale=2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


class _F32Handler(jvh.VSRHandler):
    """The JAX handler computing in fp32, to compare at fp32."""

    def __init__(self, *a, **kw):
        kw["compute_dtype"] = jnp.float32
        super().__init__(*a, **kw)


def test_handler_matches_jax(monkeypatch):
    """The entry (chunk 16, overlap 2, x4, tile 512/32), the bundled
    weights, and one window through the calibrated blend (s = 0.6)."""
    monkeypatch.setattr(jvh, "VSRHandler", _F32Handler)
    jh = jregistry._build("fast_mamba_vsr", j_default_policy(), 0)
    # a copy: the registry hands the same handler to later callers
    th = copy.copy(registry.build_handler("fast_mamba_vsr", device="cpu"))
    for attr in ("name", "scale", "chunk", "overlap", "tile", "tile_overlap"):
        assert getattr(th, attr) == getattr(jh, attr), attr
    assert (th.chunk, th.overlap, th.dtype) == (16, 2, torch.bfloat16)
    th.dtype = torch.float32
    th.params = cast_params(registry.load_params("fast_mamba_vsr"),
                            torch.float32, th.device)
    clip = np.random.default_rng(6).random((16, 12, 16, 3), dtype=np.float32)
    want = np.asarray(jh.process_clip(jnp.asarray(clip)))
    got = th.process_clip(torch.from_numpy(clip)).numpy()
    assert got.shape == (16, 48, 64, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _jax_plan(monkeypatch, frames, available, **kw):
    """The JAX router's plan for frames in memory (its file reads and face
    detector replaced, as in tests/test_torch_router.py)."""
    meta = types.SimpleNamespace(height=frames.shape[1],
                                 width=frames.shape[2], fps=30.0,
                                 frame_count=len(frames))
    monkeypatch.setattr(jrouter, "get_video_metadata", lambda p: meta)
    monkeypatch.setattr(jrouter, "sample_frames",
                        lambda p, num_samples=12: frames)
    monkeypatch.setattr(jrouter, "_detect_faces_ratio", lambda f: 0.0)
    router = jrouter.DegradationRouter(available_models=set(available))
    return router.analyze_and_route("mem", **kw)


def test_strict_route_serves_fast_mamba_vsr(monkeypatch):
    """``latency_class="strict"``: both routers pick fast_mamba_vsr on the
    same clip, and the port serves it x4 through the fused SSM (8 layers a
    window, 2 windows of 16 overlapping by 2), with no fallback."""
    frames = synthetic_clip(20, 16, 24)
    sampled = np.stack([frames[i] for i in sample_indices(len(frames))])
    want = _jax_plan(monkeypatch, sampled, jregistry.probe_available(),
                     latency_class="strict")
    kernels.reset_launch_counts()
    out, stats = run_auto_frames(frames, latency_class="strict",
                                 device="cpu")
    plan = stats["routing_plan"]
    assert want["expert_routing"]["primary_model"] == "fast_mamba_vsr"
    assert plan["expert_routing"] == want["expert_routing"]
    assert plan["processing_order"] == want["processing_order"]
    assert stats["model"] == "fast_mamba_vsr" and stats["scale"] == 4
    assert "fallback_from" not in stats and "fallback" not in plan
    assert len(out) == 20 and out[0].shape == (64, 96, 3)
    assert sum(kernels.launch_counts.values()) == 0   # the CPU launches none
