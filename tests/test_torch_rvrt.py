"""The port's rvrt against the JAX package's, on the CPU: the bundled
weights, a narrow random init, and the serving handler.

Tolerance 1e-4 absolute on outputs in [0, 1], fp32 on both sides (the
measured gap is ~1e-6: sums in another order through 4 attention blocks).
"""

from __future__ import annotations

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.config import default_policy as j_default_policy
from video_enhancer_tpu.models import rvrt as jrvrt
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu.runtime import vsr_handler as jvh
from video_enhancer_tpu.runtime.weights import (flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.models import rvrt as trvrt
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params

TOL = 1e-4
NPZ = (Path(__file__).resolve().parents[1] / "video_enhancer_tpu" / "weights"
       / "rvrt_4x.npz")


def test_bundled_checkpoint_fills_every_leaf():
    flat = tweights.read_npz(NPZ)
    template = trvrt.init(torch.Generator().manual_seed(0))
    filled, matched, skipped = tweights.load_into(
        template, tweights.params_from_jax(flat))
    assert len(matched) == len(flat) == 54 and not skipped
    assert filled["blocks"][3]["bias_table"].shape == (675, 4)
    assert filled["blocks"][0]["qkv"]["w"].shape == (192, 64)
    assert filled["head"]["w"].shape == (48, 64, 1, 3, 3)


def test_relpos_index_matches_jax():
    for window in ((2, 8, 8), (1, 3, 5)):
        np.testing.assert_array_equal(trvrt._relpos_index(window),
                                      jrvrt._relpos_index(window))


@pytest.mark.parametrize("shape", [(8, 32, 32), (7, 20, 28)])
def test_bundled_weights_match_jax(shape):
    """8 frames of 32x32 fill whole windows; 7 of 20x28 are padded."""
    jp, _ = jrvrt.init(jax.random.PRNGKey(0), dim=64, scale=4)
    jp = try_load_params(NPZ, jp)
    t, h, w = shape
    clip = np.random.default_rng(t).random((1, t, h, w, 3), dtype=np.float32)
    want = np.asarray(jrvrt.apply(jp, jnp.asarray(clip), scale=4))
    with torch.inference_mode():
        got = trvrt.apply(registry.load_params("rvrt"),
                          torch.from_numpy(clip), scale=4).numpy()
    assert got.shape == (1, t, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_random_init_matches_jax():
    """JAX init at a narrow width (dim 16, 2 blocks, 2 heads), with the
    zero-initialised head filled and a larger bias table, so that the
    residual and the bias are not trivial."""
    jp, _ = jrvrt.init(jax.random.PRNGKey(3), dim=16, depth=2, heads=2,
                       scale=2)
    g = np.random.default_rng(3)
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    for k in ("head.w", "head.b", "blocks.0.bias_table",
              "blocks.1.bias_table"):
        flat[k] = (g.standard_normal(flat[k].shape) * 0.3).astype(np.float32)
    jp, _, _ = unflatten_into(jp, flat)
    clip = g.random((2, 4, 16, 24, 3), dtype=np.float32)
    want = np.asarray(jrvrt.apply(jp, jnp.asarray(clip), scale=2, heads=2))
    with torch.inference_mode():
        got = trvrt.apply(tweights.params_from_jax(flat),
                          torch.from_numpy(clip), scale=2, heads=2)
        plain = trvrt.apply(tweights.params_from_jax(flat),
                            torch.from_numpy(clip), scale=2, heads=2,
                            kernels=False)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_bf16_forward_is_finite():
    params = registry.load_params("rvrt")
    p16 = cast_params(params, torch.bfloat16, torch.device("cpu"))
    clip = torch.rand((1, 3, 16, 16, 3), generator=torch.Generator()
                      .manual_seed(0)).bfloat16()
    with torch.inference_mode():
        y = trvrt.apply(p16, clip)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 3, 64, 64, 3)
    assert torch.isfinite(y.float()).all()


class _F32Handler(jvh.VSRHandler):
    """The JAX handler computing in fp32, to compare at fp32."""

    def __init__(self, *a, **kw):
        kw["compute_dtype"] = jnp.float32
        super().__init__(*a, **kw)


def test_handler_matches_jax(monkeypatch):
    """The entry (window 7, overlap 4, x4, tile 512/32), the bundled
    weights, and one window through the calibrated blend (s = 0.25)."""
    monkeypatch.setattr(jvh, "VSRHandler", _F32Handler)
    jh = jregistry._build("rvrt", j_default_policy(), 0)
    # a copy: the registry hands the same handler to later callers
    th = copy.copy(registry.build_handler("rvrt", device="cpu"))
    for attr in ("name", "scale", "chunk", "overlap", "tile", "tile_overlap"):
        assert getattr(th, attr) == getattr(jh, attr), attr
    assert (th.chunk, th.overlap, th.dtype) == (7, 4, torch.bfloat16)
    th.dtype = torch.float32
    th.params = cast_params(registry.load_params("rvrt"), torch.float32,
                            th.device)
    clip = np.random.default_rng(4).random((7, 24, 20, 3), dtype=np.float32)
    want = np.asarray(jh.process_clip(jnp.asarray(clip)))
    got = th.process_clip(torch.from_numpy(clip)).numpy()
    assert got.shape == (7, 96, 80, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
