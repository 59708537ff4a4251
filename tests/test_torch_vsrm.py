"""The port's VSRM against the JAX package's, on the CPU, with the bundled
weights and with the JAX package's own random init.

Tolerance 1e-3 absolute on outputs in [0, 1] (fp32 on both sides; the
measured gap is ~1e-6).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.ops.resize import resize as j_resize
from video_enhancer_tpu.runtime.weights import (flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.registry import load_params

TOL = 1e-3
NPZ = (Path(__file__).resolve().parents[1] / "video_enhancer_tpu" / "weights"
       / "vsrm_4x.npz")


def test_bundled_checkpoint_fills_every_leaf():
    flat = tweights.read_npz(NPZ)
    assert len(flat) == 226
    template = tvsrm.init(torch.Generator().manual_seed(0))
    filled, matched, skipped = tweights.load_into(
        template, tweights.params_from_jax(flat))
    assert len(matched) == 226 and not skipped
    assert filled["embed"]["w"].shape == (64, 3, 1, 3, 3)
    ssd = filled["blocks"][5]["spatial_ssm"]
    assert ssd["conv_w"].shape == (160, 1, 5)
    assert ssd["in_proj"]["w"].shape == (290, 64)
    np.testing.assert_array_equal(ssd["in_proj"]["w"].numpy(),
                                  flat["blocks.5.spatial_ssm.in_proj.w"].T)


def test_lenient_load_keeps_init_for_mismatches():
    template = {"a": {"w": torch.zeros(3, 2)}, "b": [torch.ones(4)]}
    params = {"a": {"w": torch.full((3, 2), 7.0)}, "b": [torch.ones(5)]}
    out, matched, skipped = tweights.load_into(template, params)
    assert matched == ["a.w"] and skipped == ["b.0"]
    assert out["a"]["w"].eq(7).all() and out["b"][0].shape == (4,)


def test_bundled_weights_match_jax():
    jp, _ = jvsrm.init(jax.random.PRNGKey(0), dim=64, num_blocks=6, scale=4)
    jp = try_load_params(NPZ, jp)
    clip = np.random.default_rng(0).random((1, 7, 16, 16, 3),
                                           dtype=np.float32)
    want = np.asarray(jvsrm.apply(jp, jnp.asarray(clip), scale=4))
    with torch.inference_mode():
        got = tvsrm.apply(load_params("vsrm"), torch.from_numpy(clip),
                          scale=4).numpy()
    assert got.shape == (1, 7, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_random_init_matches_jax():
    """JAX init at a narrow width, with the zero-initialised head and offset
    convs filled so that the residual and the warp are not trivial."""
    jp, _ = jvsrm.init(jax.random.PRNGKey(1), dim=16, num_blocks=2, scale=4,
                       state_dim=8)
    g = np.random.default_rng(1)
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    for k in ("head.w", "head.b", "offset.w", "offset.b"):
        flat[k] = (g.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    jp2, matched, _ = unflatten_into(jp, flat)
    assert len(matched) == len(flat)
    clip = g.random((1, 5, 8, 12, 3), dtype=np.float32)
    want = np.asarray(jvsrm.apply(jp2, jnp.asarray(clip), scale=4))
    with torch.inference_mode():
        got = tvsrm.apply(tweights.params_from_jax(flat),
                          torch.from_numpy(clip), scale=4).numpy()
    bicubic = np.asarray(j_resize(jnp.asarray(clip), (32, 48),
                                  method="cubic", antialias=False))
    assert np.abs(want - np.clip(bicubic, 0, 1)).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kernels", [True, False])
def test_bf16_forward_is_finite(kernels):
    params = load_params("vsrm")
    params["blocks"] = params["blocks"][:1]
    p16 = _cast(params, torch.bfloat16)
    clip = torch.rand((1, 7, 8, 8, 3), generator=torch.Generator()
                      .manual_seed(0)).bfloat16()
    with torch.inference_mode():
        y = tvsrm.apply(p16, clip, kernels=kernels)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 7, 32, 32, 3)
    assert torch.isfinite(y.float()).all()


def _cast(p, dtype):
    if isinstance(p, dict):
        return {k: _cast(v, dtype) for k, v in p.items()}
    if isinstance(p, list):
        return [_cast(v, dtype) for v in p]
    return p.to(dtype)
