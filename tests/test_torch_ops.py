"""The port's plain ops against the JAX package's, on the CPU.

The same seeded numpy inputs go through both; weights go through the port's
checkpoint converter. Tolerance: 1e-5 absolute for fp32 ops (both sides
compute in fp32 at full matmul precision), 2e-2 for the bf16 resize.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu import nn as jnn
from video_enhancer_tpu.ops import blend as jblend
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.ops.resize import interp_matrix as j_interp
from video_enhancer_tpu.ops.resize import resize as j_resize
from video_enhancer_tpu.ops.attention import site_attention as j_site
from video_enhancer_tpu.ops.pixel_shuffle import pixel_shuffle as j_ps
from video_enhancer_tpu.ops.warp import flow_warp_local as j_warp
from video_enhancer_tpu_torch import nn as tnn
from video_enhancer_tpu_torch.ops import blend as tblend
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.ops import resize as tresize
from video_enhancer_tpu_torch.ops.attention import site_attention as t_site
from video_enhancer_tpu_torch.ops.pixel_shuffle import pixel_shuffle as t_ps
from video_enhancer_tpu_torch.ops.warp import flow_warp_local as t_warp
from video_enhancer_tpu_torch.runtime.weights import convert_array

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 1), (2, 4)])
def test_conv3d(kh, kw):
    r = _rng(kh * 10 + kw)
    x = r.standard_normal((2, 3, 8, 10, 5), dtype=np.float32)
    w = r.standard_normal((1, kh, kw, 5, 7), dtype=np.float32) * 0.3
    b = r.standard_normal(7, dtype=np.float32)
    want = jconv.conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tconv.conv3d(_t(x), convert_array("embed.w", w), _t(b))
    _close(got, want)


@pytest.mark.parametrize("k", [4, 5])
def test_depthwise_conv1d(k):
    r = _rng(k)
    x = r.standard_normal((3, 11, 6), dtype=np.float32)
    w = r.standard_normal((k, 1, 6), dtype=np.float32)
    b = r.standard_normal(6, dtype=np.float32)
    want = jconv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), padding="SAME")
    got = tconv.depthwise_conv1d(_t(x), convert_array("s.conv_w", w), _t(b))
    _close(got, want)


def _dense_np(r, din, dout, bias=True):
    p = {"w": r.standard_normal((din, dout), dtype=np.float32) / np.sqrt(din)}
    if bias:
        p["b"] = r.standard_normal(dout, dtype=np.float32)
    return p


def _to_port(p):
    return {k: convert_array(k, v) for k, v in p.items()}


def _to_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    r = _rng(1)
    p = _dense_np(r, 12, 9, bias)
    x = r.standard_normal((4, 5, 12), dtype=np.float32)
    _close(tnn.dense_apply(_to_port(p), _t(x)),
           jnn.dense_apply(_to_jax(p), jnp.asarray(x)))


def test_layer_norm():
    r = _rng(2)
    p = {"scale": r.standard_normal(16, dtype=np.float32),
         "bias": r.standard_normal(16, dtype=np.float32)}
    x = r.standard_normal((3, 7, 16), dtype=np.float32) * 3 + 1
    _close(tnn.layer_norm_apply(_to_port(p), _t(x)),
           jnn.layer_norm_apply(_to_jax(p), jnp.asarray(x)))


def test_mlp_uses_tanh_gelu():
    r = _rng(3)
    p = {"fc1": _dense_np(r, 8, 16), "fc2": _dense_np(r, 16, 8)}
    x = r.standard_normal((5, 8), dtype=np.float32) * 2
    got = tnn.mlp_apply({k: _to_port(v) for k, v in p.items()}, _t(x))
    want = jnn.mlp_apply({k: _to_jax(v) for k, v in p.items()},
                         jnp.asarray(x))
    _close(got, want)


@pytest.mark.parametrize("in_hw,out_hw,antialias", [
    ((16, 20), (64, 80), False), ((16, 20), (64, 80), True),
    ((36, 30), (16, 12), True), ((36, 30), (16, 12), False)])
def test_resize_cubic(in_hw, out_hw, antialias):
    r = _rng(4)
    img = r.random((2, *in_hw, 3), dtype=np.float32)
    want = j_resize(jnp.asarray(img), out_hw, method="cubic",
                    antialias=antialias)
    _close(tresize.resize(_t(img), out_hw, antialias=antialias), want)
    np.testing.assert_array_equal(
        tresize.interp_matrix(in_hw[0], out_hw[0], antialias),
        np.asarray(j_interp(in_hw[0], out_hw[0], "cubic", antialias)))


def test_resize_bf16():
    r = _rng(5)
    img = r.random((1, 3, 12, 10, 3), dtype=np.float32)
    want = j_resize(jnp.asarray(img, jnp.bfloat16), (48, 40),
                    method="cubic", antialias=False)
    got = tresize.resize(_t(img).bfloat16(), (48, 40), antialias=False)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), tol=2e-2)


@pytest.mark.parametrize("scale", [2, 4])
def test_pixel_shuffle(scale):
    x = _rng(6).standard_normal((2, 3, 5, 4, 3 * scale * scale),
                                dtype=np.float32)
    _close(t_ps(_t(x), scale), j_ps(jnp.asarray(x), scale), tol=0)


def test_flow_warp_local():
    r = _rng(7)
    img = r.standard_normal((3, 9, 11, 4), dtype=np.float32)
    flow = r.uniform(-0.99, 0.99, (3, 9, 11, 2)).astype(np.float32)
    _close(t_warp(_t(img), _t(flow)), j_warp(jnp.asarray(img),
                                             jnp.asarray(flow)))


@pytest.mark.parametrize("heads", [1, 4])
def test_site_attention(heads):
    r = _rng(8)
    q, k, v = (r.standard_normal((20, 7, 16), dtype=np.float32)
               for _ in range(3))
    _close(t_site(_t(q), _t(k), _t(v), heads),
           j_site(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads))


def test_overlap_add_blend():
    r = _rng(9)
    tiles = r.random((4, 8, 8, 3), dtype=np.float32)
    origins = np.array([[0, 0], [0, 6], [6, 0], [6, 6]], np.int32)
    want = jblend.overlap_add_blend(jnp.asarray(tiles), jnp.asarray(origins),
                                    (14, 14), 2)
    _close(tblend.overlap_add_blend(_t(tiles), origins, (14, 14), 2), want)
    # leading frame axis: blended frame by frame
    clip = r.random((4, 2, 8, 8, 3), dtype=np.float32)
    got = tblend.overlap_add_blend(_t(clip), origins, (14, 14), 2)
    for f in range(2):
        _close(got[f], jblend.overlap_add_blend(
            jnp.asarray(clip[:, f]), jnp.asarray(origins), (14, 14), 2))
