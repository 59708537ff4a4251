"""The ops and the diffusion UNet under the port's seedvr2 against the JAX
package's, on the CPU.

- The normal draw (``ops/prng.py``) against ``jax.random`` for several seeds
  and shapes, odd sizes too: the hash's words and the uniforms bit for bit;
  the normals bit for bit in bf16, and in fp32 within 2 ulp, all but at most
  one element in a thousand bit for bit (the erfinv's log polynomial
  differs from XLA's in the last place for about one element in 14,000;
  measured at most 2 ulp, at most 1 element in 13,824).
- GroupNorm, the SiLU MLP, the strided conv3d and the transposed conv at
  even and odd sizes, the gather warp (flows of several pixels, past the
  border, both of the JAX package's gather layouts), the schedule and the
  DDIM step: 1e-5 absolute (fp32 on both sides; measured 0 to 6e-6).
- The UNet with the bundled seedvr2 weights and ``sample_loop``: 1e-5
  absolute on eps in fp32 (the sums of 3x3x3 convs in another order).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_enhancer_tpu import nn as jnn
from video_enhancer_tpu.models import diffusion as jdiff
from video_enhancer_tpu.models import seedvr2 as jseedvr2
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.ops import warp as jwarp
from video_enhancer_tpu.runtime.weights import unflatten_into
from video_enhancer_tpu_torch import nn as tnn
from video_enhancer_tpu_torch.models import diffusion as tdiff
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.ops import prng
from video_enhancer_tpu_torch.ops import warp as twarp
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime.weights import convert_array

TOL = 1e-5
NPZ = (Path(__file__).resolve().parents[1] / "video_enhancer_tpu" / "weights"
       / "seedvr2_1x.npz")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [(7,), (3, 5, 7), (1, 8, 18, 32, 3), (2, 3, 11, 13, 3)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulps(a: np.ndarray, b: np.ndarray, dtype: str) -> np.ndarray:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    if dtype == "bfloat16":
        ia, ib = ia >> 16, ib >> 16
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [32, 8])
def test_threefry_bits_match_jax(seed, shape, bits):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32 if bits == 32
                                      else jnp.uint8)).astype(np.int64)
    got = prng.threefry_bits(seed, shape, bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normal_matches_jax(seed, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt))
    want_u = _np(jax.random.uniform(key, shape, jdt, lo, 1.0))
    got_u = prng.uniform(seed, shape, tdt, float(lo), 1.0).float().numpy()
    np.testing.assert_array_equal(got_u, want_u)
    want = _np(jax.random.normal(key, shape, jdt))
    got = prng.normal(seed, shape, tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    ulps = _ulps(got.float().numpy(), want, dtype)
    if dtype == "bfloat16":
        assert ulps.max() == 0
    else:
        assert ulps.max() <= 2 and (ulps > 0).mean() <= 1e-3, (
            ulps.max(), (ulps > 0).sum())


@pytest.mark.parametrize("groups", [8, 4])
@pytest.mark.parametrize("shape", [(2, 3, 5, 6, 32), (1, 4, 7, 9, 64)])
def test_group_norm_matches_jax(groups, shape):
    g = np.random.default_rng(groups)
    x = (g.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = g.standard_normal(shape[-1]).astype(np.float32)
    bias = g.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jnn.group_norm_apply(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), groups))
    got = tnn.group_norm_apply(
        {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        torch.from_numpy(x), groups)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # PyTorch's own GroupNorm (channels first) computes the same
    ref = F.group_norm(torch.from_numpy(x).movedim(-1, 1), groups,
                       torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), ref.movedim(1, -1).numpy(),
                               atol=TOL, rtol=0)


def test_silu_mlp_matches_jax():
    g = np.random.default_rng(3)
    flat = {"fc1.w": g.standard_normal((16, 40)), "fc1.b":
            g.standard_normal(40), "fc2.w": g.standard_normal((40, 8)),
            "fc2.b": g.standard_normal(8)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    x = g.standard_normal((3, 16)).astype(np.float32)
    jp = {n: {"w": jnp.asarray(flat[f"{n}.w"]), "b": jnp.asarray(flat[f"{n}.b"])}
          for n in ("fc1", "fc2")}
    tp = {n: {"w": convert_array("w", flat[f"{n}.w"]),
              "b": torch.from_numpy(flat[f"{n}.b"])} for n in ("fc1", "fc2")}
    for jact, tact in ((jax.nn.silu, F.silu), (jax.nn.gelu, None)):
        want = np.asarray(jnn.mlp_apply(jp, jnp.asarray(x), act=jact))
        got = (tnn.mlp_apply(tp, torch.from_numpy(x)) if tact is None
               else tnn.mlp_apply(tp, torch.from_numpy(x), act=tact))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("thw", [(3, 6, 8), (3, 7, 9), (2, 5, 6), (1, 4, 3)])
@pytest.mark.parametrize("stride", [1, (1, 2, 2)])
def test_conv3d_matches_jax(thw, stride):
    """XLA's SAME at stride 2 pads an even axis (0, 1); a symmetric
    padding would shift the output by a pixel."""
    g = np.random.default_rng(sum(thw))
    x = g.standard_normal((2, *thw, 5)).astype(np.float32)
    w = g.standard_normal((3, 3, 3, 5, 4)).astype(np.float32)
    b = g.standard_normal(4).astype(np.float32)
    want = np.asarray(jconv.conv3d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), stride=stride))
    got = tconv.conv3d(torch.from_numpy(x), convert_array("w", w),
                       torch.from_numpy(b), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("thw", [(3, 6, 8), (3, 7, 9), (2, 5, 6), (1, 4, 3)])
@pytest.mark.parametrize("stride", [(1, 2, 2), 1])
def test_conv_transpose3d_matches_jax(thw, stride):
    g = np.random.default_rng(7 + sum(thw))
    x = g.standard_normal((2, *thw, 5)).astype(np.float32)
    w = g.standard_normal((3, 3, 3, 5, 6)).astype(np.float32)
    b = g.standard_normal(6).astype(np.float32)
    want = np.asarray(jconv.conv_transpose3d(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b), stride=stride))
    got = tconv.conv_transpose3d(torch.from_numpy(x), convert_array("w", w),
                                 torch.from_numpy(b), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("C", [3, 40])
@pytest.mark.parametrize("scale", [0.5, 4.0, 30.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flow_warp_matches_jax(C, scale, dtype):
    """Flows of several pixels and, at 30, mostly past the border; C 3 and
    40 take the JAX package's one-gather and two-gather layouts."""
    tdt, jdt = DTYPES[dtype]
    g = np.random.default_rng(C)
    img = g.random((2, 3, 9, 11, C)).astype(np.float32)
    flow = (g.standard_normal((2, 3, 9, 11, 2)) * scale).astype(np.float32)
    want = _np(jwarp.flow_warp(jnp.asarray(img, jdt), jnp.asarray(flow)))
    got = twarp.flow_warp(torch.from_numpy(img).to(tdt),
                          torch.from_numpy(flow))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL, rtol=0)


def test_grid_sample_matches_jax():
    g = np.random.default_rng(1)
    img = g.random((9, 11, 3)).astype(np.float32)
    coords = (g.random((4, 5, 2)) * 16 - 3).astype(np.float32)
    want = np.asarray(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = twarp.grid_sample(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "scaled_linear"])
def test_schedule_and_step_match_jax(schedule):
    js = jdiff.make_schedule(schedule=schedule)
    ts = tdiff.make_schedule(schedule=schedule)
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
    g = np.random.default_rng(0)
    sample = g.standard_normal((2, 2, 3, 4, 3)).astype(np.float32)
    eps = g.standard_normal((2, 2, 3, 4, 3)).astype(np.float32)
    for t, tp in ((500, 250), (250, 0), (3, -1)):
        want = np.asarray(js.step(jnp.asarray(eps), jnp.full((2,), t),
                                  jnp.full((2,), tp), jnp.asarray(sample)))
        got = ts.step(torch.from_numpy(eps), torch.full((2,), t),
                      torch.full((2,), tp), torch.from_numpy(sample))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("start_t", [500, 333, 7])
def test_timesteps_match_jnp_linspace(start_t):
    """Step counts where XLA's reciprocal and a true division truncate to
    different integers (500 over 10, 15, 20, 25, 50; 7 over 7) among
    others."""
    for n in (1, 2, 3, 5, 7, 10, 14, 15, 20, 25, 37, 50):
        want = [int(v) for v in
                jnp.linspace(start_t, 0, n + 1).astype(jnp.int32)]
        assert tdiff._timesteps(start_t, n) == want, n


@pytest.fixture(scope="module")
def unet_params():
    template = jax.eval_shape(lambda: jseedvr2.init(jax.random.PRNGKey(0))[0])
    jp, _, skipped = unflatten_into(template, dict(np.load(NPZ)))
    assert not skipped
    return jp["unet"], registry.load_params("seedvr2")["unet"]


@pytest.mark.parametrize("t", [[500.0], [1.0, 873.25]])
def test_unet_matches_jax(unet_params, t):
    """The bundled seedvr2 UNet (base 32, mult (1, 2, 4)) on 4 frames of
    16x24: levels of 16x24, 8x12 and 4x6, attention at the last."""
    jp, tp = unet_params
    x = np.random.default_rng(len(t)).standard_normal(
        (len(t), 4, 16, 24, 6)).astype(np.float32)
    tt = np.asarray(t, np.float32)
    want = np.asarray(jax.jit(jdiff.unet_apply)(jp, jnp.asarray(x),
                                                jnp.asarray(tt)))
    got = tdiff.unet_apply(tp, torch.from_numpy(x), torch.from_numpy(tt))
    assert got.shape == (len(t), 4, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_sample_loop_matches_jax(unet_params):
    """Three DDIM steps from 500 with JAX's noise left to the port's
    draw."""
    jp, tp = unet_params
    cond = (np.random.default_rng(5).random((1, 2, 8, 8, 3)) * 2 - 1).astype(
        np.float32)
    sched = jdiff.make_schedule()
    want = np.asarray(jax.jit(lambda p, c: jdiff.sample_loop(
        p, c, sched, num_steps=3, start_t=500, seed=4))(jp, jnp.asarray(cond)))
    got = tdiff.sample_loop(tp, torch.from_numpy(cond),
                            tdiff.make_schedule(), num_steps=3, start_t=500,
                            seed=4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
