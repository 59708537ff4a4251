"""The library layers that no model of either package calls, and the deblur
experts, in the port against the JAX package's, on the CPU: ``mamba2`` and
``bimamba2`` (both directions; several heads, and the one head a width
that ``head_dim`` does not divide falls back to), ``ssd`` and ``ssd_ref``,
``rms_norm``, ``depthwise_conv2d``, resize's ``lanczos`` and ``area``
methods (up and down, fp32 and bf16, and the integer rule) and
``resize_video``, ``site_attention_ref``, ``bsstnet`` and ``vddiff``, and
their parameters carried across (``params_from_jax``) and written back
(``save_params``, read by JAX's ``try_load_params``).

JAX runs on the CPU (its ``ssd_shared`` there is its plain chunked form;
the port's on a CPU tensor is its plain version too). Parameters have
JAX's keys and shapes and values drawn from a seeded numpy generator
(test_torch_attentive.py ``_drawn``). Tolerances at fp32 are stated beside
each check; bf16 resizes are held to one bf16 ulp of their values.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attentive import _drawn
from video_enhancer_tpu.models import deblur as jdeblur
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import core as jcore
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import attention as jattn
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.ops import ssd as jssd
from video_enhancer_tpu.runtime.weights import flatten_params as jflatten
from video_enhancer_tpu.runtime.weights import \
    try_load_params as jtry_load_params
from video_enhancer_tpu_torch import nn as tnn
from video_enhancer_tpu_torch.models import deblur as tdeblur
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.ops import attention as tattn
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.ops import resize as tresize
from video_enhancer_tpu_torch.ops import ssd as tssd
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      params_from_jax,
                                                      save_params)

# the package's ``ops.resize`` attribute is the function, not the module
jresize = importlib.import_module("video_enhancer_tpu.ops.resize")
RNG = np.random.default_rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (dim, state_dim, head_dim): inner 32 in 2 heads of 16; inner 24, which
# 16 does not divide, in one head
MAMBA2 = [(16, 8, 16), (12, 4, 16)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cfg", MAMBA2)
def test_mamba2_matches_jax(cfg, reverse):
    """L 200 in chunks of 64 (the last one ragged): 2e-5 absolute."""
    dim, n, hd = cfg
    jp, flat = _drawn(jssm.mamba2_init, dim, dim, state_dim=n, head_dim=hd)
    tp = params_from_jax(flat)
    heads = (2 * dim) // hd if (2 * dim) % hd == 0 else 1
    assert tp["A_log"].shape == (heads,) and tp["conv_w"].shape[-1] == 4
    x = RNG(dim).standard_normal((2, 200, dim), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jssm.mamba2_apply(
        p, v, reverse=reverse, chunk=64))(jp, jnp.asarray(x)))
    got = tssm.mamba2_apply(tp, _t(x), reverse=reverse, chunk=64).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("cfg", MAMBA2)
def test_bimamba2_matches_jax(cfg):
    """Both directions fused: 2e-5 absolute."""
    dim, n, hd = cfg
    jp, flat = _drawn(jssm.bimamba2_init, 7 + dim, dim, state_dim=n,
                      head_dim=hd)
    x = RNG(7).standard_normal((2, 200, dim), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jssm.bimamba2_apply(
        p, v, chunk=64))(jp, jnp.asarray(x)))
    got = tssm.bimamba2_apply(params_from_jax(flat), _t(x),
                              chunk=64).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_mamba2_reverse_is_the_flip_conjugate():
    """As the JAX package's own test (tests/test_ops_ssd.py:85-94): the
    reverse layer on x is the flip of the forward layer, same parameters,
    on flip(x); 1e-4 absolute, that test's bound."""
    _, flat = _drawn(jssm.mamba2_init, 3, 8, state_dim=4, head_dim=8)
    p = params_from_jax(flat)
    x = torch.from_numpy(RNG(3).standard_normal((1, 33, 8),
                                                dtype=np.float32))
    yr = tssm.mamba2_apply(p, x, reverse=True)
    yf = tssm.mamba2_apply(p, torch.flip(x, dims=(1,)))
    torch.testing.assert_close(yr, torch.flip(yf, dims=(1,)), atol=1e-4,
                               rtol=0)


def _ssd_inputs(b, L, H, P, N, seed):
    r = RNG(seed)
    return (r.standard_normal((b, L, H, P), dtype=np.float32),
            r.uniform(0.001, 0.2, (b, L, H)).astype(np.float32),
            -r.uniform(0.2, 2.0, H).astype(np.float32),
            r.standard_normal((b, L, H, N), dtype=np.float32),
            r.standard_normal((b, L, H, N), dtype=np.float32))


@pytest.mark.parametrize("shape", [(2, 200, 2, 16, 8, 64),
                                   (1, 50, 3, 8, 4, 128)])
def test_ssd_matches_jax(shape):
    """B/C per head, a ragged last chunk (dt = 0 padding) and a sequence
    shorter than a chunk: 1e-4 absolute on O(1) outputs, as the kernels'
    CPU tests."""
    b, L, H, P, N, chunk = shape
    args = _ssd_inputs(b, L, H, P, N, seed=L)
    want = np.asarray(jssd.ssd(*map(jnp.asarray, args), chunk=chunk))
    got = tssd.ssd(*map(_t, args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_ref_matches_jax(with_h0):
    """The sequential recurrence and its last state, from zeros or from a
    given h0: 1e-5 absolute."""
    b, L, H, P, N = 2, 40, 2, 8, 4
    args = _ssd_inputs(b, L, H, P, N, seed=11)
    h0 = (RNG(12).standard_normal((b, H, N, P), dtype=np.float32)
          if with_h0 else None)
    jy, jh = jssd.ssd_ref(*map(jnp.asarray, args),
                          h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssd.ssd_ref(*map(_t, args), h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    # the chunked form agrees with it (1e-4)
    np.testing.assert_allclose(tssd.ssd(*map(_t, args), chunk=16).numpy(),
                               np.asarray(jssd.ssd_ref(
                                   *map(jnp.asarray, args))[0]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """fp32 statistics, eps 1e-6, cast back: 1e-6 absolute in fp32, equal
    in bf16."""
    x = RNG(1).standard_normal((3, 5, 24), dtype=np.float32) * 3
    scale = (1 + 0.1 * RNG(2).standard_normal(24)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jcore.rms_norm_apply({"scale": jnp.asarray(scale)}, jx)
    got = tnn.rms_norm_apply({"scale": _t(scale)},
                             _t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6 if dtype == "float32" else 0,
                               rtol=0)
    assert (tnn.rms_norm_init(24)["scale"].numpy()
            == np.asarray(jcore.rms_norm_init(24)["scale"])).all()


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, ((2, 0), (1, 1)))])
def test_depthwise_conv2d_matches_jax(stride, padding):
    """One 3x3 filter a channel (weight ``(3, 3, 1, C)`` in JAX, ``(C, 1,
    3, 3)`` in the port), with a bias: 1e-5 absolute."""
    r = RNG(4)
    x = r.standard_normal((2, 9, 10, 6), dtype=np.float32)
    w = r.standard_normal((3, 3, 1, 6), dtype=np.float32)
    b = r.standard_normal(6, dtype=np.float32)
    want = np.asarray(jconv.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b), stride, padding))
    got = tconv.depthwise_conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b),
                                 stride, padding).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_hw", [(20, 7), (24, 30), (6, 5)])
@pytest.mark.parametrize("method", ["lanczos", "area"])
def test_resize_lanczos_and_area_match_jax(method, out_hw, dtype):
    """The (out, in) matrices equal JAX's; the resize within 1e-6 in fp32
    and one bf16 ulp of its values in bf16 (bf16-rounded matrices, fp32
    sums)."""
    for n_in, n_out in ((12, out_hw[0]), (10, out_hw[1])):
        np.testing.assert_array_equal(
            tresize.interp_matrix(n_in, n_out, True, method),
            jresize._interp_matrix_np(n_in, n_out, method, True))
    x = RNG(6).random((2, 12, 10, 3), dtype=np.float32)
    want = jresize.resize(jnp.asarray(x).astype(dtype), out_hw,
                          method=method)
    got = tresize.resize(_t(x).to(getattr(torch, dtype)), out_hw,
                         method=method)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("method", ["cubic", "lanczos", "area"])
def test_resize_rounds_integers_and_resize_video_matches_jax(method):
    """uint8 input is rounded and clipped to 0..255 (lanczos and cubic
    overshoot): within 1 level, at most 1% of values a level apart (area
    weights of 1/2 put sums on k + 0.5, where the two packages' orders of
    summation round apart: 3 of 840 here; cubic and lanczos equal);
    ``resize_video`` on a (T, H, W, C) and a (B, T, H, W, C) clip:
    1e-6."""
    u8 = RNG(8).integers(0, 256, (2, 12, 10, 3), dtype=np.uint8)
    want = np.asarray(jresize.resize(jnp.asarray(u8), (20, 7), method=method))
    got = tresize.resize(_t(u8), (20, 7), method=method)
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    if method != "area":
        np.testing.assert_array_equal(got.numpy(), want)
    for shape in ((4, 12, 10, 3), (2, 3, 12, 10, 3)):
        v = RNG(9).random(shape, dtype=np.float32)
        want = np.asarray(jresize.resize_video(jnp.asarray(v), (16, 16),
                                               method=method))
        got = tresize.resize_video(_t(v), (16, 16), method=method).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_site_attention_ref_matches_jax():
    """(N, T, C) queries against (N, Tg, C) keys, 4 heads: 1e-6."""
    r = RNG(10)
    q = r.standard_normal((64, 5, 16), dtype=np.float32)
    k = r.standard_normal((64, 7, 16), dtype=np.float32)
    v = r.standard_normal((64, 7, 16), dtype=np.float32)
    want = np.asarray(jattn.site_attention_ref(*map(jnp.asarray, (q, k, v)),
                                               heads=4))
    got = tattn.site_attention_ref(_t(q), _t(k), _t(v), heads=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("net", ["bsstnet", "vddiff"])
def test_deblur_nets_match_jax(net):
    """With the zero-initialised last conv drawn: 1e-5 absolute; untrained
    (that conv zero), each returns its input (the JAX package's
    tests/test_parity_extras.py:7-18)."""
    jinit, japply = getattr(jdeblur, f"{net}_init"), getattr(jdeblur,
                                                             f"{net}_apply")
    tinit, tapply = getattr(tdeblur, f"{net}_init"), getattr(tdeblur,
                                                             f"{net}_apply")
    jp, flat = _drawn(jinit, 13, dim=8)
    x = RNG(13).random((2, 12, 16, 3), dtype=np.float32)
    want = np.asarray(jax.jit(japply)(jp, jnp.asarray(x)))
    got = tapply(params_from_jax(flat), _t(x)).numpy()
    assert np.abs(want - x).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    untrained = tinit(torch.Generator().manual_seed(0), dim=8)
    assert float((tapply(untrained, _t(x)) - _t(x)).abs().max()) < 1e-6


@pytest.mark.parametrize("what", ["vsrm attentive", "bimamba2", "rms_norm",
                                  "bsstnet", "vddiff"])
def test_parameters_round_trip_through_jax(tmp_path, what):
    """JAX's parameters carried into the port (``params_from_jax``) and
    written back (``save_params``) load through JAX's ``try_load_params``
    into a JAX template of the same keys and shapes, every leaf equal."""
    init, kw = {
        "vsrm attentive": (_vsrm_init, dict(dim=16, num_blocks=2, scale=4,
                                            mixer="attentive")),
        "bimamba2": (jssm.bimamba2_init, dict(dim=16, state_dim=8,
                                              head_dim=16)),
        "rms_norm": (lambda k, dim: jcore.rms_norm_init(dim), dict(dim=24)),
        "bsstnet": (jdeblur.bsstnet_init, dict(dim=8)),
        "vddiff": (jdeblur.vddiff_init, dict(dim=8)),
    }[what]
    jp, flat = _drawn(init, 17, **kw)
    tp = params_from_jax(flat)
    if what == "vsrm attentive":
        template = tvsrm.init(torch.Generator().manual_seed(0), dim=16,
                              num_blocks=2, scale=4, mixer="attentive")
        assert ({k: tuple(v.shape) for k, v in flatten_params(tp).items()}
                == {k: tuple(v.shape)
                    for k, v in flatten_params(template).items()})
    path = save_params(tmp_path / "p.npz", tp)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    back = jtry_load_params(path, zeros)
    assert back is not None
    for (_, a), (_, b) in zip(sorted(_flat_np(back).items()),
                              sorted(flat.items())):
        np.testing.assert_array_equal(a, b)


def _vsrm_init(key, **kw):
    return jvsrm.init(key, **kw)[0]


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}
