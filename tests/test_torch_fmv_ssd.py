"""The port's fast_mamba_vsr on the ssd temporal mixer against the JAX
package's, on the CPU: the model at a narrow width and with the bundled
``fast_mamba_vsr_ssd_4x.npz``, and the registry's two selections of the
mixer (the policy name fast_mamba_vsr_ssd, and ``extra.temporal_mixer:
ssd`` on the base entry) with their checkpoint and their strength.

Tolerances: 1e-4 absolute on model outputs in [0, 1], fp32 on both sides
(measured ~1e-6 through 8 layers); the SSD runs its plain chunked form on
both sides (the JAX package always, the port on a CPU tensor). The
registry's window is held at 1e-6 to the blend, at the JAX table's
strength, of the port's model and its bicubic upscale.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.config import default_policy as j_default_policy
from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.runtime import calibration as jcal
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu.runtime.weights import (flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.config import default_policy
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.ops.resize import resize
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params

TOL = 1e-4
NPZ = registry.WEIGHTS_DIR / "fast_mamba_vsr_ssd_4x.npz"
_JAX_INIT = jfmv.init


def _shapes(**kw):
    """The JAX package's parameter tree, zeros (its eager random init takes
    seconds on the CPU)."""
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        jax.eval_shape(lambda: _JAX_INIT(
                            jax.random.PRNGKey(0), **kw)[0]))


def _draw(key: str, shape, g) -> np.ndarray:
    """A seeded value for one leaf, in its init's range: decays e^-A_log of
    1-16, dt biases of softplus^-1(0.001-0.1), unit norm scales and skips,
    weights of 1/sqrt(fan-in) (the zero-initialised head and temporal conv
    too)."""
    leaf = key.rpartition(".")[2]
    if leaf.startswith("A_log"):
        v = np.log(g.uniform(1.0, 16.0, shape))
    elif leaf.startswith("dt_bias"):
        v = np.log(np.expm1(g.uniform(0.001, 0.1, shape)))
    elif leaf in ("D", "norm_scale", "scale"):
        v = 1.0 + 0.1 * g.standard_normal(shape)
    elif len(shape) > 1:
        v = g.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    else:
        v = 0.1 * g.standard_normal(shape)
    return v.astype(np.float32)


def test_ssd_mixer_random_init_matches_jax():
    """The JAX package's tree at a narrow width (dim 16, 2 layers, N 4: one
    head of 32), every leaf drawn with numpy."""
    cfg = dict(dim=16, num_layers=2, scale=2, state_dim=4,
               temporal_mixer="ssd")
    g = np.random.default_rng(7)
    flat = {k: _draw(k, v.shape, g)
            for k, v in flatten_params(_shapes(**cfg)).items()}
    jp, _, _ = unflatten_into(_shapes(**cfg), flat)
    clip = g.random((2, 5, 10, 8, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jfmv.apply, static_argnums=2)(
        jp, jnp.asarray(clip), 2))
    params = tweights.params_from_jax(flat)
    _, matched, skipped = tweights.load_into(
        tfmv.init(torch.Generator(), dim=16, num_layers=2, scale=2,
                  state_dim=4, temporal_mixer="ssd"), params)
    assert len(matched) == len(flat) and not skipped
    with torch.inference_mode():
        got = tfmv.apply(params, torch.from_numpy(clip), scale=2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_bundled_ssd_weights_match_jax():
    """Every leaf (154) from the bundled checkpoint: 2 heads of P 48, N 8
    a layer; 6 frames of 12x16 through both packages."""
    flat = tweights.read_npz(NPZ)
    params = registry.load_params("fast_mamba_vsr_ssd")
    _, matched, skipped = tweights.load_into(
        tfmv.init(torch.Generator(), temporal_mixer="ssd"),
        tweights.params_from_jax(flat))
    assert len(matched) == len(flat) == 154 and not skipped
    ssd = params["layers"][0]["bimamba"]
    assert ssd["A_log_f"].shape == (2,) and ssd["conv_w"].shape == (112, 1, 5)
    jp = try_load_params(NPZ, _shapes(temporal_mixer="ssd"))
    clip = np.random.default_rng(8).random((1, 6, 12, 16, 3),
                                           dtype=np.float32)
    want = np.asarray(jax.jit(jfmv.apply)(jp, jnp.asarray(clip)))
    with torch.inference_mode():
        got = tfmv.apply(params, torch.from_numpy(clip)).numpy()
    assert got.shape == (1, 6, 48, 64, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _with_ssd(policy):
    entry = policy.models["fast_mamba_vsr"]
    models = dict(policy.models)
    models["fast_mamba_vsr"] = dataclasses.replace(
        entry, extra={**entry.extra, "temporal_mixer": "ssd"})
    return dataclasses.replace(policy, models=models)


@pytest.mark.parametrize("name,strength", [("fast_mamba_vsr_ssd", 1.0),
                                           ("fast_mamba_vsr", 0.6)])
def test_registry_selections_match_jax(monkeypatch, name, strength):
    """Both selections build as the JAX registry's (chunk 16, overlap 2,
    the policy's tile), load fast_mamba_vsr_ssd_4x.npz (the variant on the
    base stem) and blend by the handler's name, at the JAX table's
    strength: s = 1.0 for fast_mamba_vsr_ssd, 0.6 for the base entry. One
    window of 16 frames through the handler in fp32 is that blend of the
    model (held to JAX above) and the bicubic upscale."""
    tpol, jpol = default_policy(), j_default_policy()
    if name == "fast_mamba_vsr":
        tpol, jpol = _with_ssd(tpol), _with_ssd(jpol)
    # every leaf comes from the checkpoint: the JAX init as zeros
    monkeypatch.setattr(jfmv, "init", lambda key, **kw: (_shapes(**kw), {}))
    jh = jregistry._build(name, jpol, 0)
    th = copy.copy(registry.build_handler(name, tpol, device="cpu"))
    for attr in ("name", "scale", "chunk", "overlap", "tile", "tile_overlap"):
        assert getattr(th, attr) == getattr(jh, attr), attr
    assert (th.chunk, th.overlap, th.dtype) == (16, 2, torch.bfloat16)
    params = registry.load_params(name, tpol.models[name])
    ref = tweights.params_from_jax(tweights.read_npz(NPZ))
    for leaf in ("A_log_b", "dt_bias_f", "norm_scale"):
        torch.testing.assert_close(params["layers"][3]["bimamba"][leaf],
                                   ref["layers"][3]["bimamba"][leaf])
    np.testing.assert_array_equal(
        np.asarray(jh.params["layers"][3]["bimamba"]["A_log_b"],
                   np.float32),
        th.params["layers"][3]["bimamba"]["A_log_b"].float().numpy())
    assert jcal.strength_for(name) == strength
    th.dtype = torch.float32
    th.params = cast_params(params, torch.float32, th.device)
    x = torch.from_numpy(np.random.default_rng(9).random(
        (16, 6, 8, 3), dtype=np.float32))
    with torch.inference_mode():
        got = th.process_clip(x)
        model = tfmv.apply(th.params, x[None])[0]
    base = torch.clamp(resize(x, (24, 32)), 0.0, 1.0)
    blend = torch.clamp(strength * model + (1 - strength) * base, 0.0, 1.0)
    torch.testing.assert_close(got, blend, atol=1e-6, rtol=0)
    if strength < 1:                  # the blend moves the window
        assert (got - model).abs().max() > 1e-3


def test_sharded_ssd_mixer_is_not_ported():
    """The ssd mixer runs under ``time_axis`` (tests/
    test_torch_sequence_parallel.py); what it still refuses, before any
    exchange, is a T shard shorter than its conv's halo (k // 2 = 2), with
    the JAX package's message (nn/ssm.py:375-377)."""
    params = tfmv.init(torch.Generator().manual_seed(0), dim=8, num_layers=1,
                       state_dim=4, temporal_mixer="ssd")
    with pytest.raises(ValueError) as e:
        tfmv.apply(params, torch.zeros(1, 1, 4, 4, 3), time_axis=object())
    assert str(e.value) == "local T shard (1) smaller than conv halo (2)"


def test_unknown_mixer_is_refused():
    with pytest.raises(ValueError, match="unknown temporal_mixer"):
        tfmv.init(torch.Generator(), dim=8, temporal_mixer="mamba3")
