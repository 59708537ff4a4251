"""vsrm's attentive spatial mixer in the port against the JAX package's, on
the CPU: ``_attentive_heads``, ``attentive_ssm_apply``, ``vsrm.apply(mixer=
"attentive")`` and the registry's selection of the variant.

The JAX side runs jitted on the CPU, where its ``attention`` takes
``attention_ref`` (the flash kernel is TPU-only there); the port on a CPU
tensor takes its ``attention_ref`` too. 16x16 frames give 256 tokens, the
dispatch's edge, 12x12 frames 144. The parameters have the keys and shapes
of JAX's init (traced with ``jax.eval_shape``: an eager init costs ~8 s
here) and values drawn from a seeded numpy generator, carried across with
``params_from_jax`` (JAX seeds its inits with ``hash(name)``, the port with
crc32, so two inits are never compared). The draws fill the head and the
offset conv, which start at zero and would otherwise make the model's
output the calibrated bicubic whatever the mixer does. Tolerance: 2e-5
absolute at fp32 on outputs of O(1) (measured 1.4e-6 to 4.2e-6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.config import default_policy as jdefault_policy
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops.resize import resize as jresize
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu.runtime.weights import flatten_params as jflatten
from video_enhancer_tpu_torch.config import default_policy
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      params_from_jax,
                                                      to_jax_layout)

TOL = 2e-5


def _flat(jp) -> dict:
    return {k: np.asarray(v) for k, v in jflatten(jp).items()}


def _drawn(init, seed: int, *args, **kw) -> tuple[dict, dict]:
    """JAX's parameters of ``init(key, *args, **kw)`` drawn from numpy:
    norm scales 1 + 0.1 n, weights n / sqrt(fan-in) (JAX's layouts put
    the inputs first), other leaves 0.1 n. Returns (the JAX tree, its flat
    dict)."""
    shapes = jax.eval_shape(
        lambda k: _params_of(init(k, *args, **kw)), jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    flat = {}
    for key, s in _leaves(shapes):
        n = g.standard_normal(s.shape)
        leaf = key.rpartition(".")[2]
        if leaf == "scale":
            v = 1.0 + 0.1 * n
        elif leaf in ("w", "conv_w") and len(s.shape) > 1:
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = 0.1 * n
        flat[key] = v.astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, _nest_like(shapes, flat)), flat


def _leaves(tree, prefix=""):
    """(dotted key, leaf) pairs in the order of JAX's ``flatten_params``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _params_of(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("inner", [8, 32, 64, 96, 128, 192, 320, 448, 640,
                                   1000])
def test_attentive_heads_match_jax(inner):
    assert tssm._attentive_heads(inner) == jssm._attentive_heads(inner)


@pytest.mark.parametrize("hw", [(12, 12), (16, 16)])
def test_attentive_ssm_apply_matches_jax(hw):
    jp, flat = _drawn(jssm.attentive_ssm_init, 3, 16)
    x = np.random.default_rng(3).standard_normal((2, *hw, 16),
                                                 dtype=np.float32)
    want = np.asarray(jax.jit(jssm.attentive_ssm_apply)(jp, jnp.asarray(x)))
    tp = params_from_jax(flat)
    assert tuple(tp["conv"]["w"].shape) == (32, 1, 3, 3)
    with torch.inference_mode():
        got = tssm.attentive_ssm_apply(tp, torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw", [(12, 12), (16, 16)])
def test_vsrm_attentive_matches_jax(hw):
    jp, flat = _drawn(jvsrm.init, 5, dim=16, num_blocks=1, scale=4,
                      state_dim=8, mixer="attentive")
    assert "qkv" in jp["blocks"][0]["spatial_ssm"]
    clip = np.random.default_rng(5).random((1, 3, *hw, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvsrm.apply(
        p, x, scale=4, mixer="attentive"))(jp, jnp.asarray(clip)))
    with torch.inference_mode():
        got = tvsrm.apply(params_from_jax(flat), torch.from_numpy(clip),
                          scale=4, mixer="attentive").numpy()
    up = tuple(4 * n for n in hw)
    bicubic = np.clip(np.asarray(jresize(jnp.asarray(clip), up,
                                         method="cubic", antialias=False)),
                      0, 1)
    assert np.abs(want - bicubic).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _nest_like(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _nest_like(v, flat, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, list):
        return [_nest_like(v, flat, f"{prefix}{i}.")
                for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def test_unknown_mixer_is_refused():
    with pytest.raises(ValueError, match="unknown mixer"):
        tvsrm.init(torch.Generator().manual_seed(0), dim=8, num_blocks=1,
                   mixer="axial")


def _with_backbone(policy, backbone):
    entry = policy.models["vsrm"]
    models = dict(policy.models)
    models["vsrm"] = dataclasses.replace(
        entry, extra={**entry.extra, "backbone": backbone})
    return dataclasses.replace(policy, models=models)


def _jax_shapes_of_build(monkeypatch, policy) -> dict:
    """JAX's ``registry._build("vsrm")`` with its init traced by
    ``jax.eval_shape`` and zeros in place of the draws (an eager init at
    full width takes ~12 s here): the keys and shapes it serves."""
    orig = jvsrm.init

    def shaped(key, **kw):
        shapes = jax.eval_shape(lambda k: orig(k, **kw)[0], key)
        return (jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes),
            {"mixer": kw.get("mixer")})

    monkeypatch.setattr(jvsrm, "init", shaped)
    handler = jregistry._build("vsrm", policy, 0)
    return {k: tuple(v.shape) for k, v in jflatten(handler.params).items()}


@pytest.mark.parametrize("how", ["env mambairv2", "env attentive",
                                 "policy entry"])
def test_registry_serves_the_attentive_variant_as_jax(monkeypatch, how):
    """The variable or the entry's ``backbone`` selects the attentive mixer
    in both registries: the port's handler holds JAX's keys and shapes (in
    JAX's layouts), at full width (dim 64, 6 blocks, 2 heads of 64), and
    serves a window on the CPU."""
    if how.startswith("env"):
        monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", how.split()[1])
        jpolicy, tpolicy = jdefault_policy(), default_policy()
    else:
        monkeypatch.setenv("VETPU_PREFERRED_BACKBONE", "eamamba")
        jpolicy = _with_backbone(jdefault_policy(), "MambaIRv2")
        tpolicy = _with_backbone(default_policy(), "MambaIRv2")
    want = _jax_shapes_of_build(monkeypatch, jpolicy)
    handler = registry.build_handler("vsrm", tpolicy, device="cpu")
    got = {k: to_jax_layout(k, v).shape
           for k, v in flatten_params(handler.params).items()}
    assert got == want
    assert "qkv" in handler.params["blocks"][0]["spatial_ssm"]
    assert tssm._attentive_heads(128) == 2
    frames = list(np.random.default_rng(0).integers(
        0, 256, (7, 16, 16, 3), dtype=np.uint8))
    # one thread: the bf16 window's CPU kernels slow ~100x when the test
    # run's other workers hold the cores (0.2 s alone, 50-66 s under load)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = list(handler.enhance_frames(iter(frames)))
    finally:
        torch.set_num_threads(threads)
    assert len(out) == 7 and out[0].shape == (64, 64, 3)
