"""The port's realesrgan / realesrgan_fast and the official RRDBNet against
the JAX package's, on the CPU: the nearest resize RRDBNet upsamples with,
the model at a narrow width and at full width with both bundled
checkpoints, the official graph through a ``.pth`` state dict, and the
registry's builds of both names and of ``$VETPU_REALESRGAN_CKPT``.

Tolerances, fp32 on both sides: nearest resize exact (a gather); the model
at a narrow width 1e-5 absolute (measured ~1e-6: the JAX package's scatter
form of the dense block reassociates the same sums); at full width with the
bundled weights 1e-4 on outputs in [0, 1] (measured ~1e-6); the official
graph 1e-4 against JAX and 2e-4 against the torch module it was saved from
(the JAX test's own bound for the same comparison).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_official_checkpoints import RRDBNet
from video_enhancer_tpu.models import official_arch as jofficial
from video_enhancer_tpu.models import realesrgan as jreal
from video_enhancer_tpu.ops.resize import resize as j_resize
from video_enhancer_tpu.runtime import calibration as jcal
from video_enhancer_tpu.runtime.weights import (convert_torch_state_dict,
                                                flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.models import official_arch, realesrgan
from video_enhancer_tpu_torch.ops.resize import resize
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params

TINY = {"features": 16, "num_blocks": 2, "growth": 8}


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (20, 28)),
                                          ((6, 9), (13, 10)),
                                          ((12, 10), (6, 5))])
def test_nearest_resize_matches_jax(in_hw, out_hw):
    img = np.random.default_rng(0).random((2, *in_hw, 4), dtype=np.float32)
    want = np.asarray(j_resize(jnp.asarray(img), out_hw, method="nearest"))
    got = resize(torch.from_numpy(img), out_hw, method="nearest").numpy()
    np.testing.assert_array_equal(got, want)


def _shapes(fn):
    """The JAX package's parameter tree, zeros (its eager random init takes
    seconds on the CPU)."""
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        jax.eval_shape(lambda: fn(jax.random.PRNGKey(0))[0]))


def test_random_init_matches_jax():
    """The JAX package's tree at a narrow width (features 16, 2 blocks,
    growth 8), every leaf drawn with numpy (the head too, which its init
    zeroes), through both at x4."""
    g = np.random.default_rng(3)
    flat = {k: (g.standard_normal(v.shape)
                / np.sqrt(np.prod(v.shape[:-1]) if v.ndim > 1 else 10.0)
                ).astype(np.float32)
            for k, v in flatten_params(
                _shapes(lambda k: jreal.init(k, **TINY))).items()}
    jp, _, _ = unflatten_into(_shapes(lambda k: jreal.init(k, **TINY)), flat)
    params = tweights.params_from_jax(flat)
    frames = g.random((2, 9, 11, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jreal.apply)(jp, jnp.asarray(frames)))
    with torch.inference_mode():
        got = realesrgan.apply(params, torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 36, 44, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,keys,blocks", [("realesrgan", 188, 6),
                                              ("realesrgan_fast", 98, 3)])
def test_bundled_weights_match_jax(name, keys, blocks):
    """Every leaf of the template comes from the bundled checkpoint; one
    10x12 frame through both packages at full width."""
    npz = registry.bundled_weights(name)
    _, matched, skipped = tweights.load_into(
        realesrgan.init(torch.Generator(), num_blocks=blocks),
        tweights.params_from_jax(tweights.read_npz(npz)))
    assert len(matched) == keys and not skipped
    jp = try_load_params(npz, _shapes(
        lambda k: jreal.init(k, num_blocks=blocks)))
    frame = np.random.default_rng(1).random((1, 10, 12, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jreal.apply)(jp, jnp.asarray(frame)))
    with torch.inference_mode():
        got = realesrgan.apply(registry.load_params(name),
                               torch.from_numpy(frame)).numpy()
    assert got.shape == (1, 40, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _official_pth(tmp_path, seed=0):
    """A tiny official RRDBNet (the torch module of the JAX package's test)
    with random weights, saved as a ``.pth`` state dict."""
    torch.manual_seed(seed)
    module = RRDBNet(feat=TINY["features"], blocks=TINY["num_blocks"],
                     growth=TINY["growth"]).eval()
    path = tmp_path / "RealESRGAN_x4plus.pth"
    torch.save(module.state_dict(), path)
    return module, path


def test_official_rrdbnet_pth_matches_jax(tmp_path):
    """The ``.pth`` fills every leaf of the official template; the port's
    forward meets the JAX package's on the same checkpoint and the torch
    module's own."""
    module, path = _official_pth(tmp_path)
    template = official_arch.rrdb_official_init(torch.Generator(), **TINY)
    params = tweights.try_load_params(path, template)
    _, matched, skipped = tweights.load_into(template, params)
    assert not skipped and len(matched) == len(module.state_dict())
    jp, _, jskipped = unflatten_into(
        jax.eval_shape(lambda: jofficial.rrdb_official_init(
            jax.random.PRNGKey(0), **TINY)),
        convert_torch_state_dict(module.state_dict()))
    assert not jskipped
    x = np.random.default_rng(2).random((1, 12, 10, 3), dtype=np.float32)
    want = np.asarray(jax.jit(jofficial.rrdb_official_apply)(jp, x))
    with torch.inference_mode():
        got = official_arch.rrdb_official_apply(params,
                                                torch.from_numpy(x)).numpy()
        own = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (1, 48, 40, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, own.permute(0, 2, 3, 1).numpy(),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["realesrgan", "realesrgan_fast"])
def test_registry_builds_both_names(monkeypatch, name):
    """Chunks of 4 frames with no overlap, the policy's tile, bf16, the
    bundled weights behind the calibrated blend toward the bicubic upscale
    (the JAX table's strength: 0.4, 0.2); available to the router."""
    monkeypatch.delenv("VETPU_REALESRGAN_CKPT", raising=False)
    h = copy.copy(registry.build_handler(name, device="cpu"))
    assert (h.name, h.scale, h.chunk, h.overlap) == (name, 4, 4, 0)
    assert (h.tile, h.tile_overlap, h.dtype) == (512, 32, torch.bfloat16)
    assert name in registry.probe_available()
    s = jcal.strength_for(name)
    assert s == {"realesrgan": 0.4, "realesrgan_fast": 0.2}[name]
    params = registry.load_params(name)
    h.params = cast_params(params, torch.float32, h.device)
    clip = torch.from_numpy(np.random.default_rng(4).random(
        (1, 2, 6, 8, 3), dtype=np.float32))
    with torch.inference_mode():
        got = h.apply_fn(h.params, clip)
        model = realesrgan.apply(params, clip[0])[None]
        base = torch.clamp(resize(clip, (24, 32)), 0.0, 1.0)
    want = torch.clamp(s * model + (1 - s) * base, 0.0, 1.0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_official_checkpoint_env_serves_at_full_strength(monkeypatch,
                                                         tmp_path):
    """``$VETPU_REALESRGAN_CKPT`` names a ``.pth``: the handler serves the
    official graph (``_OFFICIAL_RRDB_CFG`` patched to the tiny one) with no
    blend, and the variable is part of the cache's key. A file that loads
    nothing leaves the bundled weights served, as in the JAX registry."""
    module, path = _official_pth(tmp_path, seed=1)
    monkeypatch.setattr(registry, "_OFFICIAL_RRDB_CFG", TINY)
    monkeypatch.delenv("VETPU_REALESRGAN_CKPT", raising=False)
    bundled = registry.build_handler("realesrgan", device="cpu")
    monkeypatch.setenv("VETPU_REALESRGAN_CKPT", str(path))
    h = copy.copy(registry.build_handler("realesrgan", device="cpu"))
    assert h is not bundled and "conv_first" in h.params
    assert (h.scale, h.chunk, h.overlap) == (4, 4, 0)
    h.params = cast_params(tweights.try_load_params(
        path, official_arch.rrdb_official_init(torch.Generator(), **TINY)),
        torch.float32, h.device)
    x = np.random.default_rng(5).random((2, 6, 8, 3), dtype=np.float32)
    with torch.inference_mode():
        got = h.apply_fn(h.params, torch.from_numpy(x)[None])[0]
        own = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(got, own.permute(0, 2, 3, 1), atol=2e-4,
                               rtol=0)
    junk = tmp_path / "junk.pth"
    torch.save({"unrelated.weight": torch.zeros(3)}, junk)
    monkeypatch.setenv("VETPU_REALESRGAN_CKPT", str(junk))
    assert "stem" in registry.build_handler("realesrgan", device="cpu").params
