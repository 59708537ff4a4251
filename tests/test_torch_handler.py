"""The port's serving path (windows, streaming loop, tiling, calibration,
registry, device rule) against the JAX package's, on the CPU.

The JAX handler's file IO is replaced by frames in memory (its reader and
writer are monkeypatched), so both handlers see the same uint8 frames. The
model is a narrow VSRM (dim 16, one block) from the JAX package's init with
its zero-initialised head and offset filled. Tolerances: 1 LSB on uint8
frames, 1e-4 on float outputs in [0, 1], fp32 on both sides.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.config import load_policy as j_load_policy
from video_enhancer_tpu.io import pipeline as jpipeline
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.runtime import calibration as jcal
from video_enhancer_tpu.runtime import registry as jregistry
from video_enhancer_tpu.runtime import vsr_handler as jvh
from video_enhancer_tpu.runtime.weights import (
    convert_torch_state_dict as j_convert_sd)
from video_enhancer_tpu.runtime.weights import flatten_params, unflatten_into
from video_enhancer_tpu_torch import config as tconfig
from video_enhancer_tpu_torch.device import resolve_device
from video_enhancer_tpu_torch.io.pipeline import iter_windows
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.runtime import calibration as tcal
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime.vsr_handler import VSRHandler
from video_enhancer_tpu_torch.runtime.weights import (convert_torch_state_dict,
                                                      params_from_jax)

H, W = 12, 16


def _frames(n, h=H, w=W, seed=0):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def model():
    jp, _ = jvsrm.init(jax.random.PRNGKey(2), dim=16, num_blocks=1, scale=4,
                       state_dim=8)
    g = np.random.default_rng(2)
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    for k in ("head.w", "head.b", "offset.w", "offset.b"):
        flat[k] = (g.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
    jp, _, _ = unflatten_into(jp, flat)
    return jp, params_from_jax(flat)


def _handlers(model, tile=512, tile_overlap=32):
    jp, tp = model
    jh = jvh.VSRHandler(
        "vsrm", jcal.calibrate_vsr("vsrm", lambda p, x: jvsrm.apply(
            p, x, scale=4)), jp, scale=4, chunk=7, overlap=4, tile=tile,
        tile_overlap=tile_overlap, compute_dtype=jnp.float32)
    th = VSRHandler(
        "vsrm", tcal.calibrate_vsr("vsrm", lambda p, x: tvsrm.apply(
            p, x, scale=4)), tp, scale=4, chunk=7, overlap=4, tile=tile,
        tile_overlap=tile_overlap, dtype=torch.float32, device="cpu")
    return jh, th


def _fake_reader(frames, h=H, w=W):
    class Reader:
        def __init__(self, path):
            self.meta = types.SimpleNamespace(height=h, width=w, fps=30.0,
                                              frame_count=len(frames))
            self._it = iter(frames)

        def __iter__(self):
            return self

        def __next__(self):
            return next(self._it)

    return Reader


@pytest.mark.parametrize("n", [3, 7, 10, 16, 17])
def test_windows_match_frame_pipeline(monkeypatch, n):
    frames = _frames(n)
    monkeypatch.setattr(jpipeline, "VideoReader", _fake_reader(frames))
    want = list(jpipeline.FramePipeline("mem", window=7, stride=3))
    got = list(iter_windows(iter(frames), 7, 3))
    assert [(w.start, w.valid) for w in got] == \
        [(it["start"], it["valid"]) for it in want]
    for w, it in zip(got, want):
        np.testing.assert_array_equal(w.frames.astype(np.float32) / 255.0,
                                      np.asarray(it["frames"]))


@pytest.mark.parametrize("n", [10, 16])
def test_stream_matches_jax_enhance_video(monkeypatch, model, n):
    """Later chunk wins the overlap frames; the padded tail writes only its
    real frames; one output frame per input frame."""
    frames = _frames(n, seed=n)
    jh, th = _handlers(model)
    written = []

    class Writer:
        def __init__(self, path, size_hw, fps=30.0):
            pass

        def write(self, f):
            written.append(f)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(jpipeline, "VideoReader", _fake_reader(frames))
    monkeypatch.setattr(jvh, "get_video_metadata", lambda p: types.
                        SimpleNamespace(height=H, width=W, fps=30.0,
                                        frame_count=n))
    monkeypatch.setattr(jvh, "VideoWriter", Writer)
    stats = jh.enhance_video("in", "out")
    got = list(th.enhance_frames(iter(frames)))
    assert stats["frames_processed"] == len(written) == len(got) == n
    for a, b in zip(got, written):
        assert a.shape == (4 * H, 4 * W, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_tiled_clip_matches_jax(model):
    jh, th = _handlers(model, tile=16, tile_overlap=4)
    clip = np.random.default_rng(3).random((7, 24, 40, 3), dtype=np.float32)
    want = np.asarray(jh.process_clip(jnp.asarray(clip)))
    got = th.process_clip(torch.from_numpy(clip))
    assert got.shape == (7, 96, 160, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["vsrm", "rvrt", "seedvr2", "unknown"])
def test_strength_table_and_override(monkeypatch, name):
    assert tcal.strength_for(name) == jcal.strength_for(name)
    monkeypatch.setenv(f"VETPU_STRENGTH_{name.upper()}", "0.375")
    assert tcal.strength_for(name) == jcal.strength_for(name) == 0.375
    monkeypatch.setenv(f"VETPU_STRENGTH_{name.upper()}", "1.0")
    fn = object()
    assert tcal.calibrate_vsr(name, fn) is fn


def test_build_handler_serves_bundled_vsrm():
    h = registry.build_handler("vsrm", device="cpu")
    assert (h.scale, h.chunk, h.overlap, h.tile, h.tile_overlap) == \
        (4, 7, 4, 512, 32)
    assert h.device.type == "cpu" and h.dtype == torch.bfloat16
    assert len(h.params["blocks"]) == 6
    assert h.params["embed"]["w"].dtype == torch.bfloat16
    npz = registry.read_npz(registry.bundled_weights("vsrm"))
    np.testing.assert_array_equal(
        h.params["head"]["b"].float().numpy(),
        npz["head.b"].astype(np.float32).astype(
            jnp.bfloat16).astype(np.float32))


def test_weights_env_overrides_bundled(monkeypatch, tmp_path):
    npz = dict(registry.read_npz(registry.bundled_weights("vsrm")))
    npz["embed.b"] = np.full_like(npz["embed.b"], 0.5)
    np.savez(tmp_path / "vsrm.npz", **npz)
    monkeypatch.setenv("VSRM_DIR", str(tmp_path))
    params = registry.load_params("vsrm")
    assert params["embed"]["b"].eq(0.5).all()


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="the port serves"):
        registry.build_handler("nonexistent", device="cpu")


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        registry.build_handler("vsrm")
    assert resolve_device("cpu").type == "cpu"


def _bundled_head_b():
    npz = registry.read_npz(registry.bundled_weights("vsrm"))
    return npz["head.b"]


def _jax_weights_used(name="vsrm"):
    """The file the JAX package's weight chain loads for vsrm under the
    current environment (a fresh policy reads the variable)."""
    entry = j_load_policy().models[name]
    _, meta = jregistry._load_or_init(name, entry, jvsrm.init, dim=64,
                                      num_blocks=6, scale=4)
    return meta.get("weights")


def test_empty_weights_dir_serves_bundled_vsrm(monkeypatch, tmp_path):
    """``$VSRM_DIR`` naming a directory with no checkpoint: the chain moves
    on to the bundled file, as the JAX package's does (the port raised
    FileNotFoundError, and the pipeline served bicubic x2)."""
    monkeypatch.setenv("VSRM_DIR", str(tmp_path))
    assert _jax_weights_used().endswith("vsrm_4x.npz")
    h = registry.build_handler("vsrm", device="cpu")
    assert h.name == "vsrm" and h.scale == 4
    np.testing.assert_array_equal(
        h.params["head"]["b"].float().numpy(),
        _bundled_head_b().astype(jnp.bfloat16).astype(np.float32))


def test_checkpoint_matching_no_key_falls_through(monkeypatch, tmp_path):
    """A checkpoint none of whose keys matches is passed over for the
    bundled file (the port kept random init)."""
    np.savez(tmp_path / "other.npz", **{"not.a.key": np.zeros(3, np.float32)})
    monkeypatch.setenv("VSRM_DIR", str(tmp_path / "other.npz"))
    assert _jax_weights_used().endswith("vsrm_4x.npz")
    params = registry.load_params("vsrm")
    np.testing.assert_array_equal(params["head"]["b"].numpy(),
                                  _bundled_head_b())


def test_torch_state_dict_is_read(monkeypatch, tmp_path):
    """A ``.pt`` state dict in ``$VSRM_DIR`` is converted as the JAX
    package converts it and loaded leniently: its leaves are taken, the
    others keep their initialisation, as in the JAX chain."""
    g = torch.Generator().manual_seed(0)
    sd = {"embed.weight": torch.randn((64, 3, 1, 3, 3), generator=g),
          "embed.bias": torch.full((64,), 0.5),
          "x.weight": torch.randn((5, 4), generator=g),
          "y.weight": torch.randn((6, 2, 3), generator=g),
          "z.weight": torch.randn((2, 3, 4, 5), generator=g),
          "n.weight": torch.ones(7), "n.running_mean": torch.zeros(7)}
    want, got = j_convert_sd(sd), convert_torch_state_dict(sd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    torch.save(sd, tmp_path / "vsrm.pt")
    monkeypatch.setenv("VSRM_DIR", str(tmp_path))
    assert _jax_weights_used() == str(tmp_path)     # the directory loaded
    params = registry.load_params("vsrm")
    assert params["embed"]["b"].eq(0.5).all()
    np.testing.assert_array_equal(params["embed"]["w"].numpy(),
                                  sd["embed.weight"].numpy())


def test_build_handler_caches_by_name_device_entry_and_mesh(monkeypatch):
    """One handler for each name, device, entry and mesh: the same object
    comes back for the same key, another device or entry gets its own,
    ``clear_cache`` forgets them, and a build that raises caches
    nothing."""
    builds = []

    def fake_build(name, entry, device, mesh):
        if entry.tile == 13:
            raise RuntimeError("build failed on purpose")
        builds.append((name, str(device), entry.tile, mesh))
        return object()

    monkeypatch.setattr(registry, "_build", fake_build)
    # a card device is only resolved, never used, by the fake build
    monkeypatch.setattr(registry, "resolve_device", torch.device)
    registry.clear_cache()
    pol = tconfig.default_policy()
    other = dataclasses.replace(pol, models={
        **pol.models, "vsrm": dataclasses.replace(pol.models["vsrm"],
                                                  tile=256)})
    failing = dataclasses.replace(pol, models={
        **pol.models, "vsrm": dataclasses.replace(pol.models["vsrm"],
                                                  tile=13)})
    try:
        h = registry.build_handler("vsrm", device="cpu")
        assert registry.build_handler("vsrm", pol, torch.device("cpu")) is h
        on_card = registry.build_handler("vsrm", device="cuda:0")
        wider = registry.build_handler("vsrm", other, device="cpu")
        assert len({id(h), id(on_card), id(wider)}) == 3
        assert registry.build_handler("rvrt", device="cpu") is not h
        assert builds == [("vsrm", "cpu", 512, None),
                          ("vsrm", "cuda:0", 512, None),
                          ("vsrm", "cpu", 256, None),
                          ("rvrt", "cpu", 512, None)]
        for _ in range(2):
            with pytest.raises(RuntimeError, match="on purpose"):
                registry.build_handler("vsrm", failing, device="cpu")
        registry.clear_cache()
        assert registry.build_handler("vsrm", device="cpu") is not h
        assert len(builds) == 5
    finally:
        registry.clear_cache()
