"""The port's RIFE, its handler and the auto route's frame-interpolation
stage against the JAX package's, on the CPU: ``interpolate_pair`` and
``apply`` with the bundled ``rife.npz``, ``calibrate_interp``,
``RIFEHandler._double`` at factor 2 and 4 and with ``quality="high"``, the
official IFNet through a ``.pth`` (the ConvTranspose2d weight's layout),
the blend fallback, and ``run_auto_frames(enable_hfr=True)`` against the
JAX handler's ``_double`` on the same frames.

Tolerances: fp32 model outputs 1e-5 absolute (measured ~4e-7). The
handlers compute in bf16 on both sides and round each op as the JAX
package does (the port's RIFE rounds each conv once, multiplies the leaky
ReLU's slope and the calibrated strengths in bf16 and expands the sigmoid
as XLA does), so what is left is the order of the convs' fp32 sums: a bf16
conv output an ulp apart once in ~1e4, carried by the flows (and, at
factor 4, by the second doubling's flows between the first one's
midpoints). Over 255 and rounded, the handler's frames are held to 2 LSB
at most and 0.02 LSB on average (measured 2, and 0.0005 at factor 2,
0.006 at factor 4, on 24x40 frames); the route's stage to 1 LSB (measured
1). The official IFNet meets
the torch module it was saved from to 5e-4 (the JAX test's bound) and the
JAX package's graph to 1e-4, fp32.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_official_checkpoints import IFNet
from video_enhancer_tpu.models import official_arch as jofficial
from video_enhancer_tpu.models import rife as jrife
from video_enhancer_tpu.runtime import calibration as jcal
from video_enhancer_tpu.runtime import rife_handler as jrh
from video_enhancer_tpu.runtime.weights import (convert_torch_state_dict,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.models import rife
from video_enhancer_tpu_torch.runtime import calibration as tcal
from video_enhancer_tpu_torch.runtime import pipeline as tpipeline
from video_enhancer_tpu_torch.runtime.rife_handler import (BUNDLED,
                                                           RIFEHandler)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import dim_clip, synthetic_clip  # noqa: E402


@pytest.fixture(scope="module")
def jax_params():
    """The bundled weights in the JAX package's tree (its template as
    shapes: every leaf comes from the file)."""
    return try_load_params(BUNDLED, jax.eval_shape(
        lambda: jrife.init(jax.random.PRNGKey(0))[0]))


@pytest.fixture(scope="module")
def jax_handler():
    """The JAX package's handler in bf16, with the bundled weights (its
    init as zeros: every leaf comes from the file, and the eager random
    init takes seconds on the CPU)."""
    real = jrife.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrife, "init", lambda key, **kw: (jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32),
            jax.eval_shape(lambda: real(key, **kw)[0])), {}))
        handler = jrh.RIFEHandler()
    assert handler.meta["weights"] == str(BUNDLED)
    return handler


def _clip(t, h, w):
    return np.stack(synthetic_clip(t, h, w)).astype(np.float32) / 255.0


@pytest.mark.parametrize("h,w", [(24, 40), (18, 26)])
def test_interpolate_pair_matches_jax(jax_params, h, w):
    """The bundled weights fill every leaf (28); fp32 midpoints of three
    pairs (18x26: the pyramid's sizes round down)."""
    handler = RIFEHandler(dtype=torch.float32, device="cpu")
    assert handler.meta["weights"] == str(BUNDLED)
    clip = _clip(4, h, w)
    want = np.asarray(jax.jit(jrife.interpolate_pair)(
        jax_params, jnp.asarray(clip[:-1]), jnp.asarray(clip[1:])))
    with torch.inference_mode():
        got = rife.interpolate_pair(handler.params, torch.from_numpy(clip[:-1]),
                                    torch.from_numpy(clip[1:])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - 0.5 * (clip[:-1] + clip[1:])).max() > 1e-2


def test_apply_matches_jax(jax_params):
    handler = RIFEHandler(dtype=torch.float32, device="cpu")
    clip = _clip(3, 16, 24)[None]
    want = np.asarray(jax.jit(jrife.apply)(jax_params, jnp.asarray(clip)))
    with torch.inference_mode():
        got = rife.apply(handler.params, torch.from_numpy(clip)).numpy()
    assert got.shape == (1, 5, 16, 24, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0, 0::2], clip[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_calibrate_interp_matches_jax(dtype):
    """The blend toward the frames' average at ``strength_for("rife")`` =
    0.9, in fp32 and bf16 (bit for bit)."""
    assert tcal.strength_for("rife") == jcal.strength_for("rife") == 0.9
    g = np.random.default_rng(3)
    f0, f1, mid = (g.random((2, 5, 6, 3), dtype=np.float32) for _ in range(3))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcal.calibrate_interp("rife", lambda p, a, b: jnp.asarray(
        mid, jdt))(None, jnp.asarray(f0, jdt), jnp.asarray(f1, jdt))
    got = tcal.calibrate_interp("rife", lambda p, a, b: torch.from_numpy(
        mid).to(dtype))(None, torch.from_numpy(f0).to(dtype),
                        torch.from_numpy(f1).to(dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("factor,quality", [(2, "balanced"), (4, "balanced"),
                                            (2, "high")])
def test_double_matches_jax(jax_handler, factor, quality):
    """``interpolate_frames`` (``_double`` once or twice, bf16) against the
    JAX handler's ``_double`` on the same frames, over 255 and rounded."""
    frames = synthetic_clip(3, 24, 40)
    clip = np.stack(frames).astype(np.float32) / 255.0
    for _ in range(factor // 2):
        clip = jax_handler._double(clip, multiscale=quality == "high")
    want = np.clip(np.round(clip * 255.0), 0, 255)
    handler = RIFEHandler(device="cpu")
    got = np.stack(handler.interpolate_frames(frames, factor, quality))
    assert got.shape == want.shape == (2 * factor + 1,
                                       24, 40, 3)
    assert handler.blend_fallbacks == 0
    d = np.abs(got.astype(np.float32) - want)
    assert d.max() <= 2 and d.mean() <= 0.02, (d.max(), d.mean())
    np.testing.assert_array_equal(got[::factor], np.stack(frames))


def test_official_ifnet_pth(tmp_path):
    """A torch IFNet (c 16, ``lastconv`` scaled up so the flows move) saved
    as a ``.pth`` serves through ``official_ckpt`` at full strength: every
    leaf filled, the ConvTranspose2d weight in its own layout, and the
    midpoints meet the module's and the JAX package's (fp32)."""
    torch.manual_seed(0)
    module = IFNet(c=16).eval()
    with torch.no_grad():
        for blk in (module.block0, module.block1, module.block2):
            blk.lastconv.weight.mul_(8.0)
    path = tmp_path / "flownet.pth"
    torch.save(module.state_dict(), path)
    handler = RIFEHandler(official_ckpt=str(path), official_c=16,
                          dtype=torch.float32, device="cpu")
    assert handler.meta["official"] is True
    torch.testing.assert_close(handler.params["block1"]["lastconv"]["w"],
                               module.block1.lastconv.weight)
    jp, _, skipped = unflatten_into(
        jax.eval_shape(lambda: jofficial.ifnet_official_init(
            jax.random.PRNGKey(0), c=16)),
        convert_torch_state_dict(module.state_dict()))
    assert not skipped
    g = np.random.default_rng(1)
    f0, f1 = (g.random((1, 32, 32, 3), dtype=np.float32) for _ in range(2))
    got = handler.interpolate_pair(f0[0], f1[0])
    with torch.no_grad():
        own = module(torch.from_numpy(f0).permute(0, 3, 1, 2),
                     torch.from_numpy(f1).permute(0, 3, 1, 2))
    want = np.asarray(jax.jit(jofficial.ifnet_official_apply)(jp, f0, f1))
    np.testing.assert_allclose(got, own[0].permute(1, 2, 0).numpy(),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(got, want[0], atol=1e-4, rtol=0)
    assert RIFEHandler(device="cpu").meta.get("official") is None


def test_blend_fallback_is_counted(monkeypatch):
    """A failing model falls back to each pair's average, as in the JAX
    handler, and is counted on the handler and in the route's stats."""
    def fail(*a, **kw):
        raise RuntimeError("rife failed on purpose")

    monkeypatch.setattr(rife, "interpolate_pair", fail)
    handler = RIFEHandler(device="cpu")
    clip = torch.from_numpy(_clip(3, 8, 8))
    out = handler._double(clip)
    assert handler.blend_fallbacks == 1
    torch.testing.assert_close(out[1::2], 0.5 * clip[:-1] + 0.5 * clip[1:])
    frames, stats = tpipeline.run_auto_frames(dim_clip(4, 16, 16),
                                              enable_hfr=True, device="cpu")
    assert len(frames) == 7 and stats["hfr"] is True
    assert stats["hfr_blend_fallbacks"] == 1


def test_run_auto_frames_hfr_stage_matches_jax(monkeypatch, jax_handler):
    """``enable_hfr=True``: the plan holds the stage after temporal
    consistency, 2T - 1 frames come out, the stats say ``hfr`` with its
    time and no error; the frames are the JAX handler's ``_double`` of the
    stage's input over 255, rounded, within 1 LSB."""
    seen = []
    real = tpipeline.hfr_frames

    def spy(frames, device):
        seen.append(np.stack(frames))
        return real(frames, device)

    monkeypatch.setattr(tpipeline, "hfr_frames", spy)
    out, stats = tpipeline.run_auto_frames(dim_clip(6, 24, 32),
                                           enable_hfr=True, device="cpu")
    order = stats["routing_plan"]["processing_order"]
    assert order[-2:] == ["temporal_consistency", "hfr_interpolation"]
    assert stats["hfr"] is True and stats["hfr_interpolation_sec"] > 0
    assert "hfr_interpolation_error" not in stats
    assert "hfr_blend_fallbacks" not in stats
    assert len(out) == 11 and len(seen) == 1
    clip = seen[0].astype(np.float32) / 255.0
    want = np.clip(np.round(jax_handler._double(clip) * 255.0), 0, 255)
    d = np.abs(np.stack(out).astype(np.float32) - want)
    assert d.max() <= 1, d.max()
    np.testing.assert_array_equal(np.stack(out)[0::2], seen[0])
