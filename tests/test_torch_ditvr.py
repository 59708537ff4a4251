"""The port's ditvr, its checkpoint, its calibrated blend and the handler's
degradation context against the JAX package's, on the CPU.

The bundled ``ditvr_1x.npz`` (dim 384, depth 8, 3 adapters) runs at fp32
on both sides on a tiny clip (8 frames of 32x32: 256 tokens) with heads 3,
as served. Tolerance 1e-5 absolute on outputs in [0, 1]: both sides compute
in fp32 at full matmul precision and differ only in the order of sums
(the measured gap is ~1e-6). The handler is compared at 1e-4 (tile blends
on top).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.models import ditvr as jditvr
from video_enhancer_tpu.nn.core import sinusoidal_embedding as j_sin
from video_enhancer_tpu.runtime import calibration as jcal
from video_enhancer_tpu.runtime import vsr_handler as jvh
from video_enhancer_tpu.runtime.weights import (flatten_params,
                                                try_load_params,
                                                unflatten_into)
from video_enhancer_tpu_torch.models import ditvr as tditvr
from video_enhancer_tpu_torch.nn import sinusoidal_embedding as t_sin
from video_enhancer_tpu_torch.runtime import calibration as tcal
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime import weights as tweights
from video_enhancer_tpu_torch.runtime.vsr_handler import VSRHandler

TOL = 1e-5
NPZ = (Path(__file__).resolve().parents[1] / "video_enhancer_tpu" / "weights"
       / "ditvr_1x.npz")
HEADS = 3        # as served (config/policy_v1.yaml:101)


@pytest.fixture(scope="module")
def bundled():
    jp, _ = jditvr.init(jax.random.PRNGKey(0), dim=384, depth=8, heads=HEADS)
    jp = try_load_params(NPZ, jp)
    return jp, registry.load_params("ditvr")


def test_bundled_checkpoint_fills_every_leaf():
    """All 130 arrays are taken and no leaf keeps its initial value
    (load_into is lenient, so a silent mismatch would keep random init)."""
    flat = tweights.read_npz(NPZ)
    assert len(flat) == 130
    template = tditvr.init(torch.Generator().manual_seed(0))
    filled, matched, skipped = tweights.load_into(
        template, tweights.params_from_jax(flat))
    assert len(matched) == 130 and not skipped
    init_flat = tweights.flatten_params(template)
    for key, val in tweights.flatten_params(filled).items():
        assert not torch.equal(val, init_flat[key]), key
    assert filled["blocks"][7]["qkv"]["w"].shape == (1152, 384)
    assert "b" not in filled["blocks"][0]["qkv"]
    np.testing.assert_array_equal(filled["blocks"][3]["adaln"]["w"].numpy(),
                                  flat["blocks.3.adaln.w"].T)
    np.testing.assert_array_equal(filled["deg_type_embed"].numpy(),
                                  flat["deg_type_embed"])
    np.testing.assert_array_equal(filled["adapters"][2]["proto"].numpy(),
                                  flat["adapters.2.proto"])


@pytest.mark.parametrize("deg_type", ["unknown", "noise", "blur",
                                      "compression"])
def test_bundled_weights_match_jax(bundled, deg_type):
    jp, tp = bundled
    clip = np.random.default_rng(0).random((1, 8, 32, 32, 3),
                                           dtype=np.float32)
    scores = (0.19, 0.998, 0.9999)
    want = np.asarray(jditvr.apply(jp, jnp.asarray(clip),
                                   degradation_type=deg_type,
                                   degradation_scores=scores, heads=HEADS))
    with torch.inference_mode():
        got = tditvr.apply(tp, torch.from_numpy(clip),
                           degradation_type=deg_type,
                           degradation_scores=scores, heads=HEADS).numpy()
    assert got.shape == (1, 8, 32, 32, 3)
    assert np.abs(want - clip).max() > 1e-2       # the model does something
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_padding_of_t_h_w_matches_jax(bundled):
    """T, H and W that are not multiples of the patch (2, 4, 4) are
    edge-padded and cropped back; the type given as an index tensor."""
    jp, tp = bundled
    clip = np.random.default_rng(1).random((2, 5, 18, 30, 3),
                                           dtype=np.float32)
    want = np.asarray(jditvr.apply(jp, jnp.asarray(clip), degradation_type=1,
                                   degradation_scores=(0.5, 0.1, 0.2),
                                   heads=HEADS))
    with torch.inference_mode():
        got = tditvr.apply(tp, torch.from_numpy(clip),
                           degradation_type=torch.tensor(1),
                           degradation_scores=torch.tensor([0.5, 0.1, 0.2]),
                           heads=HEADS).numpy()
    assert got.shape == (2, 5, 18, 30, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _jax_small(seed):
    """A narrow JAX ditvr whose zero-initialised head and adapter ups are
    filled, so that the residual and the adapters act."""
    jp, _ = jditvr.init(jax.random.PRNGKey(seed), dim=64, depth=3, heads=2,
                        adapt_layers=2)
    g = np.random.default_rng(seed)
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    for k in flat:
        if k.startswith("head.") or ".up." in k:
            flat[k] = (g.standard_normal(flat[k].shape) * 0.1).astype(
                np.float32)
    jp, matched, _ = unflatten_into(jp, flat)
    assert len(matched) == len(flat)
    return jp, tweights.params_from_jax(flat)


@pytest.mark.parametrize("auto_adapt", [True, False])
def test_random_init_matches_jax(auto_adapt):
    jp, tp = _jax_small(3)
    clip = np.random.default_rng(3).random((1, 4, 12, 20, 3),
                                           dtype=np.float32)
    want = np.asarray(jditvr.apply(jp, jnp.asarray(clip),
                                   degradation_type="blur", heads=2,
                                   auto_adapt=auto_adapt))
    got = tditvr.apply(tp, torch.from_numpy(clip), degradation_type="blur",
                       heads=2, auto_adapt=auto_adapt).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_port_init_has_jax_shapes():
    jp, _ = jditvr.init(jax.random.PRNGKey(0), dim=64, depth=2, heads=2,
                        adapt_layers=1)
    want = {k: tuple(tweights.convert_array(k, np.asarray(v)).shape)
            for k, v in flatten_params(jp).items()}
    tp = tditvr.init(torch.Generator().manual_seed(0), dim=64, depth=2,
                     adapt_layers=1)
    got = {k: tuple(v.shape) for k, v in tweights.flatten_params(tp).items()}
    assert got == want
    # the zero-initialised head makes an untrained model the identity
    clip = torch.rand((1, 2, 8, 8, 3), generator=torch.Generator()
                      .manual_seed(0))
    torch.testing.assert_close(tditvr.apply(tp, clip), clip, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dim", [6, 7, 96])
def test_sinusoidal_embedding_matches_jax(dim):
    t = np.arange(11, dtype=np.float32) * 3.5
    want = np.asarray(j_sin(jnp.asarray(t), dim))
    got = t_sin(torch.from_numpy(t), dim).numpy()
    assert got.shape == (11, dim)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_calibrate_restore_matches_jax():
    """out = clip(s * model + (1 - s) * x) with ditvr's s = 0.5."""
    x = np.random.default_rng(4).random((1, 2, 4, 4, 3), dtype=np.float32)
    y = np.random.default_rng(5).random((1, 2, 4, 4, 3), dtype=np.float32)
    want = jcal.calibrate_restore("ditvr", lambda p, a: jnp.asarray(y) * 1.5
                                  - 0.2)(None, jnp.asarray(x))
    got = tcal.calibrate_restore("ditvr", lambda p, a: torch.from_numpy(y)
                                 * 1.5 - 0.2)(None, torch.from_numpy(x))
    assert tcal.strength_for("ditvr") == jcal.strength_for("ditvr") == 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=0)


def _ditvr_handlers(jp, tp, tile, tile_overlap):
    def japply(p, x, degradation_scores, degradation_type):
        return jditvr.apply(p, x, degradation_type=degradation_type,
                            degradation_scores=degradation_scores, heads=2)

    def tapply(p, x, degradation_scores, degradation_type):
        return tditvr.apply(p, x, degradation_type=degradation_type,
                            degradation_scores=degradation_scores, heads=2)

    jh = jvh.VSRHandler(
        "ditvr", jcal.calibrate_restore("ditvr", japply), jp, scale=1,
        chunk=8, overlap=2, tile=tile, tile_overlap=tile_overlap,
        compute_dtype=jnp.float32,
        context={"degradation_scores": jnp.zeros((3,), jnp.float32),
                 "degradation_type": jnp.zeros((), jnp.int32)})
    th = VSRHandler(
        "ditvr", tcal.calibrate_restore("ditvr", tapply), tp, scale=1,
        chunk=8, overlap=2, tile=tile, tile_overlap=tile_overlap,
        dtype=torch.float32, device="cpu",
        context={"degradation_scores": torch.zeros(3),
                 "degradation_type": torch.zeros((), dtype=torch.int64)})
    return jh, th


@pytest.mark.parametrize("tile", [16, 64])
def test_handler_context_reaches_every_tile(tile):
    """update_context conditions every forward, tiled or not, as in the
    JAX handler."""
    jp, tp = _jax_small(6)
    jh, th = _ditvr_handlers(jp, tp, tile=tile, tile_overlap=4)
    for h in (jh, th):
        h.update_context(degradation_scores=[0.2, 0.7, 0.4],
                         degradation_type=2)
    assert th.context["degradation_type"].dtype == torch.int64
    assert th.context["degradation_scores"].tolist() == pytest.approx(
        [0.2, 0.7, 0.4])
    clip = np.random.default_rng(6).random((8, 24, 36, 3), dtype=np.float32)
    want = np.asarray(jh.process_clip(jnp.asarray(clip)))
    got = th.process_clip(torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    th.update_context(degradation_type=0)
    assert np.abs(th.process_clip(torch.from_numpy(clip)).numpy()
                  - got).max() > 1e-4


def test_build_handler_serves_bundled_ditvr():
    h = registry.build_handler("ditvr", device="cpu")
    assert (h.scale, h.chunk, h.overlap, h.tile, h.tile_overlap) == \
        (1, 8, 2, 224, 16)
    assert h.dtype == torch.bfloat16 and len(h.params["blocks"]) == 8
    assert bool(h.context)
    assert h.context["degradation_scores"].shape == (3,)
    assert h.context["degradation_type"].shape == ()
    h.update_context(degradation_scores=(0.1, 0.2, 0.3), degradation_type=3,
                     unknown_key=1.0)
    assert int(h.context["degradation_type"]) == 3
    assert "unknown_key" not in h.context
