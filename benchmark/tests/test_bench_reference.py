"""The plain references against the port's plain path, at tiny widths on
the CPU: the models alone, and the whole streaming handler (windows,
overlap selection, padded tail, tiles, ramp blend, calibrated blend,
uint8 rounding)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import plain
from vebench import manifest

VSRM = manifest.reference("vsrm-x4")
DITVR = manifest.reference("ditvr-restore")
CTX = {"degradation_scores": [0.2, 0.7, 0.1], "degradation_type": 2}


def _vsrm_port():
    from video_enhancer_tpu_torch.models import vsrm
    from video_enhancer_tpu_torch.runtime.calibration import calibrate_vsr

    params = vsrm.init(torch.Generator().manual_seed(3), dim=16,
                       num_blocks=2)
    # the zero-initialised head and offsets leave the model a bicubic copy
    gen = torch.Generator().manual_seed(4)
    for key in ("head", "offset"):
        params[key]["w"] = torch.randn(params[key]["w"].shape,
                                       generator=gen) * 0.05
    fn = calibrate_vsr("vsrm", lambda p, x: vsrm.apply(p, x, kernels=False))
    return params, fn


def _ditvr_port():
    from video_enhancer_tpu_torch.models import ditvr
    from video_enhancer_tpu_torch.runtime.calibration import calibrate_restore

    params = ditvr.init(torch.Generator().manual_seed(5), dim=48, depth=2,
                        adapt_layers=1)
    gen = torch.Generator().manual_seed(6)
    for leaf in (params["head"], params["adapters"][0]["up"]):
        leaf["w"] = torch.randn(leaf["w"].shape, generator=gen) * 0.05

    def apply(p, x, degradation_scores, degradation_type):
        return ditvr.apply(p, x, heads=3, kernels=False,
                           degradation_scores=degradation_scores,
                           degradation_type=degradation_type)

    return params, calibrate_restore("ditvr", apply)


def test_models_agree():
    clip = torch.rand(2, 7, 12, 20, 3, generator=torch.Generator()
                      .manual_seed(1))
    params, fn = _vsrm_port()
    with torch.no_grad():
        ref = VSRM.forward(params, clip, plain.Ops("fp32"))
        got = fn(params, clip)
    assert (ref - got).abs().max() < 2e-5
    clip = torch.rand(2, 8, 16, 20, 3, generator=torch.Generator()
                      .manual_seed(2))
    params, fn = _ditvr_port()
    with torch.no_grad():
        ref = DITVR.forward(params, clip, plain.Ops("fp32"), CTX)
        got = fn(params, clip, degradation_scores=torch.tensor(CTX[
            "degradation_scores"]), degradation_type=torch.tensor(2))
    assert (ref - got).abs().max() < 2e-5


@pytest.mark.parametrize("model", ["vsrm", "ditvr"])
def test_streaming_handler_agrees(model):
    """The port's handler in float32 (tiles of 16 overlapping by 4, windows
    and strides of the served configurations) against the reference's own
    windows, tiles and blends, frame by frame, in uint8."""
    from video_enhancer_tpu_torch.runtime.vsr_handler import VSRHandler

    if model == "vsrm":
        params, fn = _vsrm_port()
        ref, ctx, scale, window, stride = VSRM, None, 4, 7, 3
    else:
        params, fn = _ditvr_port()
        ref, ctx, scale, window, stride = DITVR, CTX, 1, 8, 6
    handler = VSRHandler(model, fn, params, scale=scale, chunk=window,
                         overlap=window - stride, tile=16, tile_overlap=4,
                         dtype=torch.float32, device="cpu",
                         context={k: torch.as_tensor(v)
                                  for k, v in (ctx or {}).items()})
    frames = (np.random.default_rng(7).random((17, 24, 36, 3))
              * 255).astype(np.uint8)
    got = np.stack(list(handler.enhance_frames(iter(frames))))
    assert got.shape == (17, 24 * scale, 36 * scale, 3)
    want = []
    with torch.no_grad():
        for start, idx, emitted in plain.windows(len(frames), window,
                                                 stride):
            clip = torch.from_numpy(frames[idx]).float() / 255.0
            out = plain.run_window(
                lambda b: ref.forward(params, b, plain.Ops("fp32"), ctx),
                clip, scale=scale, tile=16, tile_overlap=4)
            want.append(plain.to_u8(out[[f - start for f in emitted]]))
    want = torch.cat(want).numpy()
    assert want.shape == got.shape
    diff = np.abs(want.astype(int) - got.astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("name", ["vsrm-x4", "ditvr-restore"])
def test_configured_sizes_are_the_checkpoints(name):
    """A configuration's ``sizes`` are read off its checkpoint as the
    reference loads it, and a size that departs stops the load."""
    ref = manifest.reference(name)
    cfg = manifest.config(manifest.load(), name)
    params = ref.load(cfg, "cpu")
    assert ref.sizes(params) == cfg["sizes"]
    for key in cfg["sizes"]:
        bad = dict(cfg, sizes={**cfg["sizes"], key: -1})
        with pytest.raises(ValueError, match=key):
            plain.check_sizes(bad, ref.sizes(params))
