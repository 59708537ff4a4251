"""The port's CLI (video_enhancer_tpu_torch/cli.py) against the JAX package's,
both run in this process on the same raw ``.avi`` files:

- ``metadata`` prints the JAX CLI's JSON exactly; ``eval`` prints its keys
  with values within 1e-5 relative (fp32 sums in another order, and the
  cubic resize of the reference ~1e-6 apart), at one size and with the
  reference resized;
- ``enhance --engine bicubic|cnn --device cpu`` writes frames within 1 LSB
  of the JAX handler's in-memory output on the same frames and weights (the
  JAX CLI writes mp4v, which is lossy, so its files are not compared). The
  CNN runs in fp32 on both sides here: in bf16, as both CLIs serve it,
  XLA's and torch's bf16 convs round apart and 215 of these 46,080 values
  read 2 LSB apart (the handler test holds the CNN in fp32 likewise);
- ``demo`` writes the JAX package's frames bit for bit outside the label's
  box (``io.demo.LABEL_BOX``, ``cv2.getTextSize`` of the label), with ink
  inside it.

The JAX CLI's persistent-cache set-up (utils/jaxenv.py) is skipped: it
writes a cache beside the package.
"""

from __future__ import annotations

import functools
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu import cli as jcli
from video_enhancer_tpu.io.demo import make_demo_frames as j_demo_frames
from video_enhancer_tpu.runtime.upscaler_handler import \
    CnnUpscalerHandler as JCnn
from video_enhancer_tpu.utils import jaxenv
from video_enhancer_tpu_torch import cli as tcli
from video_enhancer_tpu_torch.io import demo as tdemo
from video_enhancer_tpu_torch.io.video import read_video, write_video
from video_enhancer_tpu_torch.runtime import registry, upscaler_handler

CNN_NPZ = registry.WEIGHTS_DIR / "cnn_upscaler_2x.npz"


def _json(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def no_jax_cache(monkeypatch):
    monkeypatch.setattr(jaxenv, "setup", lambda *a, **k: None)


def test_metadata_and_eval_print_the_jax_json(tmp_path, capsys,
                                              no_jax_cache):
    ref = tdemo.write_demo_video(tmp_path / "ref.avi", frames=6,
                                 size_hw=(32, 48))
    frames = read_video(ref)
    noisy = np.clip(frames.astype(np.int16) + np.random.default_rng(0)
                    .integers(-9, 10, frames.shape), 0, 255).astype(np.uint8)
    same = write_video(tmp_path / "same.avi", noisy[:5], fps=24.0)
    big = write_video(tmp_path / "big.avi",
                      np.stack([cv2.resize(f, (96, 64)) for f in noisy]),
                      fps=25.0)
    for path in (ref, big):
        assert _json(tcli.main, ["metadata", path], capsys) == \
            _json(jcli.main, ["metadata", path], capsys)
    for out in (same, big):
        got = _json(tcli.main, ["eval", out, ref, "--device", "cpu"], capsys)
        want = _json(jcli.main, ["eval", out, ref], capsys)
        assert set(got) == set(want) == {"psnr", "ssim",
                                         "temporal_consistency"}
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=0), k


@pytest.mark.parametrize("engine", ["bicubic", "cnn"])
def test_enhance_within_one_lsb_of_the_jax_handler(tmp_path, capsys,
                                                   monkeypatch, engine):
    """10 frames in batches of 4 (a padded tail); the CNN with the bundled
    cnn_upscaler_2x.npz on both sides, in fp32."""
    src = tdemo.write_demo_video(tmp_path / "in.avi", frames=10,
                                 size_hw=(16, 24))
    cnn = engine == "cnn"
    if cnn:
        monkeypatch.setattr(upscaler_handler, "CnnUpscalerHandler",
                            functools.partial(
                                upscaler_handler.CnnUpscalerHandler,
                                weights_path=CNN_NPZ, dtype=torch.float32))
    stats = _json(tcli.main, ["enhance", src, str(tmp_path / "out.avi"),
                              "--engine", engine, "--batch", "4",
                              "--device", "cpu"], capsys)
    assert stats["frames_processed"] == 10 and stats["scale"] == 2
    assert stats["audio"] == "dropped (no ffmpeg)"
    got = read_video(tmp_path / "out.avi").astype(np.int16)
    jh = JCnn(scale=2, use_cnn=cnn,
              weights_path=str(CNN_NPZ) if cnn else None,
              compute_dtype=jnp.float32)
    clip = jnp.asarray(read_video(src).astype(np.float32) / 255.0)
    want = np.clip(np.round(np.asarray(jh.enhance_frames(clip)) * 255),
                   0, 255).astype(np.int16)
    assert got.shape == want.shape == (10, 32, 48, 3)
    assert np.abs(got - want).max() <= 1


def test_demo_matches_jax_outside_the_label_box(tmp_path, capsys):
    n, h, w = 6, 64, 120
    res = _json(tcli.main, ["demo", str(tmp_path / "d.avi"), "--frames",
                            str(n), "--height", str(h), "--width", str(w)],
                capsys)
    assert res["status"] == "success"
    got, want = read_video(tmp_path / "d.avi"), j_demo_frames(n, (h, w))
    x0, y0, x1, y1 = tdemo.LABEL_BOX
    for t in range(n):
        (tw, th), base = cv2.getTextSize(f"frame {t:03d}",
                                         cv2.FONT_HERSHEY_SIMPLEX, 0.6, 1)
        assert (x0, y0, x1, y1) == (8, 24 - th, 8 + tw, 24 + base)
    outside = np.ones((h, w), bool)
    outside[y0:y1, x0:x1] = False
    np.testing.assert_array_equal(got[:, outside], want[:, outside])
    ink = (got[:, y0:y1, x0:x1] == 255).all(-1).sum((1, 2))
    assert (ink > 50).all()
