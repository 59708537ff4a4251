"""The port's train CLI (video_enhancer_tpu_torch/train/cli.py) on the CPU,
and against the JAX package's (video_enhancer_tpu/train/cli.py).

- A tiny cnn_upscaler run logs steps [2, 4], exports, checkpoints and
  warm-starts, as tests/test_train_cli.py runs JAX's.
- Parity: both CLIs from the same ``--init-npz`` (JAX's init saved by
  JAX's ``save_params``) with the same flags on the default mixed bank and
  mixture. The WebP round trip of the chain family is replaced on the
  port's side by OpenCV's (``monkeypatch`` of ``train.data.
  webp_roundtrip``), which holds the data path apart from the codec. Each
  step's loss (read from the train step, not the 5-decimal log) within
  1e-5 relative of JAX's, plain and with ``--through-calibration`` and
  ``--correction-penalty``.
- ``build_model``'s parameter keys and shapes, in the JAX package's
  layouts, equal JAX's for all 8 models at tiny widths (``jax.eval_shape``
  on JAX's side: no forward).
- One ``--mesh-data 2`` run on two gloo ranks.
"""

import json

import cv2
import jax
import numpy as np
import pytest

from video_enhancer_tpu.train import cli as jcli
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      to_jax_layout)
from video_enhancer_tpu_torch.train import cli as tcli

FLAGS = ["--model", "cnn_upscaler", "--batch", "1", "--clip-len", "2",
         "--crop", "32", "--scale", "2", "--log-every", "2"]


def _logs(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{") and '"step"' in line]


def test_train_cli_tiny_run_and_warm_start(tmp_path, capsys):
    export = tmp_path / "w.npz"
    assert tcli.main(FLAGS + ["--steps", "4", "--export", str(export),
                              "--ckpt-dir", str(tmp_path / "ck"),
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    logs = _logs(out)
    assert [entry["step"] for entry in logs] == [2, 4]
    assert all(np.isfinite(entry["loss"]) for entry in logs)
    assert export.stat().st_size > 0
    timing = json.loads(out.strip().splitlines()[-1])["timing"]
    assert timing["steps"] == 4 and timing["data_sec_per_batch"] > 0
    assert tcli.main(FLAGS + ["--steps", "6", "--init-npz", str(export),
                              "--ckpt-dir", str(tmp_path / "ck"),
                              "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "warm-started" in out and "resumed from step 4" in out
    assert [entry["step"] for entry in _logs(out)] == [6]


def _recording(module, monkeypatch):
    """Each step's loss, read from the train step that ``main`` builds."""
    seen, make = [], module.make_train_step

    def wrapped(*a, **kw):
        init_state, step, shard = make(*a, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            seen.append(float(metrics["loss"]))
            return state, metrics
        return init_state, recorded, shard

    monkeypatch.setattr(module, "make_train_step", wrapped)
    return seen


def _cv2_webp(img, q):
    ok, enc = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


@pytest.mark.parametrize("extra", [
    [], ["--through-calibration", "cnn_upscaler", "--correction-penalty",
         "0.5"]], ids=["plain", "calibrated_penalty"])
def test_cli_losses_match_jax(tmp_path, monkeypatch, capsys, extra):
    from video_enhancer_tpu.runtime.weights import save_params
    from video_enhancer_tpu.train import step as jstep
    from video_enhancer_tpu_torch.train import data as tdata
    from video_enhancer_tpu_torch.train import step as tstep

    params, _ = jcli.build_model("cnn_upscaler", 2, dim=16)
    save_params(tmp_path / "init.npz", params)
    flags = FLAGS + ["--steps", "4", "--dim", "16", "--init-npz",
                     str(tmp_path / "init.npz"), *extra]
    ref = _recording(jstep, monkeypatch)
    jcli.main(flags + ["--platform", "cpu"])
    monkeypatch.setattr(tdata, "webp_roundtrip", _cv2_webp)
    got = _recording(tstep, monkeypatch)
    tcli.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("warm-started") == 2
    assert len(ref) == len(got) == 4
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _shapes(tree, prefix=""):
    """The JAX package's flat keys (runtime/weights.py flatten_params) of
    a tree of shapes."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _shapes(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("name", tcli.MODELS)
def test_build_model_keys_and_shapes_match_jax(name):
    kw = {"dim": 16, "layers": 2}
    if name in ("seedvr2", "rife"):
        kw = {"dim": 8} if name == "seedvr2" else {"dim": 8, "layers": 2}
    if name == "ditvr":
        kw = {"dim": 24, "layers": 1, "heads": 2}
    scale = 1 if name in ("seedvr2", "ditvr", "rife") else 2
    ref = jax.eval_shape(lambda: jcli.build_model(name, scale, **kw)[0])
    params, _ = tcli.build_model(name, scale, **kw)
    got = {k: to_jax_layout(k, v).shape
           for k, v in flatten_params(params).items()}
    assert got == _shapes(ref)


def test_cli_mesh_data_2_on_gloo(capsys):
    assert tcli.main(["--model", "cnn_upscaler", "--dim", "8", "--steps",
                      "2", "--batch", "2", "--clip-len", "2", "--crop", "32",
                      "--scale", "2", "--log-every", "1", "--content",
                      "demo", "--device", "cpu", "--mesh-data", "2"]) == 0
    logs = _logs(capsys.readouterr().out)
    assert [entry["step"] for entry in logs] == [1, 2]
    assert all(np.isfinite(entry["loss"]) for entry in logs)
