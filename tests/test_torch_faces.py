"""The port's face detection against OpenCV and the JAX package, on the CPU.

- The cv2 counterparts (``resize_area``, ``rgb_to_ycrcb``, ``morph_close``,
  ``connected_components``, ``laplacian``) equal cv2 5 bit for bit on
  uint8 input (the Laplacian on integer-valued fp32, where every sum is
  exact); ``gaussian_blur`` (fp64 passes, fp32 out) is held to cv2's fp32
  blur at 1e-4 on [0, 255].
- ``face_net.apply`` with the bundled weights is held to the JAX net at
  1e-4 absolute on the head's logits (both fp32; measured ~2e-6).
- ``detect_faces`` gives the JAX chain's boxes in the same order on
  procedural face scenes (``make_face_scenes``) and the seeded face clip of
  chip_smoke.py, through both tiers (the neural detector and the skin-blob
  fall-through). A frame whose heatmap peak lies within 1e-4 of the 0.45
  threshold would be reported and not compared; none of these does.
- ``face_area_ratio`` equals JAX's, ``face_chain_trusted`` too, also where
  ``FACE_DETECTOR_ONNX`` names a model the JAX chain cannot open (the YuNet
  tier, which the port does not have).
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.analysis import face_net as jface_net
from video_enhancer_tpu.analysis import faces as jfaces
from video_enhancer_tpu.runtime.weights import try_load_params as jload
from video_enhancer_tpu.train.face_detector import make_face_scenes
from video_enhancer_tpu_torch.analysis import face_net, faces
from video_enhancer_tpu_torch.ops.color import rgb_to_ycrcb
from video_enhancer_tpu_torch.ops.imgproc import (connected_components,
                                                  laplacian, morph_close)
from video_enhancer_tpu_torch.ops.optflow import gaussian_blur
from video_enhancer_tpu_torch.ops.resize import resize_area
from video_enhancer_tpu_torch.runtime.weights import flatten_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import face_clip  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("hw", [
    (256, 256),      # integer factor 2 on both axes: (s + 2) >> 2
    (384, 512),      # integer factors 3 and 4: float(s) * (1 / area)
    (720, 1280),     # 5.625 x 10: area weights, fractional on one axis
    (180, 320),      # 1.40625 x 2.5
    (100, 200),      # a side below 128: cv2's linear route
    (48, 64),        # both sides below 128
    (128, 128),      # the size itself: a copy
])
def test_resize_area_matches_cv2(hw):
    frame = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    want = cv2.resize(frame, (128, 128), interpolation=cv2.INTER_AREA)
    got = resize_area(torch.from_numpy(frame), (128, 128)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rgb_to_ycrcb_matches_cv2_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    for part in np.split(v, 16):
        img = np.stack([(part >> 16) & 255, (part >> 8) & 255, part & 255],
                       -1).astype(np.uint8).reshape(1024, 1024, 3)
        want = cv2.cvtColor(img, cv2.COLOR_RGB2YCrCb)
        np.testing.assert_array_equal(
            rgb_to_ycrcb(torch.from_numpy(img)).numpy(), want)


def _masks():
    g = np.random.default_rng(0)
    out = [(g.random(g.integers(1, 70, 2)) < p).astype(np.uint8) * 255
           for p in (0.05, 0.2, 0.4, 0.6) for _ in range(10)]
    # a component met first in a block's lower row left of another's upper
    # row: cv2's 2x2 blocks number it first, a raster scan second
    m = np.zeros((6, 12), np.uint8)
    m[0, 8:11] = m[1, 2:4] = 255
    return out + [m]


def test_morph_close_matches_cv2():
    for m in _masks():
        want = cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8),
                                iterations=2)
        np.testing.assert_array_equal(
            morph_close(torch.from_numpy(m)).numpy(), want)


def test_connected_components_match_cv2_labels_and_order():
    for m in _masks():
        n, _, stats, _ = cv2.connectedComponentsWithStats(m)
        got_n, got = connected_components(m)
        assert got_n == n
        np.testing.assert_array_equal(got[1:], stats[1:])
        if (m == 0).any():
            np.testing.assert_array_equal(got[0], stats[0])
    # the block order is cv2's, and not scipy's raster order
    assert connected_components(m)[1][1, 0] == 2


def test_laplacian_and_blur_match_cv2():
    g = np.random.default_rng(1)
    for hw in [(2, 2), (5, 7), (64, 48)]:
        img = g.integers(0, 256, hw).astype(np.float32)
        np.testing.assert_array_equal(
            laplacian(torch.from_numpy(img)).numpy(),
            cv2.Laplacian(img, cv2.CV_32F))
        blur = gaussian_blur(torch.from_numpy(img), 5, 1.5).numpy()
        np.testing.assert_allclose(blur, cv2.GaussianBlur(img, (5, 5), 1.5),
                                   atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_detector():
    """The JAX detector's parameters and jitted forward, also set as the
    JAX chain's lazily loaded tier. Its template is traced, not drawn: the
    bundled file fills every leaf, and eager random inits cost seconds."""
    template = jax.eval_shape(jface_net.init, jax.random.PRNGKey(0))
    params = jload(faces.DETECTOR_WEIGHTS, template)
    fwd = jax.jit(jface_net.apply)
    if jfaces._nn is None and not jfaces._nn_failed:
        jfaces._nn = (params, fwd)
    return params, fwd


def test_detector_weights_fill_every_leaf():
    from video_enhancer_tpu_torch.runtime.weights import (load_into,
                                                          params_from_jax,
                                                          read_npz)

    template = face_net.init(torch.Generator().manual_seed(0))
    _, matched, skipped = load_into(template, params_from_jax(
        read_npz(faces.DETECTOR_WEIGHTS)))
    assert not skipped and len(matched) == len(flatten_params(template))


def test_face_net_apply_matches_jax(jax_detector):
    jparams, jfwd = jax_detector
    x = np.random.default_rng(2).random((2, 128, 128, 3), dtype=np.float32)
    want = np.asarray(jfwd(jparams, jnp.asarray(x)))
    got = face_net.apply(faces.nn_detector(CPU), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _frames() -> list[np.ndarray]:
    """Face scenes at three sizes, each also stretched to twice its width
    (cv2's linear route and its area route into the net), and chip_smoke's
    face clip at two sizes (the skin-blob tier on the small one)."""
    out = []
    for size, n, seed in [(128, 8, 1), (200, 5, 2), (96, 4, 3)]:
        imgs, _ = make_face_scenes(n, size=size, seed=seed)
        for img in imgs:
            f = (img * 255).astype(np.uint8)
            out += [f, cv2.resize(f, (2 * size, size),
                                  interpolation=cv2.INTER_LINEAR)]
    return out + face_clip(2, 180, 320) + face_clip(2, 48, 64)


FRAMES = _frames()


def test_detect_faces_matches_jax(jax_detector):
    jparams, jfwd = jax_detector
    tiers = {"nn": 0, "skin": 0, "none": 0}
    near = []
    for i, f in enumerate(FRAMES):
        head = np.asarray(jfwd(jparams, jnp.asarray(
            cv2.resize(f, (128, 128), interpolation=cv2.INTER_AREA)[None]
            .astype(np.float32) / 255.0)))[0]
        heat = 1.0 / (1.0 + np.exp(-head[..., 0]))
        if np.any(np.abs(heat - 0.45) < 1e-4):
            near.append(i)      # a decision at the threshold: not compared
            continue
        want = jfaces.detect_faces(f)
        assert faces.detect_faces(f, CPU) == want, i
        nn_boxes = jface_net.detect(jparams, f, forward=jfwd)
        tiers["nn" if nn_boxes else "skin" if want else "none"] += 1
    assert near == [], f"frames {near} peak within 1e-4 of the threshold"
    assert tiers["nn"] >= 10 and tiers["skin"] >= 2, tiers


def test_skin_blob_faces_match_jax(jax_detector):
    for f in FRAMES[::3] + face_clip(2, 60, 80, seed=4):
        assert faces.skin_blob_faces(f, CPU) == jfaces._skin_blob_faces(f)


def test_face_area_ratio_matches_jax(jax_detector):
    imgs, _ = make_face_scenes(9, size=160, seed=6)
    clip = (imgs * 255).astype(np.uint8)
    for frames in (clip, np.stack(face_clip(12, 64, 96)), clip[:2]):
        want = jfaces.face_area_ratio(frames)
        assert faces.face_area_ratio(frames, device=CPU) == want
        assert faces.face_area_ratio(torch.from_numpy(frames),
                                     device=CPU) == want
    assert want > 0


def test_face_chain_trust_matches_jax_without_the_yunet_tier(
        monkeypatch, tmp_path, jax_detector):
    """The bundled report's worst recall (0.228) is under the 0.5 floor in
    both. With ``FACE_DETECTOR_ONNX`` naming a model that cannot be opened,
    the JAX chain fails its YuNet tier at the first detection, detects as
    the port does and then no longer trusts the variable: the port, which
    has no such tier, never does."""
    assert faces.face_chain_trusted() is jfaces.face_chain_trusted() is False
    assert faces.face_chain_trusted(0.2) is jfaces.face_chain_trusted(0.2)
    monkeypatch.setenv("FACE_DETECTOR_ONNX", str(tmp_path / "yunet.onnx"))
    monkeypatch.setattr(jfaces, "_yn_failed", False)
    monkeypatch.setattr(jfaces, "_yn", None)
    f = FRAMES[0]
    assert faces.detect_faces(f, CPU) == jfaces.detect_faces(f)
    assert jfaces._yn_failed
    assert faces.face_chain_trusted() is jfaces.face_chain_trusted() is False


def test_missing_detector_weights_fall_through_to_skin_blobs(monkeypatch,
                                                             tmp_path):
    """Without the bundled weights the chain is the skin-blob tier alone,
    in the port as in JAX."""
    monkeypatch.setattr(faces, "DETECTOR_WEIGHTS", tmp_path / "none.npz")
    faces.nn_detector.cache_clear()
    monkeypatch.setattr(jfaces, "_nn", None)
    monkeypatch.setattr(jfaces, "_nn_failed", True)
    try:
        for f in FRAMES[:6] + face_clip(1, 48, 64):
            assert faces.detect_faces(f, CPU) == jfaces.detect_faces(f)
    finally:
        faces.nn_detector.cache_clear()
