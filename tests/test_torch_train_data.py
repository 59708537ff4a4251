"""The port's eval data (video_enhancer_tpu_torch/train/{data,evalgen}.py)
against the JAX package's on the same seeds.

Tolerances: the HR crops and triplets are equal; the ``alt`` LR clips are
equal (the motion blur, the bilinear downsample, the quantization and the
JPEG round trip are all bit-exact, ops/cvhost.py and io/jpeg.py) given the
same source frames; ``make_alt_frames`` within 1 LSB on at most 1e-5 of
its values (the value noise's cubic upscale is within three float32 ulps
of cv2's, which flips a rare uint8 truncation); the ``ind`` LR clips within
2e-7 of JAX's on at least 99% of the values of a batch, and within 0.05
elsewhere (a blur or resize one ulp apart can flip a quantization level,
which the JPEG or the smear then spreads over a block: 0.6% of one batch
of the 18 drawn here); the pinned seed-999
means of tests/test_train_data.py to 1e-6.

The training side: ``make_train_frames`` (modes 0-4, 48x48 and 64x80, 6
frames) equals JAX's uint8 for uint8. ``pair_iterator``'s batches (the
default mixture, the chain family included) hold ``make_pairs``'s
tolerance above with the WebP round trip replaced on the port's side by
OpenCV's through ``monkeypatch`` (this holds the data path apart from the
codec, tests/test_torch_webp.py holds the codec); without that, the HR
clips and every clip not drawn from the chain family still do, which
shows the RNG stream stays aligned.
"""

import numpy as np
import pytest

from video_enhancer_tpu.io.demo import make_demo_frames as j_demo
from video_enhancer_tpu.train import data as jdata
from video_enhancer_tpu.train import evalgen as jgen
from video_enhancer_tpu_torch.io.demo import make_demo_frames
from video_enhancer_tpu_torch.train import data as tdata
from video_enhancer_tpu_torch.train import evalgen as tgen

import cv2


@pytest.fixture(scope="module")
def demo_frames():
    fr = make_demo_frames(24, (256, 256))
    np.testing.assert_array_equal(fr, j_demo(24, (256, 256)))
    return fr


@pytest.fixture(scope="module")
def alt_frames():
    return jgen.make_alt_frames(24, (256, 256), seed=0)


def test_make_alt_frames_matches_jax(alt_frames):
    got = tgen.make_alt_frames(24, (256, 256), seed=0)
    diff = np.abs(got.astype(np.int64) - alt_frames)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-5
    small = tgen.make_alt_frames(6, (64, 96), seed=3)
    ref = jgen.make_alt_frames(6, (64, 96), seed=3)
    assert np.abs(small.astype(np.int64) - ref).max() <= 1


@pytest.mark.parametrize("scale,crop", [(4, 128), (2, 128), (1, 64)])
def test_make_alt_pairs_and_triplets_equal_jax(alt_frames, scale, crop):
    for seed in (999, 1000, 1003):
        got = tgen.make_alt_pairs(alt_frames, 2, 4, crop, scale, seed=seed)
        ref = jgen.make_alt_pairs(alt_frames, 2, 4, crop, scale, seed=seed)
        np.testing.assert_array_equal(got["hr"], ref["hr"])
        np.testing.assert_array_equal(got["lr"], ref["lr"])
    got = tgen.make_alt_triplets(alt_frames, 4, 128, seed=999)
    ref = jgen.make_alt_triplets(alt_frames, 4, 128, seed=999)
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("scale,crop", [(4, 128), (2, 128), (1, 64)])
def test_make_pairs_matches_jax(demo_frames, scale, crop):
    for seed in range(999, 1005):
        got = tdata.make_pairs(demo_frames, 2, 4, crop, scale, seed=seed)
        ref = jdata.make_pairs(demo_frames, 2, 4, crop, scale, seed=seed)
        np.testing.assert_array_equal(got["hr"], ref["hr"])
        diff = np.abs(got["lr"] - ref["lr"])
        assert (diff > 2e-7).mean() <= 0.01, seed
        assert diff.max() <= 0.05, seed


def test_make_pairs_wide_and_compound_match_jax(demo_frames):
    for kw in ({"wide": True}, {"compound_p": 1.0}, {"wide_p": 0.5}):
        for seed in (5, 6):
            got = tdata.make_pairs(demo_frames, 3, 3, 48, 4, seed=seed, **kw)
            ref = jdata.make_pairs(demo_frames, 3, 3, 48, 4, seed=seed, **kw)
            np.testing.assert_array_equal(got["hr"], ref["hr"])
            diff = np.abs(got["lr"] - ref["lr"])
            assert (diff > 2e-7).mean() <= 0.01 and diff.max() <= 0.05, kw
    # the chain family (a WebP round trip) is ported: it draws, with the
    # HR clips equal (its codec's distance: tests/test_torch_webp.py)
    got = tdata.make_pairs(demo_frames, 3, 3, 48, 4, seed=5, chain_p=1.0)
    ref = jdata.make_pairs(demo_frames, 3, 3, 48, 4, seed=5, chain_p=1.0)
    np.testing.assert_array_equal(got["hr"], ref["hr"])
    assert got["lr"].shape == ref["lr"].shape == (3, 3, 12, 12, 3)


def test_eval_realizations_pinned_and_triplets_equal(demo_frames):
    pr = tdata.make_pairs(demo_frames, 2, 4, 128, 4, seed=999)
    assert abs(float(pr["lr"].mean()) - 0.4943028390407562) < 1e-6
    assert abs(float(pr["hr"].mean()) - 0.49455785751342773) < 1e-6
    it_t = tdata.triplet_iterator(demo_frames, 4, 64, seed=7)
    for step in range(2):
        got = next(it_t)
        ref = jdata.make_triplets(demo_frames, 4, 64, seed=7 + step)
        for k in ("lr", "hr"):
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("mode", range(5))
def test_make_train_frames_equals_jax(mode):
    for size in ((48, 48), (64, 80)):
        for seed in (1, 2):
            np.testing.assert_array_equal(
                tdata.make_train_frames(6, size, seed=seed, mode=mode),
                jdata.make_train_frames(6, size, seed=seed, mode=mode))


def _cv2_webp(img, q):
    ok, enc = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


@pytest.fixture(scope="module")
def bank(demo_frames):
    return np.concatenate(
        [demo_frames[:8, :96, :96]]
        + [tdata.make_train_frames(8, (96, 96), seed=s, mode=s % 5)
           for s in (1, 2, 3, 4)])


@pytest.mark.parametrize("codec", ["cv2", "port"])
def test_pair_iterator_chain_family_matches_jax(bank, monkeypatch, codec):
    if codec == "cv2":
        monkeypatch.setattr(tdata, "webp_roundtrip", _cv2_webp)
    chained, chain = [], tdata._degrade_chain

    def recording(hr, scale, rng):
        chained.append(hr.copy())
        return chain(hr, scale, rng)

    monkeypatch.setattr(tdata, "_degrade_chain", recording)
    got_it = tdata.pair_iterator(bank, 4, 3, 48, 2, seed=11)
    ref_it = jdata.pair_iterator(bank, 4, 3, 48, 2, seed=11)
    chains = 0
    for _ in range(4):
        chained.clear()
        got, ref = next(got_it), next(ref_it)
        np.testing.assert_array_equal(got["hr"], ref["hr"])
        diff = np.abs(got["lr"] - ref["lr"]).reshape(4, -1)
        is_chain = np.array([any(np.array_equal(got["hr"][b], c)
                                 for c in chained) for b in range(4)])
        chains += int(is_chain.sum())
        keep = diff if codec == "cv2" else diff[~is_chain]
        assert (keep > 2e-7).mean() <= 0.01 and keep.max() <= 0.05
        if codec == "port" and is_chain.any():
            assert diff[is_chain].max() > 0   # the codec is not libwebp's
    assert chains > 0
