"""The port's raw AVI (video_enhancer_tpu_torch/io/avi.py) against OpenCV and
the JAX package's io/video.py: frames bit for bit (0 LSB), metadata dicts
equal, sampling and seeking equal; a bottom-up file with no index read by
the port alone (OpenCV cannot read bottom-up rows); a file past a lowered
OpenDML limit read back whole by OpenCV; and the error a non-AVI file
raises where OpenCV is missing."""

from __future__ import annotations

import struct
import sys

import cv2
import numpy as np
import pytest

from video_enhancer_tpu.io import video as jvideo
from video_enhancer_tpu_torch.io import avi
from video_enhancer_tpu_torch.io import video as tvideo


def _clip(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _cv2_frames(path) -> tuple[np.ndarray, cv2.VideoCapture]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return np.stack(out), cap


@pytest.mark.parametrize("fps", [24.0, 25.0, 30000 / 1001])
def test_port_avi_reads_bit_for_bit_everywhere(tmp_path, fps):
    """An odd width (41: 123 bytes a row, padded to 124)."""
    frames = _clip(7, 13, 41)
    path = tvideo.write_video(tmp_path / "clip.avi", frames, fps=fps)
    by_cv2, cap = _cv2_frames(path)
    assert cap.get(cv2.CAP_PROP_FPS) == fps
    assert int(cap.get(cv2.CAP_PROP_FOURCC)) == 0
    np.testing.assert_array_equal(by_cv2, frames)
    np.testing.assert_array_equal(jvideo.read_video(path), frames)
    np.testing.assert_array_equal(tvideo.read_video(path), frames)
    assert tvideo.get_video_metadata(path).to_dict() == \
        jvideo.get_video_metadata(path).to_dict()


def test_sampling_and_seeking_match_jax(tmp_path):
    frames = _clip(30, 8, 12, seed=1)
    path = tvideo.write_video(tmp_path / "clip.avi", frames, fps=25.0)
    np.testing.assert_array_equal(tvideo.sample_frames(path),
                                  jvideo.sample_frames(path))
    np.testing.assert_array_equal(tvideo.sample_frames(path, 5),
                                  jvideo.sample_frames(path, 5))
    for start, count in ((0, None), (5, 4), (27, 10), (29, 1)):
        np.testing.assert_array_equal(
            tvideo.read_video(path, start, count),
            jvideo.read_video(path, start=start, count=count))
    r = tvideo.VideoReader(path)
    assert r.meta.frame_count == 30 and len(list(r)) == 30


def _bottom_up_avi(frames: np.ndarray, fps: int) -> bytes:
    """A minimal AVI 1.0 file written the other way round: bottom-up rows
    (positive biHeight), '00dc' chunks, no idx1."""
    n, h, w, _ = frames.shape
    row = (w * 3 + 3) & ~3

    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def lst(kind, body):
        return chunk(b"LIST", kind + body)

    strh = b"vids" + b"\0" * 4 + struct.pack(
        "<IHHIIIIIIII4h", 0, 0, 0, 0, 1, fps, 0, n, row * h, 0, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0, n, 0, 1, 0, w, h,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = b""
    for f in frames:
        img = np.zeros((h, row), np.uint8)
        img[:, :w * 3] = f[::-1, :, ::-1].reshape(h, w * 3)
        movi += chunk(b"00dc", img.tobytes())
    return chunk(b"RIFF", b"AVI " + hdrl + lst(b"movi", movi))


def test_bottom_up_avi_without_index_reads_in_the_port(tmp_path):
    frames = _clip(5, 9, 13, seed=2)
    path = tmp_path / "bottom_up.avi"
    path.write_bytes(_bottom_up_avi(frames, 30))
    info = avi.probe(path)
    assert info is not None and not info.top_down
    np.testing.assert_array_equal(tvideo.read_video(path), frames)
    np.testing.assert_array_equal(tvideo.read_video(path, 3, 2), frames[3:])
    meta = tvideo.get_video_metadata(path)
    assert (meta.width, meta.height, meta.fps, meta.frame_count) == \
        (13, 9, 30.0, 5)


def test_opendml_past_a_lowered_limit_reads_back_whole(tmp_path):
    """RIFFs of at most 10 KB: the file goes on in AVIX RIFFs with ix00
    indexes behind the indx super index, as ffmpeg writes past 1 GiB."""
    frames = _clip(20, 24, 41, seed=3)
    path = tmp_path / "odml.avi"
    with avi.AviWriter(path, (24, 41), fps=30000 / 1001,
                       riff_limit=10_000) as w:
        for f in frames:
            w.write(f)
    data = path.read_bytes()
    assert data.count(b"AVIX") >= 3 and b"indx" in data
    by_cv2, cap = _cv2_frames(path)
    np.testing.assert_array_equal(by_cv2, frames)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 20
    np.testing.assert_array_equal(tvideo.read_video(path), frames)
    np.testing.assert_array_equal(tvideo.read_video(path, 13, 4),
                                  frames[13:17])
    assert tvideo.get_video_metadata(path).to_dict() == \
        jvideo.get_video_metadata(path).to_dict()


def test_other_containers_name_the_missing_opencv(tmp_path, monkeypatch):
    """Without cv2 an mp4 raises an IOError naming its container and the
    raw-AVI way round; raw AVI still reads and writes."""
    mp4 = jvideo.write_video(tmp_path / "clip.mp4", _clip(3, 16, 16))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError, match=r"MP4/MOV file needs OpenCV .* "
                                      r"uncompressed 24-bit AVI"):
        tvideo.get_video_metadata(mp4)
    with pytest.raises(IOError, match=r"'\.mp4' output needs OpenCV"):
        tvideo.write_video(tmp_path / "out.mp4", _clip(2, 8, 8))
    frames = _clip(2, 8, 8)
    path = tvideo.write_video(tmp_path / "ok.avi", frames)
    np.testing.assert_array_equal(tvideo.read_video(path), frames)
    assert tvideo.scratch_suffix(path) == ".avi"
    assert tvideo.scratch_suffix(mp4) == ".mp4"
