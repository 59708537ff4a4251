"""The input generator: the same seed gives the same frames, another seed
other content at the same sizes."""

from __future__ import annotations

import numpy as np

from vebench import frames

MIX = {"height": 40, "width": 72, "clip_frames": 9, "pool_clips": 2,
       "degrade": {"noise": [0.2, 1.0], "blur": [0.0, 1.0],
                   "compression": [0.0, 1.0]}}
SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are


def test_same_seed_same_frames():
    a, b = frames.make_pool(MIX, SEED), frames.make_pool(MIX, SEED)
    for x, y in zip(a, b):
        assert x.frames.dtype == np.uint8
        assert x.frames.shape == (9, 40, 72, 3)
        assert np.array_equal(x.frames, y.frames)
        assert x.context() == y.context()


def test_other_seed_other_content_same_work():
    a, b = frames.make_pool(MIX, SEED), frames.make_pool(MIX, SEED + 1)
    assert [c.frames.shape for c in a] == [c.frames.shape for c in b]
    assert not np.array_equal(a[0].frames, b[0].frames)
    assert not np.array_equal(a[0].frames, a[1].frames)


def test_frames_move_and_context_follows_the_rule():
    clip = frames.make_pool(MIX, SEED)[0]
    assert np.abs(np.diff(clip.frames.astype(int), axis=0)).mean() > 1
    ctx = clip.context()
    scores = ctx["degradation_scores"]
    assert len(scores) == 3 and all(0 <= s <= 1 for s in scores)
    want = 1 + int(np.argmax(scores)) if max(scores) > 0.3 else 0
    assert ctx["degradation_type"] == want
    plain = frames.make_pool({k: v for k, v in MIX.items()
                              if k != "degrade"}, SEED)[0]
    assert plain.context() == {"degradation_scores": [0.0, 0.0, 0.0],
                               "degradation_type": 0}
