"""The port's face, detector and LPIPS trainers (video_enhancer_tpu_torch/
train/{faces,face_detector,lpips}.py) against the JAX package's.

Tolerances: the face crops, the scenes' boxes and the CenterNet targets
are equal; the degraded crops and the training scenes within 5e-7 (the
9- and 5-tap blurs and the area resize are within three float32 ulps of
cv2's, ops/cvhost.py); the held-out (alt) scenes within 1e-6 on at least
97% of their values and within 0.1 elsewhere (their cubic upscale and the
motion kernel's warp are a few ulps from cv2's, which a JPEG round trip
can turn into a level). Two Adam steps from JAX's initial parameters (a
batch of 2): the losses within 1e-5 relative, the parameters within
1e-6 + 0.02 * lr of JAX's on all but 5% of each leaf's elements, and
those within 2 * lr * steps: Adam's first steps move each element by
about lr times the sign of its gradient (g / (|g| + 1e-8)), so an element
whose gradient is a near-cancelling sum can step the other way or by a
different fraction of lr. The restorer's output conv starts at zero, so
its first step is all sign: after one step its other layers are equal
and 1.4% of its output conv's weights step the other way (held to 5%);
after two, the layers behind it have seen those, and the restorer is
held to the 2 * lr * steps bound alone, its second loss to 1e-3
relative (1.4e-4 here). The
bundled detector's held-out recall and precision are equal. The
trainers' own loops (``train``, ``main``) run in
tests/test_torch_isolation.py, which also checks that their exports land
in the working directory and never in ``video_enhancer_tpu/weights/``.
"""

import jax
import numpy as np
import pytest
import torch

from video_enhancer_tpu.runtime.weights import save_params as jax_save
from video_enhancer_tpu.train import face_detector as jfd
from video_enhancer_tpu.train import faces as jf
from video_enhancer_tpu.train import lpips as jl
from video_enhancer_tpu_torch.analysis import face_net as tnet
from video_enhancer_tpu_torch.runtime.face_handler import _face_net_init
from video_enhancer_tpu_torch.runtime.weights import (read_npz, save_params,
                                                      try_load_params)
from video_enhancer_tpu_torch.train import face_detector as tfd
from video_enhancer_tpu_torch.train import faces as tf
from video_enhancer_tpu_torch.train import lpips as tl
from video_enhancer_tpu_torch.train.step import AdamW, make_adam_step


def test_face_data_matches_jax():
    crops = jf.make_face_crops(6, seed=3)
    np.testing.assert_array_equal(tf.make_face_crops(6, seed=3), crops)
    got = tf.degrade_faces(crops, np.random.default_rng(5))
    ref = jf.degrade_faces(crops, np.random.default_rng(5))
    assert np.abs(got - ref).max() <= 5e-7
    for seed in (0, 1):
        kw = {"occlude_prob": 0.5}
        ia, ba = jfd.make_face_scenes(6, seed=seed, **kw)
        ib, bb = tfd.make_face_scenes(6, seed=seed, **kw)
        assert ba == bb and np.abs(ia - ib).max() <= 5e-7
        for x, y in zip(jfd.encode_targets(ba, 6), tfd.encode_targets(bb, 6)):
            np.testing.assert_array_equal(x, y)
        ia, ba = jfd.make_alt_face_scenes(6, seed=seed, **kw)
        ib, bb = tfd.make_alt_face_scenes(6, seed=seed, **kw)
        diff = np.abs(ia - ib)
        assert ba == bb
        assert (diff > 1e-6).mean() <= 0.03 and diff.max() <= 0.1, seed


def test_adam_without_clip_or_decay_is_optax_adam():
    import optax

    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    opt, ref = AdamW(lr=1e-3, weight_decay=0.0, max_norm=None), optax.adam(
        1e-3)
    params = [torch.from_numpy(x) for x in leaves]
    state, rstate = opt.init(params), ref.init(leaves)
    rparams = leaves
    for _ in range(4):
        grads = [rng.standard_normal(x.shape).astype(np.float32) * 30
                 for x in leaves]
        params, state = opt.update([torch.from_numpy(g) for g in grads],
                                   state, params)
        upd, rstate = ref.update(grads, rstate)
        rparams = optax.apply_updates(rparams, upd)
        for p, r in zip(params, rparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-7)


@pytest.fixture
def jit_steps(monkeypatch):
    """Each jitted step of the JAX package's trainers: (params, loss)."""
    seen, jit = [], jax.jit

    def recording(fn):
        step = jit(fn)

        def run(*a):
            out = step(*a)
            seen.append((out[0], float(out[-1])))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording)
    return seen


def _to_port(tmp_path, jax_params, template):
    jax_save(tmp_path / "init.npz", jax_params)
    return try_load_params(tmp_path / "init.npz", template)


def _assert_params_close(tmp_path, jax_params, params, lr, steps,
                         share=0.05):
    jax_save(tmp_path / "j.npz", jax_params)
    save_params(tmp_path / "t.npz", params)
    ref, got = read_npz(tmp_path / "j.npz"), read_npz(tmp_path / "t.npz")
    assert ref.keys() == got.keys()
    for k in ref:
        diff = np.abs(ref[k] - got[k])
        assert (diff > 1e-6 + 0.02 * lr).mean() <= share, k
        assert diff.max() <= 2 * lr * steps + 1e-6, k


def _port_steps(loss_fn, lr, params, batches):
    """(params, loss) after each step of the port's Adam step."""
    init, step = make_adam_step(loss_fn, lr)
    state, out = init(params), []
    for batch in batches:
        params, state, loss = step(params, state,
                                   *(torch.from_numpy(b) for b in batch))
        out.append((params, float(loss)))
    return out


def _check_steps(tmp_path, ref, got, lr, share=0.05, rtol=(1e-5, 1e-5)):
    np.testing.assert_allclose(got[0][1], ref[0][1], rtol=rtol[0])
    np.testing.assert_allclose(got[1][1], ref[1][1], rtol=rtol[1])
    _assert_params_close(tmp_path, ref[1][0], got[1][0], lr, 2, share)


def test_restorer_steps_match_jax(tmp_path, jit_steps):
    from video_enhancer_tpu.runtime.face_handler import \
        _face_net_init as jax_init

    p0 = _to_port(tmp_path, jax_init(jax.random.PRNGKey(0)),
                  _face_net_init(torch.Generator()))
    jf.train(steps=2, batch=2)
    rng = np.random.default_rng(0)
    batches = []
    for i in range(2):
        clean = tf.make_face_crops(2, seed=1000 + i)
        batches.append((tf.degrade_faces(clean, rng), clean))
    got = _port_steps(tf.restorer_loss, 2e-4, p0, batches)
    _check_steps(tmp_path, jit_steps, got, 2e-4, share=1.0,
                 rtol=(1e-5, 1e-3))
    # one step: only the zero-initialised output conv has a gradient
    jax_save(tmp_path / "j1.npz", jit_steps[0][0])
    save_params(tmp_path / "t1.npz", got[0][0])
    ref, mine = read_npz(tmp_path / "j1.npz"), read_npz(tmp_path / "t1.npz")
    for k in ref:
        if not k.startswith("out."):
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    diff = np.abs(ref["out.w"] - mine["out.w"])
    assert (diff > 1e-6).mean() <= 0.05 and diff.max() <= 2 * 2e-4 + 1e-6


def test_detector_steps_match_jax(tmp_path, jit_steps):
    from video_enhancer_tpu.analysis.face_net import init as jax_init

    p0 = _to_port(tmp_path, jax_init(jax.random.PRNGKey(0)),
                  tnet.init(torch.Generator()))
    jfd.train(steps=2, batch=2)
    batches = []
    for i in range(2):
        imgs, boxes = tfd.make_face_scenes(2, seed=10_000 + i)
        batches.append((imgs, *tfd.encode_targets(boxes, 2)))
    got = _port_steps(tfd.detector_loss, 3e-4, p0, batches)
    _check_steps(tmp_path, jit_steps, got, 3e-4)


def test_lpips_steps_match_jax(tmp_path, jit_steps):
    p0 = _to_port(tmp_path, {"layers": jl.feat_init(jax.random.PRNGKey(0))},
                  {"layers": tl.feat_init(torch.Generator())})["layers"]
    _, frames = jl.train(steps=2, batch=2)
    batches = [tl.make_rank_batch(frames, 2, 96, seed=i) for i in range(2)]
    got = _port_steps(tl.rank_loss, 1e-3, p0, batches)
    ref = [({"layers": p}, loss) for p, loss in jit_steps]
    got = [({"layers": p}, loss) for p, loss in got]
    _check_steps(tmp_path, ref, got, 1e-3)


def test_evaluate_bundled_detector_matches_jax():
    from video_enhancer_tpu.analysis import face_net as jnet
    from video_enhancer_tpu.runtime.weights import \
        try_load_params as jax_load
    from video_enhancer_tpu_torch.analysis.faces import DETECTOR_WEIGHTS

    jax_params = jax_load(DETECTOR_WEIGHTS, jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0)))
    params = try_load_params(DETECTOR_WEIGHTS, tnet.init(torch.Generator()))
    for gen in ("train", "alt"):
        ref = jfd.evaluate(jax_params, n=6, generator=gen)
        got = tfd.evaluate(params, n=6, generator=gen)
        assert got == ref, gen
