"""The port's face-restoration expert, its stage in both pipelines and the
official GFPGANv1Clean graph, against the JAX package on the CPU.

Tolerances: ``face_quality`` within 1e-6 of the JAX score (the port sums
in fp64, the JAX package in numpy's fp32; measured ~5e-8), and a box whose
JAX score lies within 1e-6 of the strategy's threshold would be reported
and its decision not compared (none here); restored frames within 1 LSB
(measured 0); GFPGANv1Clean at the JAX package's test size (out_size 32,
nsf 16, two MLP layers, narrow 1/32) within 1e-5 of the JAX graph on
[-1, 1] (both fp32, the JAX side at "highest" matmul precision; measured
~2.4e-7), loaded from the JAX tree saved as a ``.npz`` and from a
``.pth`` of the official torch graph, with the noise strengths, noises and
biases drawn so that every term counts. The JAX side is jitted where the
JAX package jits it.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_enhancer_tpu.models import official_gfpgan as jgfpgan
from video_enhancer_tpu.runtime import face_handler as jfh
from video_enhancer_tpu.runtime import pipeline as jpipeline
from video_enhancer_tpu.runtime.weights import (convert_torch_state_dict,
                                                flatten_params as jflatten,
                                                unflatten_into)
from video_enhancer_tpu.train.face_detector import make_face_scenes
from video_enhancer_tpu_torch.io.video import read_frames, write_frames
from video_enhancer_tpu_torch.models import official_gfpgan as tgfpgan
from video_enhancer_tpu_torch.runtime import face_handler as tfh
from video_enhancer_tpu_torch.runtime import pipeline as tpipeline
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      load_into,
                                                      params_from_jax,
                                                      read_npz,
                                                      try_load_params)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import (_torch_state_dict, face_clip,  # noqa: E402
                        gfpgan_flops)
from test_official_gfpgan import GFPGANv1Clean, _channels  # noqa: E402

CPU = torch.device("cpu")
Q_TOL = 1e-6
TINY = dict(out_size=32, num_style_feat=16, num_mlp=2,
            channel_multiplier=1.0, narrow=1 / 32)


def _traced(init):
    """``init`` with its random draws traced, not run: a template of shapes
    for a checkpoint that fills every leaf (eager random inits of the JAX
    package cost seconds of compiles)."""
    return lambda key, *a, **kw: jax.eval_shape(
        lambda k: init(k, *a, **kw), key)


@pytest.fixture(scope="module", autouse=True)
def traced_jax_inits():
    """The JAX experts' templates traced; the JAX chain's lazily loaded
    neural tier set up once."""
    from video_enhancer_tpu.analysis import face_net as jface_net
    from video_enhancer_tpu.analysis import faces as jfaces
    from video_enhancer_tpu.runtime.weights import try_load_params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfh, "_face_net_init", _traced(jfh._face_net_init))
        mp.setattr(jgfpgan, "gfpgan_official_init",
                   _traced(jgfpgan.gfpgan_official_init))
        if jfaces._nn is None and not jfaces._nn_failed:
            template = jax.eval_shape(jface_net.init, jax.random.PRNGKey(0))
            jfaces._nn = (try_load_params(jfaces_weights(), template),
                          jax.jit(jface_net.apply))
        yield


def jfaces_weights() -> Path:
    from video_enhancer_tpu_torch.analysis.faces import DETECTOR_WEIGHTS

    return DETECTOR_WEIGHTS


@pytest.fixture(scope="module")
def experts(traced_jax_inits):
    return jfh.FaceRestorationExpert(), tfh.FaceRestorationExpert(device=CPU)


def _scenes() -> list[np.ndarray]:
    imgs, _ = make_face_scenes(3, size=160, seed=7)
    return [(img * 255).astype(np.uint8) for img in imgs] + face_clip(
        1, 120, 160)


SCENES = _scenes()


def test_restorer_weights_fill_every_leaf():
    template = tfh._face_net_init(torch.Generator().manual_seed(0))
    _, matched, skipped = load_into(template, params_from_jax(
        read_npz(tfh.BUNDLED)))
    assert not skipped and len(matched) == len(flatten_params(template))


def test_quality_and_restoration_match_jax(experts):
    """Every detected box of the scenes: the same boxes (after the IoU
    dedup), the same quality score, the same restored frame, at the
    expert's three blend strengths; boxes at a frame's border are clamped
    alike."""
    je, te = experts
    n = 0
    for f in SCENES:
        boxes = te.detect_faces(f)
        assert boxes == je.detect_faces(f)
        for box in boxes + [(0, 0, 30, 24), (f.shape[1] - 20,
                                             f.shape[0] - 30, 20, 30)]:
            x, y, w, h = box
            crop = f[y:y + h, x:x + w]
            assert abs(te.face_quality(crop) - je.face_quality(crop)) <= Q_TOL
            blend = (0.4, 0.6, 0.8)[n % 3]
            got, want = te.restore_face(f, box, blend), je.restore_face(
                f, box, blend)
            assert np.abs(got.astype(np.int16) - want).max() <= 1
            n += 1
    assert n >= 10


def test_expert_dedups_at_iou_one_half(monkeypatch, experts):
    boxes = [(10, 10, 40, 40), (12, 12, 40, 40), (60, 10, 20, 20),
             (10, 10, 40, 40)]
    import video_enhancer_tpu.analysis.faces as jfaces
    import video_enhancer_tpu_torch.analysis.faces as tfaces

    monkeypatch.setattr(tfaces, "detect_faces", lambda f, d=None: boxes)
    monkeypatch.setattr(jfaces, "detect_faces", lambda f: boxes)
    je, te = experts
    got = te.detect_faces(None)
    assert got == je.detect_faces(None)
    assert got == [(10, 10, 40, 40), (60, 10, 20, 20)]


def _near_threshold(je, frames, thr) -> list:
    out = []
    for f in frames:
        for x, y, w, h in je.detect_faces(f):
            q = je.face_quality(f[y:y + h, x:x + w])
            if abs(q - thr) <= Q_TOL:
                out.append(q)
    return out


def _jax_selective(monkeypatch, je, frames, **kw) -> tuple[list, dict]:
    """The JAX expert's file entry on frames in memory (its reads and its
    writer replaced)."""
    import types

    written = []

    class Writer:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def write(self, f):
            written.append(f.copy())

    meta = types.SimpleNamespace(fps=24.0)
    monkeypatch.setattr(jfh, "get_video_metadata", lambda p: meta)
    monkeypatch.setattr(jfh, "read_video", lambda p: np.stack(frames))
    monkeypatch.setattr(jfh, "VideoWriter", Writer)
    stats = je.process_video_selective("in", "out", **kw)
    return written, stats


@pytest.mark.parametrize("kw", [{}, {"max_analysis_frames": 3},
                                {"face_threshold": 0.36}])
def test_process_frames_selective_matches_jax(monkeypatch, experts, kw):
    """The in-memory entry against the JAX file entry on the same frames:
    the same faces restored on the same frames (every sample, or 3 samples
    shared by their nearest frames, ties to the lower index), frames within
    1 LSB, the same stats."""
    je, te = experts
    frames = face_clip(7, 72, 96) + SCENES[:2]
    frames = [np.ascontiguousarray(f[:72, :96]) for f in frames]
    thr = kw.get("face_threshold", 0.5)
    assert _near_threshold(je, frames, thr) == []
    want, jstats = _jax_selective(monkeypatch, je, frames, **kw)
    got, stats = te.process_frames_selective(frames, **kw)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert np.abs(a.astype(np.int16) - b).max() <= 1
    for k in ("status", "model", "frames_processed", "frames_analyzed",
              "faces_restored", "intensity"):
        assert stats[k] == jstats[k], k
    assert stats["faces_restored"] > 0


def test_process_video_selective_in_place(tmp_path, experts):
    """The file entry rewrites a file in place (as the pipeline calls it)
    with what the in-memory entry gives on its decoded frames, and with
    the JAX file entry's stats."""
    je, te = experts
    src = tmp_path / "faces.mp4"
    write_frames(src, face_clip(6, 64, 96), (64, 96), fps=24.0)
    decoded = list(read_frames(src))
    ref, _ = te.process_frames_selective(decoded)
    port, jax_path = tmp_path / "port.mp4", tmp_path / "jax.mp4"
    shutil.copy(src, port)
    shutil.copy(src, jax_path)
    stats = te.process_video_selective(port, port)
    jstats = je.process_video_selective(str(jax_path), str(jax_path))
    assert stats["output_path"] == str(port)
    for k in ("frames_processed", "frames_analyzed", "faces_restored"):
        assert stats[k] == jstats[k], k
    again = tmp_path / "ref.mp4"
    write_frames(again, ref, (64, 96), fps=24.0)
    got = np.stack(list(read_frames(port))).astype(np.int16)
    np.testing.assert_array_equal(got, np.stack(list(read_frames(again))))
    jgot = np.stack(list(read_frames(jax_path))).astype(np.int16)
    assert np.abs(got - jgot).mean() <= 0.05 and np.abs(got - jgot).max() \
        <= 2


def test_run_auto_frames_runs_the_face_stage(monkeypatch):
    """With ``enable_face_expert=True`` the router sees the faces, the plan
    runs face restoration right after the primary, and the frames are the
    face stage's output on the primary's stream (then the later stages);
    nothing records "not ported". (Left to the policy the stage stays off:
    tests/test_torch_router.py.)"""
    seen = []
    real = tpipeline.face_frames

    def spy(frames, device):
        seen.append([f.copy() for f in frames])
        return real(frames, device)

    monkeypatch.setattr(tpipeline, "face_frames", spy)
    frames = face_clip(8, 48, 64)
    out, stats = tpipeline.run_auto_frames(frames, engine="bicubic",
                                           enable_face_expert=True,
                                           device="cpu")
    plan = stats["routing_plan"]
    order = plan["processing_order"]
    assert plan["content_analysis"]["face_prominence"] > 0.03
    assert plan["expert_routing"]["experts"]["face_restoration"]
    assert order[order.index("sota_bicubic") + 1] == "face_restoration"
    assert stats["face_restoration"] is True and stats["faces_restored"] > 0
    assert stats["face_restoration_sec"] > 0
    assert not [k for k in stats if k.endswith("_error")]
    want, _ = real(seen[0], CPU)
    if "temporal_consistency" in order:
        want = tpipeline.smooth_frames(want, CPU)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)


def test_run_auto_pipeline_runs_the_face_stage_as_jax(tmp_path):
    """File to file with ``enable_face_expert=True`` and bicubic as the
    primary: the same plan as the JAX pipeline (face, then the temporal
    stage where it is asked for), both stages run with no error, and the
    files within the codec's noise."""
    src = tmp_path / "in.mp4"
    write_frames(src, face_clip(8, 48, 64), (48, 64), fps=24.0)
    got = tpipeline.run_auto_pipeline(src, tmp_path / "port.mp4",
                                      engine="bicubic",
                                      enable_face_expert=True, device="cpu")
    want = jpipeline.run_auto_pipeline(str(src), str(tmp_path / "jax.mp4"),
                                       engine="bicubic",
                                       enable_face_expert=True)
    order = got["routing_plan"]["processing_order"]
    assert order == want["routing_plan"]["processing_order"]
    assert "face_restoration" in order
    assert got["face_restoration"] is want["face_restoration"] is True
    assert got["faces_restored"] > 0
    assert not [k for k in got if k.endswith("_error")]
    assert not [k for k in want if k.endswith("_error")]
    frames = lambda p: np.stack(list(read_frames(p))).astype(np.int16)
    d = np.abs(frames(tmp_path / "port.mp4") - frames(tmp_path / "jax.mp4"))
    assert d.mean() <= 0.5 and d.max() <= 16, (d.mean(), d.max())


def _draw_leaves(flat: dict, seed: int) -> dict:
    """Noise strengths, noises and 4-D biases drawn (zeros at init)."""
    g = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if ("noises" in k or (k.endswith((".b", ".bias")) and v.ndim == 4)
                or (k.endswith((".w", ".weight")) and v.shape == (1,))):
            v = g.standard_normal(v.shape).astype(np.float32) * 0.3
        out[k] = v
    return out


def _jax_apply(params, x, **kw):
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        return np.asarray(jax.jit(lambda p, x: jgfpgan.gfpgan_official_apply(
            p, x, num_style_feat=TINY["num_style_feat"], sft_half=True,
            **kw))(params, x))
    finally:
        jax.config.update("jax_default_matmul_precision", prev)


@pytest.mark.parametrize("input_is_latent,different_w",
                         [(True, True), (False, False)])
def test_gfpgan_from_the_jax_tree_matches_jax(tmp_path, input_is_latent,
                                              different_w):
    """The JAX package's flat tree (its layouts, as ``save_params`` writes
    it; seeded values from the official key names) as a ``.npz``."""
    seeded = tgfpgan.gfpgan_official_init(
        torch.Generator().manual_seed(1), different_w=different_w,
        sft_half=True, **TINY)
    flat = _draw_leaves(convert_torch_state_dict(_torch_state_dict(seeded)),
                        0)
    jparams, _, jskipped = unflatten_into(jgfpgan.gfpgan_official_init(
        jax.random.PRNGKey(0), different_w=different_w, sft_half=True,
        **TINY), flat)
    assert not jskipped
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    np.savez(tmp_path / "gfpgan.npz", **flat)
    template = tgfpgan.gfpgan_official_init(
        torch.Generator().manual_seed(0), different_w=different_w,
        sft_half=True, **TINY)
    _, matched, skipped = load_into(template, params_from_jax(
        read_npz(tmp_path / "gfpgan.npz")))
    assert not skipped and len(matched) == len(flat)
    params = try_load_params(tmp_path / "gfpgan.npz", template)
    x = np.random.default_rng(3).random((2, 32, 32, 3), np.float32) * 2 - 1
    kw = dict(different_w=different_w, input_is_latent=input_is_latent)
    want = _jax_apply(jparams, x, **kw)
    got = tgfpgan.gfpgan_official_apply(
        params, torch.from_numpy(x), num_style_feat=TINY["num_style_feat"],
        **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _official_pth(tmp_path, different_w=True) -> tuple[Path, object]:
    torch.manual_seed(0)
    model = GFPGANv1Clean(32, 16, 2, dec_channels=_channels(1 / 32),
                          unet_channels=_channels(1 / 64),
                          different_w=different_w, sft_half=True,
                          input_is_latent=True).eval()
    sd = {k: torch.from_numpy(v.copy()) for k, v in _draw_leaves(
        {k: v.numpy() for k, v in model.state_dict().items()}, 1).items()}
    path = tmp_path / "GFPGANv1.4.pth"
    torch.save(sd, path)
    model.load_state_dict(sd)
    return path, model


def test_gfpgan_from_a_pth_matches_jax_and_the_official_graph(tmp_path):
    path, model = _official_pth(tmp_path)
    template = tgfpgan.gfpgan_official_init(torch.Generator().manual_seed(0),
                                            **TINY)
    params = try_load_params(path, template)
    jtemplate = jgfpgan.gfpgan_official_init(jax.random.PRNGKey(0), **TINY)
    sd = torch.load(path, weights_only=True)
    jparams, _, skipped = unflatten_into(jtemplate,
                                         convert_torch_state_dict(sd))
    assert not skipped
    x = np.random.default_rng(4).random((2, 32, 32, 3), np.float32) * 2 - 1
    got = tgfpgan.gfpgan_official_apply(params, torch.from_numpy(x),
                                        num_style_feat=16).numpy()
    np.testing.assert_allclose(got, _jax_apply(jparams, x), atol=1e-5,
                               rtol=0)
    with torch.no_grad():
        ref = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 2, 3, 1), atol=1e-4,
                               rtol=0)


def test_expert_serves_gfpgan_through_the_env(monkeypatch, tmp_path):
    """``$VETPU_GFPGAN_CKPT`` replaces the bundled restorer with the
    checkpoint's GFPGAN in both experts; the restored frames agree within
    1 LSB. Without it the GFPGAN path stays off."""
    path, _ = _official_pth(tmp_path)
    cfg = dict(TINY, different_w=True, sft_half=True, input_is_latent=True)
    monkeypatch.setenv("VETPU_GFPGAN_CKPT", str(path))
    te = tfh.FaceRestorationExpert(gfpgan_config=dict(cfg), device=CPU)
    je = jfh.FaceRestorationExpert(gfpgan_config=dict(cfg))
    assert te.gfpgan_params is not None and je.gfpgan_params is not None
    frame = SCENES[0]
    for box, blend in (((20, 30, 60, 70), 0.6), ((100, 90, 60, 70), 0.8)):
        got, want = te.restore_face(frame, box, blend), je.restore_face(
            frame, box, blend)
        assert np.abs(got.astype(np.int16) - want).max() <= 1
        assert np.abs(got.astype(np.int16) - frame).max() > 1
    monkeypatch.delenv("VETPU_GFPGAN_CKPT")
    assert tfh.FaceRestorationExpert(device=CPU).gfpgan_params is None


def test_gfpgan_flops_count_every_conv():
    """chip_smoke.py's FLOP count of GFPGAN's convs equals what torch's
    FLOP counter sees in the port's forward at the test size, and at the
    release size it is the v1.4 generator's."""
    from torch.utils.flop_counter import FlopCounterMode

    for different_w, latent in ((True, True), (False, False)):
        params = tgfpgan.gfpgan_official_init(
            torch.Generator().manual_seed(0), different_w=different_w,
            **TINY)
        x = torch.zeros((1, 32, 32, 3))
        with FlopCounterMode(display=False) as fc:
            tgfpgan.gfpgan_official_apply(params, x, num_style_feat=16,
                                          different_w=different_w,
                                          input_is_latent=latent)
        counted = fc.get_flop_counts()["Global"][
            torch.ops.aten.convolution]
        convs, linear = gfpgan_flops(32, 16, 1.0, 1 / 32, different_w,
                                     True, 2, latent)
        assert convs == counted and linear > 0
    convs, _ = gfpgan_flops()
    assert 3.9e11 < convs < 4.0e11
