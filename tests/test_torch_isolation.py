"""The port, chip_smoke.py and scripts/torch_ab_harness.py import nothing of
JAX, OpenCV, PyYAML, psutil or the JAX package: the card's machine has no
JAX, OpenCV or PyYAML, and may lack psutil. OpenCV is imported only where a
file is not raw AVI (io/video.py); nothing on an ``.avi`` needs it.
Checked in fresh interpreters: one imports every module of the port,
chip_smoke.py and the A/B script; one, where those packages cannot be
imported at all, drives the auto route on frames in memory, its temporal
stage included; one, likewise,
drives rvrt (an explicit engine and the fallback manager) and the
strict-latency route to fast_mamba_vsr; one, likewise, drives the route to
seedvr2 with its quality gate; one, likewise, serves realesrgan,
realesrgan_fast and fast_mamba_vsr_ssd and runs the frame-interpolation
stage (RIFE); one, likewise, routes a clip with faces through the detector
chain and runs the face stage, on both entry points; one, likewise, runs
the file paths on ``.avi`` files the port wrote (vsrm's ``enhance_video``,
``run_auto_pipeline`` with its intermediate file and its temporal stage,
RIFE's and the face expert's file entries); one, likewise, runs the CLI
(demo, metadata, enhance, eval) and the REST job server (an ``.avi`` job
to the end, and an ``.mp4`` upload, which ends ``failed`` with an error
naming the missing OpenCV)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BAD = ("jax", "jaxlib", "cv2", "yaml", "psutil", "video_enhancer_tpu")

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import video_enhancer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
spec = importlib.util.spec_from_file_location(
    "torch_ab_harness", sys.argv[1] + "/scripts/torch_ab_harness.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(json.dumps({"modules": names, "bad": bad}))
""" % (BAD,)

# A module set to None in sys.modules cannot be imported.
ROUTE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
from chip_smoke import dim_clip
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
out, stats = run_auto_frames(dim_clip(8, 16, 16), device="cpu")
plan = stats["routing_plan"]
print(json.dumps({"primary": plan["expert_routing"]["primary_model"],
                  "fallback": "fallback" in plan or "fallback_from" in stats,
                  "frames": len(out),
                  "smoothed": stats.get("temporal_smoothing", False)}))
""" % (BAD,)


SLICE3 = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
from chip_smoke import dim_clip
from video_enhancer_tpu_torch.runtime.fallback import ModelFallbackManager
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
res = {}
for key, kw in (("rvrt", {"engine": "rvrt"}),
                ("strict", {"latency_class": "strict"})):
    out, stats = run_auto_frames(dim_clip(6, 16, 16), device="cpu", **kw)
    res[key] = [stats["model"], "fallback_from" in stats, len(out)]
_, res["manager"] = ModelFallbackManager(
    device="cpu").load_model_with_fallbacks("rvrt")
print(json.dumps(res))
""" % (BAD,)


SEEDVR2 = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
from chip_smoke import blocky_clip, sharp_clip
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
res = {}
for key, frames in (("soft", blocky_clip(8, 16, 24)),
                    ("sharp", sharp_clip(8, 16, 24))):
    out, stats = run_auto_frames(frames, engine="auto" if key == "soft"
                                 else "seedvr2", device="cpu")
    res[key] = [stats["model"], "fallback_from" in stats, len(out),
                stats["windows_skipped"]]
print(json.dumps(res))
""" % (BAD,)


SLICE13 = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
from chip_smoke import dim_clip
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
res = {}
for engine in ("realesrgan", "realesrgan_fast", "fast_mamba_vsr_ssd"):
    out, stats = run_auto_frames(dim_clip(5, 8, 12), engine=engine,
                                 device="cpu")
    res[engine] = [stats["model"], "fallback_from" in stats, len(out)]
out, stats = run_auto_frames(dim_clip(5, 8, 12), enable_hfr=True,
                             device="cpu")
res["hfr"] = [stats.get("hfr", False), len(out),
              stats.get("hfr_interpolation_error")]
print(json.dumps(res))
""" % (BAD,)


FACES = r"""
import json, sys, tempfile
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
from chip_smoke import face_clip
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_frames
res = {}
out, stats = run_auto_frames(face_clip(8, 48, 64), engine="bicubic",
                             enable_face_expert=True, device="cpu")
plan = stats["routing_plan"]
res["frames"] = [plan["content_analysis"]["face_prominence"] > 0.03,
                 "face_restoration" in plan["processing_order"],
                 stats.get("face_restoration", False),
                 stats.get("faces_restored", 0) > 0, len(out),
                 sorted(k for k in stats if k.endswith("_error"))]
print(json.dumps(res))
""" % (BAD,)


FILES = r"""
import json, sys, tempfile
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)       # beside the other test workers
import numpy as np
from chip_smoke import dim_clip
from video_enhancer_tpu_torch.io.video import read_frames, write_frames
from video_enhancer_tpu_torch.runtime.pipeline import run_auto_pipeline
from video_enhancer_tpu_torch.runtime.registry import build_handler
d = tempfile.mkdtemp(dir=sys.argv[2])
src = d + "/in.avi"
write_frames(src, dim_clip(8, 16, 16), (16, 16), fps=24.0)
res = {}
for key, run in (
        ("vsrm", lambda out: build_handler("vsrm", device="cpu")
         .enhance_video(src, out)),
        ("auto", lambda out: run_auto_pipeline(src, out, device="cpu"))):
    stats = run(d + "/" + key + ".avi")
    res[key] = [stats["model"], "fallback_from" in stats,
                list(np.stack(list(read_frames(d + "/" + key + ".avi")))
                     .shape),
                sorted(k for k in stats if k.endswith("_error"))]
res["auto"].append(stats.get("temporal_smoothing", False))
from video_enhancer_tpu_torch.runtime.face_handler import FaceRestorationExpert
from video_enhancer_tpu_torch.runtime.rife_handler import RIFEHandler
stats = RIFEHandler(device="cpu").interpolate_video(src, d + "/hfr.avi")
res["rife"] = [stats["frames_processed"], stats["output_fps"]]
stats = FaceRestorationExpert(device="cpu").process_video_selective(
    src, d + "/faces.avi")
res["faces"] = len(list(read_frames(d + "/faces.avi")))
print(json.dumps(res))
""" % (BAD,)


ENTRY = r"""
import contextlib, io, json, sys, tempfile, time, urllib.request, uuid
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)       # beside the other test workers
from video_enhancer_tpu_torch import cli
from video_enhancer_tpu_torch.io.video import read_video
from video_enhancer_tpu_torch.serving.app import ApiServer, create_app
from video_enhancer_tpu_torch.serving.http import serve
d = tempfile.mkdtemp(dir=sys.argv[2])

def run(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return [rc, json.loads(buf.getvalue().strip().splitlines()[-1])]

res = {"demo": run("demo", d + "/demo.avi", "--frames", "6", "--height",
                   "24", "--width", "32")[0]}
res["metadata"] = run("metadata", d + "/demo.avi")
rc, stats = run("enhance", d + "/demo.avi", d + "/up.avi", "--engine",
                "bicubic", "--device", "cpu")
res["enhance"] = [rc, stats["frames_processed"], stats["audio"]]
rc, ev = run("eval", d + "/up.avi", d + "/demo.avi", "--device", "cpu")
res["eval"] = [rc, sorted(ev), ev["psnr"] > 20]

srv = ApiServer(data_dir=d + "/srv", device="cpu", start_scheduler=False)
httpd = serve(create_app(srv), host="127.0.0.1", port=0, background=True)
url = "http://127.0.0.1:%%d" %% httpd.server_address[1]

def call(path, body=None, ctype=None):
    req = urllib.request.Request(url + path, data=body)
    if ctype:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()

def job(path, strategy):
    b = uuid.uuid4().hex
    name = path.rsplit("/", 1)[-1]
    body = ("--%%s\r\nContent-Disposition: form-data; name=\"vsr_strategy\""
            "\r\n\r\n%%s\r\n--%%s\r\nContent-Disposition: form-data; "
            "name=\"file\"; filename=\"%%s\"\r\n\r\n" %% (b, strategy, b, name)
            ).encode() + open(path, "rb").read() + ("\r\n--%%s--\r\n" %% b
                                                    ).encode()
    _, _, raw = call("/api/v1/process/auto", body,
                     "multipart/form-data; boundary=" + b)
    job_id = json.loads(raw)["job_id"]
    for _ in range(400):
        rec = json.loads(call("/api/v1/job/" + job_id)[2])
        if rec["status"] in ("completed", "failed"):
            return job_id, rec
        time.sleep(0.25)
    return job_id, rec

job_id, rec = job(d + "/demo.avi", "bicubic")
status, ctype, raw = call("/api/v1/job/%%s/download" %% job_id)
open(d + "/got.avi", "wb").write(raw)
res["avi_job"] = [rec["status"], ctype, list(read_video(d + "/got.avi").shape)]
_, rec = job(sys.argv[3], "bicubic")
res["mp4_job"] = [rec["status"], "needs OpenCV" in rec.get("error", "")]
res["metrics"] = call("/metrics")[0]
httpd.shutdown()
httpd.server_close()
print(json.dumps(res))
""" % (BAD,)


def _run(code: str, *args) -> dict:
    out = subprocess.run([sys.executable, "-c", code, str(ROOT),
                          *map(str, args)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_cv2_or_jax_package():
    res = _run(PROBE)
    for name in ("runtime.vsr_handler", "io.video", "config",
                 "analysis.router", "ops.degradation", "ops.attention",
                 "models.ditvr", "models.upscaler", "runtime.pipeline",
                 "runtime.experts", "runtime.qualification",
                 "runtime.registry", "runtime.upscaler_handler",
                 "models.rvrt", "models.fast_mamba_vsr", "runtime.fallback",
                 "runtime.weights", "parallel.mesh", "parallel.temporal",
                 "parallel.inference", "parallel.spatial",
                 "models.seedvr2", "models.diffusion", "ops.prng",
                 "ops.warp", "ops.conv", "ops.color", "ops.optflow",
                 "ops.resize", "models.realesrgan", "models.official_arch",
                 "models.rife", "runtime.rife_handler", "analysis.faces",
                 "analysis.face_net", "runtime.face_handler",
                 "models.official_gfpgan", "ops.imgproc", "io.avi",
                 "io.demo", "io.audio", "cli", "utils.metrics",
                 "agents.enhancer", "runtime.jobstore", "runtime.storage",
                 "runtime.scheduler", "utils.memory", "utils.errors",
                 "utils.auth", "utils.security", "utils.perf",
                 "utils.logging_config", "serving.http", "serving.app",
                 "serving.server"):
        assert f"video_enhancer_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == []


def test_auto_route_runs_without_jax_cv2_or_yaml():
    """Routing, preprocessing, ditvr and the temporal stage (its optical
    flow in torch) run with those packages absent, and nothing falls back
    (a failed import would show as a fallback, or as the stage's error)."""
    res = _run(ROUTE)
    assert res == {"primary": "ditvr", "fallback": False, "frames": 8,
                   "smoothed": True}


def test_rvrt_and_strict_routes_run_without_jax_cv2_or_yaml():
    """rvrt (an explicit engine, and the first choice of its hierarchy) and
    the strict route to fast_mamba_vsr run with those packages absent,
    with no fallback."""
    res = _run(SLICE3)
    assert res == {"rvrt": ["rvrt", False, 6],
                   "strict": ["fast_mamba_vsr", False, 6],
                   "manager": "rvrt"}


def test_seedvr2_route_runs_without_jax_cv2_or_yaml():
    """The router's own pick of seedvr2 and its quality gate (the JAX
    handler's takes OpenCV) run with those packages absent, with no
    fallback: the soft clip runs its windows, the sharp one skips both
    (8 frames make windows at 0 and at 6, the tail)."""
    res = _run(SEEDVR2)
    assert res == {"soft": ["seedvr2", False, 8, 0],
                   "sharp": ["seedvr2", False, 8, 2]}


def test_new_models_and_hfr_run_without_jax_cv2_or_yaml():
    """realesrgan, realesrgan_fast and fast_mamba_vsr_ssd as explicit
    engines, and the frame-interpolation stage in memory, run with those
    packages absent, with no fallback and no error (5 frames -> 9)."""
    res = _run(SLICE13)
    assert res == {name: [name, False, 5] for name in (
        "realesrgan", "realesrgan_fast", "fast_mamba_vsr_ssd")} | {
        "hfr": [True, 9, None]}


def test_face_route_runs_without_jax_cv2_or_yaml():
    """The router's detector chain (its face prominence above the policy's
    threshold) and the face stage in memory run with those packages
    absent, with no error."""
    res = _run(FACES)
    assert res == {"frames": [True, True, True, True, 8, []]}


def test_file_paths_run_on_avi_without_jax_cv2_or_yaml(tmp_path):
    """vsrm's ``enhance_video``, ``run_auto_pipeline`` (its preprocessed
    intermediate file and its temporal stage on the written output), RIFE's
    ``interpolate_video`` and the face expert's ``process_video_selective``
    on an ``.avi`` the port wrote, with those packages absent: no
    fallback, no stage error."""
    res = _run(FILES, tmp_path)
    assert res == {"vsrm": ["vsrm", False, [8, 64, 64, 3], []],
                   "auto": ["ditvr", False, [8, 16, 16, 3], [], True],
                   "rife": [15, 48.0], "faces": 8}


def test_cli_and_server_run_on_avi_without_jax_cv2_yaml_or_psutil(tmp_path):
    """The CLI's four commands and a server job on ``.avi`` files; an
    ``.mp4`` upload ends ``failed`` naming OpenCV; /metrics answers without
    psutil."""
    mp4 = tmp_path / "clip.mp4"
    vw = cv2.VideoWriter(str(mp4), cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                         (48, 32))
    for f in np.random.default_rng(0).integers(0, 256, (8, 32, 48, 3),
                                               dtype=np.uint8):
        vw.write(f)
    vw.release()
    res = _run(ENTRY, tmp_path, mp4)
    meta = res.pop("metadata")
    assert meta == [0, {"path": meta[1]["path"], "width": 32, "height": 24,
                        "fps": 24.0, "frame_count": 6, "duration_sec": 0.25,
                        "codec": "\x00" * 4}]
    assert res == {"demo": 0, "enhance": [0, 6, "dropped (no ffmpeg)"],
                   "eval": [0, ["psnr", "ssim", "temporal_consistency"],
                            True],
                   "avi_job": ["completed", "video/x-msvideo",
                               [6, 48, 64, 3]],
                   "mp4_job": ["failed", True], "metrics": 200}
