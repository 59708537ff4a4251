"""The port, chip_smoke.py and scripts/torch_ab_harness.py import nothing of
JAX, OpenCV, PyYAML, psutil, optax, orbax or the JAX package: the card's
machine has no JAX, OpenCV, PyYAML, optax or orbax, and may lack psutil.
OpenCV is imported only where a file is not raw AVI (io/video.py); nothing
on an ``.avi`` needs it.
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
naming the missing OpenCV); one, likewise, runs the eval CLI (``python -m
video_enhancer_tpu_torch.train.evalsuite``, its data made with the port's
host ops and JPEG round trip) and the coordinator's workflow on an
``.avi``; one, likewise, starts the one-port app with its self-test up to
serving (``/ui``, ``/health``), probes it with ``validate --mode ci`` and
runs ``warm_start``, all on the CPU; one, likewise (optax and orbax
unimportable too), trains a tiny vsrm two steps, saves, restores and
exports it, and runs the dry run at one rank; one, likewise (PIL too),
runs the train CLI on its mixed bank, the face, detector and LPIPS
trainers' mains, the held-out face scenes and the WebP round trip; one,
likewise, serves vsrm on its attentive mixer, runs the Mamba-2 layers and
the deblur nets, reads an ``.avi`` through ``FramePipeline`` and logs
through the structured logging."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BAD = ("jax", "jaxlib", "cv2", "yaml", "psutil", "optax", "orbax",
       "video_enhancer_tpu")

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


EVAL = r"""
import contextlib, io, json, runpy, sys
sys.path.insert(0, sys.argv[1])
d = sys.argv[2]
for name in %r:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)       # beside the other test workers
buf = io.StringIO()
sys.argv = ["evalsuite", "cnn_upscaler", "--n-seeds", "1", "--device", "cpu"]
with contextlib.redirect_stdout(buf):
    try:
        runpy.run_module("video_enhancer_tpu_torch.train.evalsuite",
                         run_name="__main__")
    except SystemExit as e:
        rc = e.code
res = {"eval": [rc, json.loads(buf.getvalue().strip().splitlines()[-1])]}
from video_enhancer_tpu_torch.agents import CoordinatorAgent
from video_enhancer_tpu_torch.io.demo import write_demo_video
write_demo_video(d + "/in.avi", frames=6, size_hw=(24, 32))
wf = CoordinatorAgent(device="cpu").run_workflow(d + "/in.avi",
                                                 d + "/out.avi")
res["workflow"] = [wf.status, sorted(wf.results), wf.results.get("error")]
print(json.dumps(res))
""" % (BAD,)


SCAFFOLD = r"""
import contextlib, io, json, sys, urllib.request
sys.path.insert(0, sys.argv[1])
d = sys.argv[2]
for name in %r:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)       # beside the other test workers
from video_enhancer_tpu_torch import app, validate, warm_start
from video_enhancer_tpu_torch.serving import http
real_serve, started = http.serve, []

def serve_in_background(router, host, port):
    started.append(real_serve(router, host="127.0.0.1", port=0,
                              background=True))

http.serve = serve_in_background
app.main(["--self-test", "--device", "cpu", "--data-dir", d + "/app"])
url = "http://127.0.0.1:%%d" %% started[0].server_address[1]
with urllib.request.urlopen(url + "/ui", timeout=60) as r:
    res = {"ui": [r.status, r.headers["Content-Type"],
                  b"Enhance a video" in r.read()]}
with urllib.request.urlopen(url + "/health", timeout=60) as r:
    res["health"] = json.loads(r.read())["devices"]

def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()

rc, out = run(validate.main, ["--mode", "ci", "--url", url, "--device",
                              "cpu", "--data-dir", d + "/v"])
report = json.loads(out)
res["validate"] = [rc, report["status"], report["imports"]["psutil"][:7],
                   sorted(k for k, v in report["server"].items() if v["ok"])]
rc, out = run(warm_start.main, ["--device", "cpu", "--models", "bicubic",
                                "cnn_upscaler", "--size", "16"])
res["warm_start"] = [rc, out.strip().splitlines()[-1]]
started[0].shutdown()
started[0].server_close()
print(json.dumps(res))
""" % (BAD,)


TRAIN = r"""
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
import numpy as np
import torch
from video_enhancer_tpu_torch.models import vsrm
from video_enhancer_tpu_torch.parallel import dryrun
from video_enhancer_tpu_torch.parallel.mesh import local_mesh
from video_enhancer_tpu_torch.runtime.weights import try_load_params
from video_enhancer_tpu_torch.train import checkpoint, step
work = sys.argv[2]
params = vsrm.init(torch.Generator().manual_seed(0), dim=16, num_blocks=1,
                   scale=2)
init_state, train_step, shard_batch = step.make_train_step(
    lambda p, x: vsrm.apply(p, x, scale=2), step.make_optimizer(),
    local_mesh("cpu"))
g = np.random.default_rng(0)
batch = shard_batch({"lr": g.random((1, 2, 8, 8, 3), np.float32),
                     "hr": g.random((1, 2, 16, 16, 3), np.float32)})
state = init_state(params)
for _ in range(2):
    state, m = train_step(state, batch)
checkpoint.save_checkpoint(work + "/ck", state)
back = checkpoint.restore_checkpoint(work + "/ck", init_state(params))
path = checkpoint.export_params(work + "/vsrm.npz", back)
loaded = try_load_params(path, vsrm.init(torch.Generator().manual_seed(1),
                                         dim=16, num_blocks=1, scale=2))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = dryrun.main(["--ranks", "1", "--device", "cpu"])
print(json.dumps({
    "step": int(back.step), "loss": bool(torch.isfinite(m["loss"])),
    "export": torch.equal(loaded["head"]["w"], state.params["head"]["w"]),
    "dryrun": [rc, sum(l.startswith("dryrun ok") for l in
                       out.getvalue().splitlines())]}))
""" % (BAD,)


TRAIN_CLI = r"""
import contextlib, io, json, os, sys
sys.path.insert(0, sys.argv[1])
for name in %r + ("PIL",):
    sys.modules[name] = None
import numpy as np
from video_enhancer_tpu_torch.io.webp import webp_roundtrip
from video_enhancer_tpu_torch.train import cli, face_detector, faces, lpips
weights = os.path.join(sys.argv[1], "video_enhancer_tpu", "weights")
before = {f: os.path.getmtime(os.path.join(weights, f))
          for f in os.listdir(weights)}
os.chdir(sys.argv[2])
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = [cli.main(["--model", "cnn_upscaler", "--dim", "8", "--steps", "2",
                    "--batch", "2", "--clip-len", "2", "--crop", "32",
                    "--log-every", "1", "--export", "w.npz", "--device",
                    "cpu"]),
          faces.main(["--steps", "1", "--device", "cpu"]),
          face_detector.main(["--steps", "1", "--device", "cpu",
                              "--eval-n", "2"]),
          lpips.main(["--steps", "1", "--device", "cpu"])]
imgs, boxes = face_detector.make_alt_face_scenes(2, seed=1)
logs = [json.loads(l) for l in out.getvalue().splitlines()
        if l.startswith('{"step"')]
print(json.dumps({
    "rc": rc, "steps": [l["step"] for l in logs],
    "files": sorted(f for f in os.listdir(".") if f.endswith(".npz")),
    "webp": list(webp_roundtrip(np.zeros((16, 16, 3), np.uint8),
                                50).shape),
    "alt": [list(imgs.shape), len(boxes)],
    "bundled_untouched": before == {f: os.path.getmtime(
        os.path.join(weights, f)) for f in os.listdir(weights)}}))
""" % (BAD,)


LAST = r"""
import io, json, logging, os, sys
sys.path.insert(0, sys.argv[1])
for name in %r:
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)     # the bf16 window on the CPU, beside other workers
os.environ["VETPU_PREFERRED_BACKBONE"] = "mambairv2"
from video_enhancer_tpu_torch.io.pipeline import FramePipeline
from video_enhancer_tpu_torch.io.video import write_video
from video_enhancer_tpu_torch.models import deblur
from video_enhancer_tpu_torch.nn.ssm import bimamba2_apply, bimamba2_init
from video_enhancer_tpu_torch.runtime.registry import build_handler
from video_enhancer_tpu_torch.utils.logging_config import (
    PerformanceLogger, RequestContext, setup_logging)
res = {}
h = build_handler("vsrm", device="cpu")
frames = list(np.random.default_rng(0).integers(0, 256, (7, 16, 16, 3),
                                                dtype=np.uint8))
res["vsrm"] = ["qkv" in h.params["blocks"][0]["spatial_ssm"],
               len(list(h.enhance_frames(iter(frames))))]
g = torch.Generator().manual_seed(0)
x = torch.rand((1, 40, 16), generator=g)
res["bimamba2"] = list(bimamba2_apply(bimamba2_init(g, 16, head_dim=16),
                                      x, chunk=16).shape)
clip = torch.rand((1, 8, 8, 3), generator=g)
res["deblur"] = [bool(torch.equal(getattr(deblur, n + "_apply")(
    getattr(deblur, n + "_init")(g, dim=4), clip), clip))
    for n in ("bsstnet", "vddiff")]
path = os.path.join(sys.argv[2], "clip.avi")
write_video(path, np.stack(frames[:5]))
res["pipeline"] = [(i["start"], i["valid"], i["frames"].dtype == torch.float32)
                   for i in FramePipeline(path, window=4, device="cpu")]
buf = io.StringIO()
setup_logging(log_dir=os.path.join(sys.argv[2], "logs"))
logging.getLogger().handlers[-3].stream = buf
PerformanceLogger().model_load("vsrm", 1.0)
with RequestContext("r1"):
    logging.getLogger().info("in a request")
res["log"] = [json.loads(line).get("ctx")
              for line in buf.getvalue().splitlines()[-2:]]
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
                 "serving.server", "ops.cvhost", "io.jpeg", "train.data",
                 "train.evalgen", "train.evalsuite", "train.lpips",
                 "agents.quality", "agents.analyzer", "agents.coordinator",
                 "agents.communication", "ops.ring",
                 "parallel.model_parallel", "models.seedvr2_sizes", "app",
                 "warm_start", "validate", "config.yaml_subset",
                 "config.production", "serving.ui", "utils.flops",
                 "utils.timing", "utils.debug", "utils.recovery",
                 "utils.protection", "ops.vjp", "train.losses",
                 "train.step", "train.checkpoint", "parallel.dryrun",
                 "train.cli", "train.faces", "train.face_detector",
                 "io.webp", "models.deblur", "io.pipeline", "nn.ssm",
                 "utils.logging_config"):
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


def test_eval_cli_and_coordinator_run_without_jax_or_cv2(tmp_path):
    """The eval CLI measures cnn_upscaler's bundled weights (the ``ind``
    data: the port's demo frames, host ops and JPEG round trip), and the
    coordinator's workflow (analysis, enhancement, quality assessment with
    the LPIPS proxy) completes on an ``.avi``, with those packages
    absent."""
    res = _run(EVAL, tmp_path)
    assert (tmp_path / "out.avi").is_file()
    rc, out = res["eval"]
    assert rc == 0 and out["model"] == "cnn_upscaler"
    assert out["family"] == "ind" and isinstance(out["gain_db"], float)
    assert res["workflow"] == ["completed", ["analysis", "enhancement",
                                             "quality", "summary"], None]


def test_app_validate_and_warm_start_run_without_jax_cv2_yaml_or_psutil(
        tmp_path):
    """The one-port app (self-test, then serving the UI and the API), the
    validation of that running app and warm start, on the CPU, with those
    packages absent: psutil reported missing and not failed."""
    res = _run(SCAFFOLD, tmp_path)
    assert res == {
        "ui": [200, "text/html", True], "health": ["cpu"],
        "validate": [0, "pass", "missing", ["/api/v1/strategies", "/health",
                                            "/metrics", "/performance/stats"]],
        "warm_start": [0, "warm start: 2/2 models ready"]}


def test_training_runs_without_jax_cv2_yaml_psutil_or_optax(tmp_path):
    """Two train steps of a tiny vsrm, a checkpoint round trip, the npz
    export read back by the port's loader, and the dry run at one gloo
    rank, on the CPU, with those packages (and optax and orbax, which the
    JAX package's training uses) absent."""
    res = _run(TRAIN, tmp_path)
    assert res == {"step": 2, "loss": True, "export": True,
                   "dryrun": [0, 9]}


def test_train_cli_and_trainers_run_without_jax_cv2_pil_yaml_or_optax(
        tmp_path):
    """The train CLI on the mixed bank (make_train_frames, the WebP chain
    family), the three small trainers' mains (their exports in the working
    directory, none under video_enhancer_tpu/weights/), the held-out face
    scenes and the WebP round trip, with those packages unimportable."""
    res = _run(TRAIN_CLI, tmp_path)
    assert res == {"rc": [0, 0, 0, 0], "steps": [1, 2],
                   "files": ["face_detector.npz", "face_restorer.npz",
                             "lpips_proxy.npz", "w.npz"],
                   "webp": [16, 16, 3], "alt": [[2, 128, 128, 3], 2],
                   "bundled_untouched": True}


def test_last_modules_run_without_jax_cv2_or_yaml(tmp_path):
    """vsrm served on its attentive mixer (the variable), ``bimamba2``, the
    deblur nets (untrained: identity), ``FramePipeline`` over an ``.avi``
    and the structured logging with a request id, with those packages
    unimportable."""
    res = _run(LAST, tmp_path)
    assert res == {"vsrm": [True, 7], "bimamba2": [1, 40, 16],
                   "deblur": [True, True],
                   "pipeline": [[0, 4, True], [4, 1, True]],
                   "log": [{"model": "vsrm", "seconds": 1.0,
                            "source": "init"}, {"request_id": "r1"}]}
