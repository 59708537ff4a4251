"""The port, chip_smoke.py and scripts/torch_ab_harness.py import nothing of
JAX, OpenCV, PyYAML or the JAX package: the card's machine has none of them
(OpenCV only inside the port's file-IO functions). Checked in fresh
interpreters: one imports every module of the port, chip_smoke.py and the
A/B script; one, where those packages cannot be
imported at all, drives the auto route on frames in memory, its temporal
stage included; one, likewise,
drives rvrt (an explicit engine and the fallback manager) and the
strict-latency route to fast_mamba_vsr; one, likewise, drives the route to
seedvr2 with its quality gate."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BAD = ("jax", "jaxlib", "cv2", "yaml", "video_enhancer_tpu")

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


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
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
                 "ops.warp", "ops.conv", "ops.color", "ops.optflow"):
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
