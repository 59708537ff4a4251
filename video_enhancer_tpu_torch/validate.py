"""Deployment + model validation of the port.

Counterpart of video_enhancer_tpu/validate.py, with its report keys, modes
(``full``, ``ci``, ``rollback``), ``--url`` probes and exit codes. What it
checks is the port's own:

- ``imports``: torch and numpy, which the port needs, and psutil, which it
  uses where it is installed (the CPU's share in ``/metrics``, the host's
  memory): its absence is reported, not failed. No jax, cv2, yaml, optax
  or orbax: the port imports none of them;
- ``device``: the ``torch.cuda`` devices, the card's name and memory; a
  run on the card where there is none fails;
- ``models``: each policy model's ``enabled`` and whether the port serves
  it (``probe_available``);
- ``model_structures`` (``full``): the five backbones at the JAX module's
  tiny widths, seeded, through the port's modules on the resolved device
  (fp32; on the card the kernels' fp32 forms);
- ``filesystem``, ``server`` (``--url``) and ``rollback`` as in the JAX
  package, the rollback on the port's job store.

Run: ``python -m video_enhancer_tpu_torch.validate [--url http://host:port]
[--mode ci] [--report out.json] [--device cpu]`` (the card unless
``--device cpu``, ``--platform cpu`` or ``$VETPU_PLATFORM=cpu``).
"""

from __future__ import annotations

import argparse
import json
import time

__all__ = ["validate_imports", "validate_models", "validate_device",
           "validate_model_structures", "tiny_models", "tiny_forward",
           "TINY_CLIP", "validate_server", "validate_filesystem",
           "run_rollback", "main"]

REQUIRED_IMPORTS = ("torch", "numpy")
OPTIONAL_IMPORTS = ("psutil",)
# the clip of the tiny forwards: (B, T, H, W, 3), zeros
TINY_CLIP = (1, 2, 16, 16, 3)


def validate_imports() -> dict:
    checks = {}
    for mod in REQUIRED_IMPORTS + OPTIONAL_IMPORTS:
        try:
            __import__(mod)
            checks[mod] = "ok"
        except ImportError as e:
            checks[mod] = (f"missing (optional): {e}"
                           if mod in OPTIONAL_IMPORTS else f"missing: {e}")
    return checks


def validate_models() -> dict:
    from .config import default_policy
    from .runtime.registry import probe_available

    policy = default_policy()
    avail = probe_available(policy)
    return {
        name: {"enabled": policy.models[name].enabled,
               "importable": name in avail}
        for name in policy.models
    }


def tiny_models() -> dict:
    """name -> (init(gen), apply(params, clip)) at the JAX module's widths
    (validate.py:66-113 there)."""
    from .models import ditvr, fast_mamba_vsr, rvrt, seedvr2, vsrm

    return {
        "fast_mamba_vsr": (
            lambda g: fast_mamba_vsr.init(g, dim=8, num_layers=1),
            lambda p, x: fast_mamba_vsr.apply(p, x, scale=4)),
        "vsrm": (
            lambda g: vsrm.init(g, dim=8, num_blocks=1),
            lambda p, x: vsrm.apply(p, x, scale=4, heads=2)),
        "ditvr": (
            lambda g: ditvr.init(g, dim=32, depth=1),
            lambda p, x: ditvr.apply(p, x)),
        "seedvr2": (
            lambda g: seedvr2.init(g, base_channels=8, channel_mult=(1, 2)),
            lambda p, x: seedvr2.apply(p, x)),
        "rvrt": (
            lambda g: rvrt.init(g, dim=8, depth=1, heads=2, window=(2, 4, 4),
                                scale=2),
            lambda p, x: rvrt.apply(p, x, scale=2, heads=2,
                                    window=(2, 4, 4))),
    }


def tiny_forward(name: str, device):
    """One tiny backbone's output on ``device``: seeded parameters (fp32)
    applied to the zero ``TINY_CLIP``, as the JAX module runs them."""
    import torch

    from .runtime.vsr_handler import cast_params

    init, apply = tiny_models()[name]
    params = cast_params(init(torch.Generator().manual_seed(0)),
                         torch.float32, device)
    with torch.inference_mode():
        return apply(params, torch.zeros(TINY_CLIP, device=device))


def validate_model_structures(device=None) -> dict:
    """Tiny-shape forward of every backbone (reference validate_models.py
    structure checks), on the resolved device."""
    import torch

    from .device import resolve_device

    out = {}
    for name in tiny_models():
        t0 = time.time()
        try:
            dev = resolve_device(device)
            y = tiny_forward(name, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if not bool(torch.isfinite(y).all()):
                raise ValueError("output not finite")
            out[name] = {"ok": True, "out_shape": list(y.shape),
                         "sec": round(time.time() - t0, 2)}
        except Exception as e:     # report each model, go on to the next
            out[name] = {"ok": False, "error": str(e)}
    return out


def validate_device(device=None) -> dict:
    """The resolved device and the ``torch.cuda`` devices (name, memory);
    an ``error`` entry where the device cannot be had."""
    import torch

    from .device import resolve_device
    from .utils.memory import DeviceMemoryManager

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        return {"error": str(e)}
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"backend": dev.type, "device": str(dev),
            "devices": [torch.cuda.get_device_name(i) for i in range(count)]
            or ["cpu"],
            "memory": DeviceMemoryManager.get_info()}


def validate_server(url: str) -> dict:
    import urllib.request

    checks = {}
    for path in ("/health", "/metrics", "/api/v1/strategies",
                 "/performance/stats"):
        try:
            with urllib.request.urlopen(url + path, timeout=10) as resp:
                checks[path] = {"status": resp.status,
                                "ok": resp.status == 200}
        except Exception as e:
            checks[path] = {"ok": False, "error": str(e)}
    return checks


def validate_filesystem(data_dir: str = "data") -> dict:
    import shutil
    from pathlib import Path

    p = Path(data_dir)
    try:
        p.mkdir(parents=True, exist_ok=True)
        test = p / ".write_test"
        test.write_text("x")
        test.unlink()
        free = shutil.disk_usage(p).free
        return {"writable": True, "free_gb": round(free / 1024**3, 1)}
    except OSError as e:
        return {"writable": False, "error": str(e)}


def run_rollback(data_dir: str = "data", git_reset: bool = False) -> dict:
    """Reset a deployment to a known-good state (reference
    validate_deployment.py:637-707 run_rollback), as the JAX package does:
    in-flight jobs are cancelled through the job store (the workers observe
    the status flip and stop), temp/upload scratch is cleared, and the git
    tracked-file reset, which is destructive, runs only with
    ``git_reset``."""
    import shutil
    import subprocess
    from pathlib import Path

    steps: dict = {}
    try:
        from .runtime.jobstore import JobStatus, JobStore

        store = JobStore(Path(data_dir) / "jobs.sqlite")
        n = 0
        for st in (JobStatus.QUEUED, JobStatus.ANALYZING,
                   JobStatus.PROCESSING):
            for job in store.list(status=st, limit=10000):
                store.update(job["job_id"], status=JobStatus.CANCELLED,
                             error="cancelled by rollback")
                n += 1
        steps["cancel_jobs"] = {"ok": True, "cancelled": n}
    except Exception as e:
        steps["cancel_jobs"] = {"ok": False, "error": str(e)}

    cleaned = []
    for sub in ("tmp", "temp", "uploads"):
        d = Path(data_dir) / sub
        try:
            if d.exists():
                shutil.rmtree(d)
                cleaned.append(str(d))
            d.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            steps.setdefault("clean_errors", []).append(f"{d}: {e}")
    steps["clean_temp"] = {"ok": "clean_errors" not in steps,
                           "cleaned": cleaned}

    if git_reset:
        try:
            r = subprocess.run(["git", "checkout", "--", "."],
                               capture_output=True, text=True, timeout=60)
            steps["git_reset"] = {"ok": r.returncode == 0,
                                  "stderr": r.stderr[-300:]}
        except (OSError, subprocess.SubprocessError) as e:
            steps["git_reset"] = {"ok": False, "error": str(e)}
    else:
        steps["git_reset"] = {"ok": True, "skipped": "pass --git-reset"}
    steps["ok"] = all(v.get("ok") for v in steps.values()
                      if isinstance(v, dict))
    return steps


def _write(report_path: str | None, out: str) -> None:
    if report_path:
        from pathlib import Path

        Path(report_path).write_text(out)
    print(out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="video_enhancer_tpu_torch.validate")
    p.add_argument("--url", default=None,
                   help="probe a live server at this base URL")
    p.add_argument("--mode", default="full",
                   choices=["full", "ci", "rollback"])
    p.add_argument("--report", default=None)
    p.add_argument("--platform", default=None,
                   help="cpu or gpu (as $VETPU_PLATFORM)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--git-reset", action="store_true",
                   help="rollback only: also git-checkout tracked files")
    args = p.parse_args(argv)

    if args.mode == "rollback":
        steps = run_rollback(args.data_dir, git_reset=args.git_reset)
        _write(args.report, json.dumps({"rollback": steps}, indent=2,
                                       default=str))
        return 0 if steps["ok"] else 1

    from .device import platform_device

    device = args.device or (platform_device(args.platform)
                             if args.platform else None)
    report = {
        "timestamp": time.time(),
        "imports": validate_imports(),
        "models": validate_models(),
        "device": validate_device(device),
        "filesystem": validate_filesystem(args.data_dir),
    }
    if args.mode == "full":
        report["model_structures"] = validate_model_structures(device)
    if args.url:
        report["server"] = validate_server(args.url)

    failures = []
    for mod, status in report["imports"].items():
        if status != "ok" and mod in REQUIRED_IMPORTS:
            failures.append(f"import {mod}: {status}")
    if "error" in report["device"]:
        failures.append(f"device: {report['device']['error']}")
    for name, rec in report.get("model_structures", {}).items():
        if not rec["ok"]:
            failures.append(f"model {name}: {rec['error']}")
    if not report["filesystem"].get("writable"):
        failures.append("filesystem not writable")
    for path, rec in report.get("server", {}).items():
        if not rec.get("ok"):
            failures.append(f"server {path}")

    report["failures"] = failures
    report["status"] = "pass" if not failures else "fail"
    _write(args.report, json.dumps(report, indent=2, default=str))
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
