"""The port and chip_smoke.py import nothing of JAX, OpenCV or the JAX
package: the card's machine has none of them. Checked in a fresh
interpreter, which imports every module of the port and chip_smoke.py."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import video_enhancer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cv2", "video_enhancer_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_cv2_or_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "video_enhancer_tpu_torch.runtime.vsr_handler" in res["modules"]
    assert "video_enhancer_tpu_torch.io.video" in res["modules"]
    assert res["bad"] == []
