"""Fixtures of the benchmark's own tests (CPU; run with
``python -m pytest benchmark/tests``).

``tiny_root`` is a temporary copy of the benchmark beside links to the
port and its bundled weights, with every traffic mix cut to a few small
frames and ditvr's tile to 32 pixels, so that a whole run of each cell,
tiles and padded tails included, takes seconds on the CPU. ``run_cell``
runs one cell of such a copy in a fresh interpreter through
``run.main(..., device="cpu")``, after ``prelude`` (code that may break
the program underneath), and returns the result's JSON line (or, where
the run is to fail with exit code ``rc``, the finished process).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT), str(BENCH), str(BENCH / "reference")]

TINY = {"batch-270p": dict(height=24, width=32, clip_frames=12, pool_clips=2,
                           check_windows=3),
        "stream-180p": dict(height=24, width=32, clip_frames=12,
                            pool_clips=2, rate_fps=8.0, check_windows=3),
        "batch-720p": dict(height=48, width=64, clip_frames=16, pool_clips=2,
                           check_windows=2),
        "stream-720p": dict(height=48, width=64, clip_frames=16,
                            pool_clips=2, rate_fps=4.0, check_windows=2)}


def make_tiny(dest: Path) -> Path:
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    (dest / "video_enhancer_tpu_torch").symlink_to(
        ROOT / "video_enhancer_tpu_torch")
    (dest / "video_enhancer_tpu").mkdir()
    (dest / "video_enhancer_tpu" / "weights").symlink_to(
        ROOT / "video_enhancer_tpu" / "weights")
    for name, upd in TINY.items():
        p = dest / "benchmark" / "traffic" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix.update(upd)
        p.write_text(json.dumps(mix))
    p = dest / "benchmark" / "configs" / "ditvr-restore.json"
    cfg = json.loads(p.read_text())
    cfg.update(tile=32, tile_overlap=8)
    p.write_text(json.dumps(cfg))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, workload: str, seed: int = 2147483999,
             seconds: float = 5.0, trace: int = 0, prelude: str = "",
             rc: int = 0):
    code = (f"import sys\nsys.path.insert(0, {str(root / 'benchmark')!r})\n"
            f"{prelude}\nimport run\n"
            f"rc = run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device='cpu')\nsys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == rc, proc.stderr[-4000:]
    if rc:
        return proc
    return json.loads(proc.stdout.strip().splitlines()[-1])
