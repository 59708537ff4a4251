"""``correct`` comes out false when the timed path is broken underneath:
the model returning its input unchanged, half of each model call's batch
left out with the mean of the rest in its place, an output frame altered
where it is produced; and when the reference held in float8 takes the
program's place (the control), or only its learned products' operands in
float8 (the second control). The benchmark's check of the card is
skipped: the tiny cells run on the CPU (conftest.py)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import run_cell

BREAK = {
    # the model step returns its input (upscaled by repetition for x4)
    "unchanged": "out = (x if x.shape[-2] * scale == x.shape[-2] else "
                 "x.repeat_interleave(scale, -3).repeat_interleave(scale, "
                 "-2))",
    # half of the batch (of tiles, or of the window's frames for one tile)
    # left out, the mean of the rest in its place
    "half_batch": "out = orig(p, x, **kw)\n"
                  "    ax = 0 if out.shape[0] > 1 else 1\n"
                  "    half = out.shape[ax] // 2\n"
                  "    keep = out.narrow(ax, 0, half)\n"
                  "    out = torch.cat([keep, keep.mean(ax, keepdim=True)"
                  ".expand_as(out.narrow(ax, half, out.shape[ax] - half))],"
                  " ax)",
    # one output frame of each call altered by 8 levels
    "altered": "out = orig(p, x, **kw).clone()\n"
               "    out[:, out.shape[1] // 2] += 8 / 255",
}
MODELS = {"vsrm-x4.batch-270p": ("vsrm", 4),
          "ditvr-restore.batch-720p": ("ditvr", 1)}
# the cells whose tiny copy shows the second control (only the learned
# products' operands in float8): ditvr's tiles of 32 pixels read 0 to
# 5.4e-5 pixels off by 4 or more there, against 1.2e-7 to 2.3e-3 at the
# cells' own sizes on the card
PRODUCTS_SHOWN = {"vsrm-x4.batch-270p"}


def _prelude(workload, fault):
    module, scale = MODELS[workload]
    return (f"import torch\n"
            f"from video_enhancer_tpu_torch.models import {module} as m\n"
            f"orig, scale = m.apply, {scale}\n"
            f"def broken(p, x, **kw):\n    {BREAK[fault]}\n"
            f"    return out.to(x.dtype)\n"
            f"m.apply = broken\n")


@pytest.mark.parametrize("workload", sorted(MODELS))
def test_sound_run_is_correct(tiny_root, workload):
    out = run_cell(tiny_root, workload)
    assert out["correct"] is True and out["failed"] == 0
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("fault", sorted(BREAK))
@pytest.mark.parametrize("workload", sorted(MODELS))
def test_broken_run_is_not_correct(tiny_root, workload, fault):
    out = run_cell(tiny_root, workload, prelude=_prelude(workload, fault))
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("workload", sorted(MODELS))
def test_control_fails_and_program_passes(tiny_root, workload):
    code = (f"import sys\nsys.path.insert(0, "
            f"{str(tiny_root / 'benchmark')!r})\nimport control\n"
            f"control.main(['--workload', {workload!r}, '--seeds', "
            f"'11,12,13', '--seconds', '3', '--control', '3', '--modes', "
            f"'fp8,fp8_products'], "
            f"device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    cfg = json.loads((tiny_root / "benchmark" / "configs" / (
        workload.split(".")[0] + ".json")).read_text())
    for line in lines:
        assert line["program"]["windows"] > 0
        assert all(line["program"][k] <= v
                   for k, v in cfg["limits"].items())
        assert any(line["control"][k] > v
                   for k, v in cfg["limits"].items())
        if workload in PRODUCTS_SHOWN:
            assert any(line["fp8_products"][k] > v
                       for k, v in cfg["limits"].items())
