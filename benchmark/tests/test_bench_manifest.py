"""The manifest and the files it names, and adding a cell, a traffic mix
and a metric as new files only."""

from __future__ import annotations

import json
import re

from conftest import BENCH, run_cell

from vebench import check, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_every_file_it_needs():
    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    names = [c["name"] for c in m["configs"]] + [
        w["name"] for w in m["workloads"]] + [
        x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in m["configs"]:
        cfg = manifest.config(m, c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
        assert set(cfg["limits"]) <= set(check.NUMBERS)
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = manifest.traffic(w["traffic"])
        assert mix["loop"] in ("closed", "open")
        e2e = [x["name"] for x in manifest.metrics_of(m, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(m, w["name"], True)
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert callable(manifest.reader(x["name"]))
    moves = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in moves
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
            assert x["name"][:-len("_roofline")] in manifest.all_counts()
    bounds = {x["name"]: x["bound"] for x in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_a_cell_traffic_and_metric_added_as_files_only(tmp_path):
    """A throwaway cell of vsrm-x4 under a new traffic mix, reporting a new
    per-layer metric, runs from a copy in which only files were added and
    entries appended to the manifest."""
    from conftest import make_tiny

    root = make_tiny(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    (root / "benchmark" / "traffic" / "throwaway.json").write_text(json.dumps(
        {"height": 16, "width": 24, "clip_frames": 10, "pool_clips": 1,
         "loop": "closed", "check_windows": 2}))
    (root / "benchmark" / "metrics" / "calls_per_frame.throwaway.py"
     ).write_text('"""Model calls a delivered frame."""\n\n\ndef read(run):\n'
                  '    return run.calls / max(run.delivery.frames, 1)\n')
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "vsrm-x4.throwaway", "config": "vsrm-x4",
                           "traffic": "throwaway", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "calls_per_frame.throwaway", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "handler", "moves": "frames_per_s",
                           "workloads": ["vsrm-x4.throwaway"]})
    m["end_to_end"][0]["workloads"].append("vsrm-x4.throwaway")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data
    out = run_cell(root, "vsrm-x4.throwaway", seconds=2.0, trace=1)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"calls_per_frame.throwaway"}
    assert 0 < out["metrics"]["calls_per_frame.throwaway"]["value"] < 1
    out = run_cell(root, "vsrm-x4.throwaway", seconds=2.0, trace=0)
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
