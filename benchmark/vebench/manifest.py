"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, metric, kernel
count or reference sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json`` (named by the configuration's ``file``),
- ``traffic/<mix>.json``,
- ``metrics/<metric>.py``: ``read(run) -> float | None``,
- ``counts/<kernel>.py``: ``NAMES``, ``RATE``, ``flops(shape)``,
  ``bytes(shape)``,
- ``reference/<config>.py``: ``load(config, device)``, ``forward(params,
  clip, ops, context)``.

A later change adds a cell, a mix or a metric by adding such files and
entries, without editing any file here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str) -> dict:
    """The configuration's file, with its ``name``; its ``checkpoint`` made
    a path under the checkout's root."""
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                cfg = json.load(f)
            cfg["name"] = name
            cfg["checkpoint"] = str(ROOT / cfg["checkpoint"])
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def metrics_of(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on; a metric without
    ``workloads`` belongs to every cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def reader(metric: str):
    return _module(BENCH / "metrics" / f"{metric}.py",
                   f"vebench_metric_{_safe(metric)}").read


def all_counts() -> dict:
    """Every kernel's counts, by the name of its file."""
    return {p.stem: _module(p, f"vebench_counts_{_safe(p.stem)}")
            for p in sorted((BENCH / "counts").glob("*.py"))}


def reference(config_name: str):
    """The configuration's plain reference, with ``reference/`` on the
    path for its shared ``plain`` module."""
    ref_dir = str(BENCH / "reference")
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    return _module(BENCH / "reference" / f"{config_name}.py",
                   f"vebench_reference_{_safe(config_name)}")
