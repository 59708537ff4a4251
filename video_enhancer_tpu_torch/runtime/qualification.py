"""Measured-gain qualification: no model whose bundled weights measure a
non-positive gain is auto-routed.

Counterpart of video_enhancer_tpu/runtime/qualification.py. The report is
the JAX package's ``weights/QUALIFICATION.json``, read as a data file
(``VETPU_QUALIFICATION`` overrides its path); it records each bundled
model's mean PSNR gain in dB over its non-ML fallback (``ind``: the
training family held out by seed). A model measured at ``ind <= 0`` is
disqualified; a model absent from the report is not, and a missing or
unreadable report disqualifies nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

__all__ = ["report_path", "load_report", "disqualified_models"]

_DEFAULT_PATH = (Path(__file__).resolve().parents[2] / "video_enhancer_tpu"
                 / "weights" / "QUALIFICATION.json")


def report_path() -> Path:
    override = os.environ.get("VETPU_QUALIFICATION")
    return Path(override) if override else _DEFAULT_PATH


def load_report() -> dict[str, Any]:
    """The report's per-model entries, or {} when absent or unreadable."""
    try:
        with open(report_path()) as f:
            data = json.load(f)
        models = data.get("models", data)
        return models if isinstance(models, dict) else {}
    except (OSError, ValueError):
        return {}


def disqualified_models() -> set[str]:
    """Models whose measured in-distribution mean gain is <= 0 dB."""
    out = set()
    for name, entry in load_report().items():
        if not isinstance(entry, dict):
            continue
        ind = entry.get("ind")
        if isinstance(ind, (int, float)) and ind <= 0.0:
            out.add(name)
    return out
